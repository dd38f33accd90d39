"""The control on the card: the reference computed one precision below
the configuration's, put in the program's place, fails the cell's limits
while the program passes them (float32 cells: TF32 on in PyTorch's
matmuls and cuDNN; the bfloat16 training cell: float8 weights and
inputs).  Each cell at its own size, one seed and a short window; the
readings the limits were set from are in PERF.md (``python3 -m
portbench.readings``)."""

import time

import pytest

from portbench import run, spec
from portbench.reference import check

pytestmark = pytest.mark.card

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(card, name):
    cell = spec.Cell(name)
    seed = 2 ** 31 + 99
    seconds = 0.0 if cell.traffic["driver"] == "train" else 20.0
    _, samples, inference = run.sample(cell, seed, seconds, card, time.perf_counter())
    numbers = check.numbers(cell.traffic["driver"])
    program = numbers(cell.config, seed, inference, samples, card, control=False)
    control = numbers(cell.config, seed, inference, samples, card, control=True)
    assert check.compare(program, cell.limits())[0], program
    assert not check.compare(control, cell.limits())[0], control
