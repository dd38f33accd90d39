"""The training cell at toy widths on the CPU: the frozen reference follows
the program's first steps draw for draw (in float32 the two agree to
rounding), and each fault a training step can have turns ``correct``
false against the cell's own limits: a step that leaves the state as it
was, and half of each micro-batch left out with the mean over the rest."""

import time

import pytest
import torch

from portbench import run, spec
from portbench.reference import check
from portbench.reference.frozen import config as FC
from portbench.tests import tiny

DEV = torch.device("cpu")
SEED = 2 ** 31 + 17


def _config(bf16: bool):
    cfg = tiny.config_300m()
    cfg["train"] = spec.as_json(FC.TrainConfig(batch_size=2, bf16=bf16))
    return cfg


def _numbers(cfg, control=False):
    cell = tiny.cell(cfg, "lora-step", **tiny.TRAIN)
    _, samples, inference = run.sample(cell, SEED, 0.0, DEV, time.perf_counter())
    return check.numbers("train")(cfg, SEED, inference, samples, DEV, control=control)


def test_the_reference_follows_the_float32_program_draw_for_draw():
    numbers = _numbers(_config(bf16=False))
    assert set(spec.Cell("cv300m.lora-step").limits()) <= set(numbers)
    assert max(numbers.values()) < 1e-5, numbers


def test_the_bfloat16_program_passes_and_the_float8_control_reads_wider():
    program = _numbers(_config(bf16=True))
    control = _numbers(_config(bf16=True), control=True)
    assert program["grad_norm_gap"] < control["grad_norm_gap"]


def _state_unchanged(monkeypatch):
    from cosy_tpu_torch.train import trainer as T

    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    orig = T.JointTrainer.step

    def step(self, state, *a, **k):
        out = orig(self, state, *a, **k)
        for v in state.leaves():
            st = state.optimizer.state.setdefault(v, {})
            st["exp_avg"] = torch.zeros_like(v)
        return out

    monkeypatch.setattr(T.JointTrainer, "step", step)


def _half_batch(monkeypatch):
    from cosy_tpu_torch.train import trainer as T
    from portbench import readings

    monkeypatch.setattr(T.JointTrainer, "_micro", T.JointTrainer._micro)
    readings.half_batch()


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_fault_under_the_timed_step_fails_the_check(monkeypatch, fault):
    fault(monkeypatch)
    numbers = _numbers(_config(bf16=True))
    ok, compared = check.compare(numbers, spec.Cell("cv300m.lora-step").limits())
    assert not ok, compared
