"""The port's profiling hooks: ``trace`` writes a Chrome / Perfetto trace of
the enclosed block that names an ``annotate`` scope (on the CPU here; the
card's kernels are traced by chip_smoke.py [19]), and ``StepTimer``'s
rolling window equals the JAX package's on the same injected clock."""

import json
import os

import pytest
import torch

from cosy_tpu.utils import profiling as JPROF
from cosy_tpu_torch.utils import profiling as PROF
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)


def test_trace_names_the_annotated_scope(tmp_path):
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with PROF.trace(str(tmp_path / "tr"), device="cpu") as path:
        with PROF.annotate("cosy_stage_flow"):
            y = x @ x
    assert path == os.path.join(str(tmp_path / "tr"), PROF.TRACE_FILE)
    assert os.path.getsize(path) > 0 and torch.isfinite(y).all()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "cosy_stage_flow" in names
    assert any("mm" in str(n) for n in names)


def test_trace_on_the_default_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with PROF.trace(str(tmp_path / "tr")):
            pass


@pytest.mark.parametrize("window", [3, 50])
def test_step_timer_equals_jax(monkeypatch, window):
    ticks = [0.0, 0.5, 1.0, 1.25, 2.0, 4.0, 4.5, 4.75, 10.0, 10.125]

    def clock():
        it = iter(ticks)
        return lambda: next(it)

    timers = []
    for mod, cls in ((JPROF, JPROF.StepTimer), (PROF, PROF.StepTimer)):
        monkeypatch.setattr(mod.time, "perf_counter", clock())
        timer = cls(window=window)
        dts = []
        for _ in range(len(ticks) // 2):
            timer.start()
            dts.append(timer.stop())
        timers.append((dts, list(timer.times), timer.mean))
    assert timers[0] == timers[1]
    assert len(timers[1][1]) == min(window, len(ticks) // 2)
    assert PROF.StepTimer().mean == 0.0
