"""The reference against the port's CPU path at the toy configurations,
through the harness's own drivers and checks: each entry the cells drive
agrees, and each fault a serving cell can have turns ``correct`` false.

The faults are planted under the timed path (a token altered where the
decode samples it, a wav altered where HiFT makes it) and the run goes on
as the harness runs it, with the cells' own limits."""

import importlib
import time

import numpy as np
import pytest
import torch

from portbench import run, spec, system
from portbench.reference import check
from portbench.tests import tiny
from portbench.trace import Tracer

DEV = torch.device("cpu")
SEED = 2 ** 31 + 4321


def _run(cell, seconds=3.0, seed=SEED):
    rec, samples, inference = run.sample(cell, seed, seconds, DEV, time.perf_counter())
    numbers = check.numbers(cell.traffic["driver"])(
        cell.config, seed, inference, samples, DEV, control=False)
    return rec, samples, numbers


CELLS = {
    "cv300m.stream16": lambda: tiny.cell(tiny.config_300m(), "stream16", **tiny.ENGINE),
    "cv2-0.5b.stream8": lambda: tiny.cell(tiny.config_cv2(), "stream8", **tiny.ENGINE),
    "cv300m.vc-long": lambda: tiny.cell(tiny.config_300m(), "vc-long", **tiny.TOKEN2WAV),
}


def _limits(name):
    return spec.Cell(name).limits()


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_reference_agrees_with_the_port(name):
    rec, samples, numbers = _run(CELLS[name]())
    assert rec.audio_s > 0 and rec.failed == 0 and samples
    assert set(numbers) == set(_limits(name))
    # the port's fused chain against the frozen unfused blocks: f32 rounding only
    assert numbers["wav_rel_err"] < 1e-5
    assert numbers.get("token_cdf_miss", 0.0) < 1e-9
    assert check.compare(numbers, _limits(name))[0]


def _altered_tokens(monkeypatch):
    import cosy_tpu_torch.ops.sampling as S

    orig, calls = S.ras_sample_batch, [0]

    def altered(logits, *a, **k):
        tok = orig(logits, *a, **k)
        calls[0] += 1
        if calls[0] % 5 == 0:  # one step in five: row 0's token moves to its neighbour
            tok = tok.clone()
            tok[0] = (tok[0] + 1) % (logits.shape[1] - 3)
        return tok

    monkeypatch.setattr(S, "ras_sample_batch", altered)


def _always_full(monkeypatch):
    """Every step samples the whole distribution with the second uniform,
    as if each nucleus draw repeated."""
    import cosy_tpu_torch.ops.sampling as S

    orig = S.ras_sample_batch

    def full(logits, history, counts, uniforms, steps, min_lens, eos, top_p, top_k, win_size,
             tau_r, fill_ids=False):
        return orig(logits, history, counts, uniforms, steps, min_lens, eos, top_p, top_k,
                    max(win_size, 1), 0.0, fill_ids=fill_ids)

    monkeypatch.setattr(S, "ras_sample_batch", full)


def _altered_wav(monkeypatch):
    import cosy_tpu_torch.models.hift as H

    orig = H.hift_inference

    def altered(*a, **k):
        wav, source = orig(*a, **k)
        return wav * 1.01, source

    monkeypatch.setattr(H, "hift_inference", altered)


def _still_solve(monkeypatch):
    """Every Euler step returns its state unchanged: the estimator's
    velocity is zero, so the solve hands back its noise."""
    import cosy_tpu_torch.models.flow as F
    import cosy_tpu_torch.models.flow2 as F2

    for mod in (F, F2):
        monkeypatch.setattr(mod, "conditional_decoder",
                            lambda p, cfg, x, *a, **k: torch.zeros_like(x))


FAULTS = {"token": _altered_tokens, "full": _always_full, "wav": _altered_wav,
          "still": _still_solve}


@pytest.mark.parametrize("name,fault", [
    ("cv300m.stream16", "token"), ("cv300m.stream16", "wav"),
    ("cv2-0.5b.stream8", "token"), ("cv2-0.5b.stream8", "wav"),
    ("cv300m.vc-long", "wav"), ("cv300m.stream16", "full"), ("cv2-0.5b.stream8", "full"),
    ("cv300m.vc-long", "still"), ("cv300m.stream16", "still"), ("cv2-0.5b.stream8", "still")])
def test_a_fault_under_the_timed_path_fails_the_check(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    _, samples, numbers = _run(CELLS[name]())
    ok, compared = check.compare(numbers, _limits(name))
    assert samples and not ok, compared
    key = "wav_rel_err" if fault in ("wav", "still") else "token_cdf_miss"
    assert compared[key]["value"] > compared[key]["limit"]


def test_samples_hold_the_longest_request():
    cell = CELLS["cv300m.stream16"]()
    drivers = importlib.import_module("portbench.drivers.engine")
    inference = drivers.Driver.inference(cell)
    drv = drivers.Driver(cell, system.build(cell.config, SEED, DEV, inference), SEED,
                         system.plain_config(cell.config))
    drv.warm()
    seen = drv.eng.segments_run
    rec = drv.measure(3.0, Tracer(False))
    assert rec.pending[0] == 0  # as many clients as slots: nothing waits at the open
    # the window holds whole segments: it closes at the first segment end
    # 3 s or more after the one it opened at
    assert rec.window_s == drv.t_close - drv.t_open >= 3.0
    assert rec.segments >= 1 and rec.segment_s * rec.segments == pytest.approx(rec.window_s)
    assert drv.eng.segments_run >= seen + 1 + rec.segments
    samples = drv.samples(SEED)
    done = [r for r in drv.requests if r.tokens is not None and r.err is None
            and drv.t_open <= r.t_done < drv.t_close]
    assert len(samples[0]["tokens"]) == max(len(r.tokens) for r in done)
    assert len(samples) == min(cell.traffic["check_requests"], len(done))
    for s in samples:
        r = drv.requests[s["index"]]
        assert np.array_equal(s["wav"], np.concatenate([w.reshape(-1) for w in r.wav]))
