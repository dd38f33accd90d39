"""The arithmetic of a measured window: chunk accounting on a synthetic
timeline, the busy union, the idle gaps, the spans' device time and what
the readers make of them."""

import math

import numpy as np
import pytest

from portbench import run, spec
from portbench.drivers.engine import Request, audio_in, first_chunk_waits
from portbench.record import Record
from portbench.trace import Profile, charge_spans, gaps, union_seconds

PEAKS = spec.load_json(spec.HERE / "yardstick" / "peaks.json")


def _read(name, rec):
    return run.metric_module(spec.HERE / "metrics" / f"{name}.py").read(rec)


def _request(submit, arrivals, samples=22050):
    r = Request(0, 0, 10, np.zeros((1, 10), np.int64), 1, 120)
    r.t_submit = submit
    r.chunks = [(t, samples) for t in arrivals]
    r.t_first = arrivals[0] if arrivals else None
    return r


def test_only_chunks_that_arrived_inside_the_window_count():
    # window [10, 20): a chunk at 10 counts, one at 20 does not, nor one before
    reqs = [_request(1.0, [9.99, 10.0, 15.0]), _request(12.0, [19.999, 20.0, 25.0]),
            _request(30.0, [])]
    assert audio_in(reqs, 10.0, 20.0, 22050) == pytest.approx(3.0)
    assert audio_in(reqs, 20.0, 30.0, 22050) == pytest.approx(2.0)
    assert audio_in(reqs, 0.0, 10.0, 22050) == pytest.approx(1.0)
    # a first chunk before the window leaves that request out of the waits
    assert first_chunk_waits(reqs, 10.0, 20.0) == [pytest.approx(7.999)]
    assert first_chunk_waits(reqs, 0.0, 10.0) == [pytest.approx(8.99)]


def test_union_and_gaps():
    ns = 1_000_000_000
    spans = [(0, 2 * ns), (1 * ns, 3 * ns), (5 * ns, 6 * ns)]
    assert union_seconds(spans) == pytest.approx(4.0)
    assert union_seconds([]) == 0.0
    assert gaps(spans, 0, 8 * ns) == [(3 * ns, 5 * ns), (6 * ns, 8 * ns)]
    assert gaps(spans, -ns, 4 * ns) == [(-ns, 0), (3 * ns, 4 * ns)]


def test_device_time_is_charged_to_the_span_that_launched_it():
    ms = 1_000_000
    spans = [("estimator", 0, 5 * ms), ("hift", 6 * ms, 8 * ms)]
    # launches at 1 and 4 ms (inside the estimator), 7 ms (hift), 9 ms (none);
    # the kernels run later than their launches
    launch_at = {1: 1 * ms, 2: 4 * ms, 3: 7 * ms, 4: 9 * ms}
    device = [(1, 2 * ms, 3 * ms), (2, 5 * ms, 7 * ms), (3, 8 * ms, 9 * ms),
              (4, 9 * ms, 10 * ms), (5, 0, ms)]
    assert charge_spans(device, launch_at, spans) == {"estimator": 3 * ms, "hift": ms}


def test_only_calls_wholly_inside_the_profiled_stretch_count():
    from portbench.spans import Spans

    sp = Spans({})
    sp.marks = [100, 200]
    sp.calls = [("estimator", 50, 150, {"n": 1}), ("estimator", 120, 180, {"n": 2}),
                ("estimator", 190, 250, {"n": 3}), ("hift", 110, 190, {"n": 4})]
    assert sp.of("estimator") == [{"n": 2}] and sp.of("hift") == [{"n": 4}]
    assert Spans({}).complete() == []


def _profile():
    ms = 1_000_000
    device = [("gemm", 0, 4 * ms), ("flash_attention_kernel<float, false>", 4 * ms, 6 * ms),
              ("gemm", 8 * ms, 9 * ms)]
    host = [("portbench.estimator", 0, 10 * ms), ("aten::item", 6 * ms, 8 * ms)]
    return Profile(device, host, launches=30, lo=0, hi=10 * ms,
                   span_device={"estimator": 4 * ms, "hift": 1 * ms})


def test_profile_reduction():
    p = _profile()
    assert p.window_s == pytest.approx(0.010)
    assert p.busy_s == pytest.approx(0.007)
    assert p.top_ops(1) == [["gemm", pytest.approx(0.005)]]
    assert p.span_seconds("estimator") == pytest.approx(0.004)
    assert p.span_seconds("decode_step") is None
    # the gap at 6-8 ms falls inside aten::item, the one at 9-10 ms inside the span only
    assert p.idle_by_host() == [["aten::item", pytest.approx(0.002)],
                                ["portbench.estimator", pytest.approx(0.001)]]


def test_end_to_end_readers():
    rec = Record(window_s=50.0, setup_s=31.5, audio_s=200.0)
    for name in ("audio_s_per_s", "served_audio_s_per_s", "train_audio_s_per_s"):
        assert _read(name, rec) == pytest.approx(4.0)
        assert _read(name, Record(window_s=50.0)) is None
    assert _read("setup_s", rec) == 31.5


def test_engine_readers():
    rec = Record(window_s=51.0, segments=4, segment_s=12.5, ttfa_s=[3.0, 1.0, 2.0, 5.0, 4.0])
    assert _read("engine.segment_ms.serve", rec) == pytest.approx(12500.0)
    assert _read("engine.ttfa_p50_ms.serve", rec) == pytest.approx(3000.0)
    assert _read("engine.segment_ms.serve", Record(window_s=51.0)) is None
    assert _read("engine.ttfa_p50_ms.serve", Record(window_s=51.0)) is None


class _Spans:
    def __init__(self, calls):
        self.calls = calls

    def of(self, span):
        return self.calls.get(span, [])


def test_traced_readers():
    from portbench.reference.frozen import config as FC
    from portbench.yardstick import costs as C
    import types

    plain = types.SimpleNamespace(model=FC.ModelConfig())
    est = plain.model.flow.estimator
    call = {"args": [None, None, (2, 80, 312)], "kwargs": {}}
    least = max(C.estimator_call_flops(est, 2, 312).total / 495e12,
                C.estimator_call_bytes(est, 2, 312) / 3.35e12)
    step_bytes, step_flops = C.decode_step_work(plain, 16, 300)
    rec = Record(window_s=51.0, audio_s=100.0, profile=_profile(), traced_audio_s=0.5,
                 traced_flops=495e12 * 0.010 * 0.02, peaks=PEAKS, plain=plain,
                 spans=_Spans({"estimator": [call, call],
                               "decode_step": [{"rows": 16, "width": 300}]}))
    rec.profile.span_device["decode_step"] = 2 * 1_000_000
    assert _read("idle_share.serve", rec) == pytest.approx(30.0)
    assert _read("dispatch.launches_per_audio_s.serve", rec) == pytest.approx(60.0)
    assert _read("mfu.offline", rec) == pytest.approx(2.0)
    assert _read("hift.device_ms_per_audio_s.offline", rec) == pytest.approx(2.0)
    assert _read("estimator_roofline.offline", rec) == pytest.approx(100 * 2 * least / 0.004)
    assert _read("decode_roofline.serve", rec) == pytest.approx(
        100 * max(step_flops / 495e12, step_bytes / 3.35e12) / 0.002)
    train = Record(window_s=51.0, profile=_profile(), traced_steps=3,
                   loader_wait_s=[0.002, 0.001, 0.010])
    assert _read("train.launches_per_step.train", train) == pytest.approx(10.0)
    assert _read("train.loader_wait_ms.train", train) == pytest.approx(2.0)


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (spec.HERE / "metrics").glob("*.py") if p.stem != "setup_s"))
def test_readers_with_nothing_to_read_return_nothing(name):
    assert _read(name, Record(window_s=51.0, peaks=PEAKS)) is None


def test_gaps_without_an_operator_take_the_api_call_or_none():
    ms = 1_000_000
    device = [("k", 0, 2 * ms), ("k", 4 * ms, 5 * ms), ("k", 9 * ms, 10 * ms)]
    api = [("cudaStreamSynchronize", 2 * ms, 4 * ms)]
    p = Profile(device, [], launches=3, lo=0, hi=10 * ms, api=api)
    assert p.idle_by_host() == [["(host between CUDA API calls)", pytest.approx(0.004)],
                                ["cudaStreamSynchronize", pytest.approx(0.002)]]
    assert math.isclose(p.busy_s, 0.004)
