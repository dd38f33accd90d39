"""The port's continuous-batching engine (infer/engine.py) on the tiny
pipeline, CPU only: a request end to end, tokens and chunks equal to a solo
streamed synthesis with the same seed, mid-flight admission and slot reuse,
concurrent consumers, cancelling a running and a pending request, and a
prefix too long for the engine failing only its own request (the
behaviours of tests/test_engine.py:104-354).  Every wait has a timeout and
every engine is stopped in a finally."""

import threading
import time

import numpy as np
import pytest
import torch

from cosy_tpu_torch.config import InferenceConfig, tiny_model_config
from cosy_tpu_torch.infer.engine import ContinuousBatchEngine
from cosy_tpu_torch.infer.pipeline import TTSPipeline, stream_seed
from cosy_tpu_torch.models.flow import init_flow_params
from cosy_tpu_torch.models.hift import init_hift_params
from cosy_tpu_torch.models.llm import init_llm_params

WAIT = 120  # seconds any single wait may take


@pytest.fixture(scope="module")
def pipe():
    cfg = tiny_model_config()
    # EOS held off to 20 tokens a text id: a request of n ids decodes 20 n
    return TTSPipeline(cfg, init_llm_params(cfg.llm, "cpu", seed=1),
                       init_flow_params(cfg.flow, "cpu", seed=2),
                       init_hift_params(cfg.hift, "cpu", seed=3),
                       InferenceConfig(min_token_text_ratio=20.0))


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, n))


def _drain(req):
    return [c[0] for c in req.chunks(timeout=WAIT)]


def _solo_tokens(pipe, ids, seed, cap):
    return pipe.generate_tokens(ids, np.zeros((1, 192), np.float32), cap,
                                torch.Generator().manual_seed(stream_seed(seed, 0, 0)))[0]


def test_single_request_end_to_end(pipe):
    eng = ContinuousBatchEngine(pipe, slots=2, prefix_len=32, max_len=256)
    try:
        req = eng.submit(_ids(4), seed=1)
        chunks = _drain(req)
        assert len(req.tokens) == 80 and len(chunks) == len(pipe.stream_plan(80))
        wav = np.concatenate(chunks)
        assert wav.size == sum(s for _, _, s in pipe.stream_plan(80)) and np.isfinite(wav).all()
    finally:
        eng.stop()


def test_tokens_and_chunks_equal_solo_stream(pipe):
    """The engine changes scheduling, not results: tokens equal a solo
    decode with the request's seed, and chunks equal synthesize(stream=True)
    with that seed."""
    eng = ContinuousBatchEngine(pipe, slots=2, prefix_len=32, max_len=256)
    try:
        ids = _ids(12, 3)
        req = eng.submit(ids, seed=7)
        chunks = _drain(req)
        assert np.array_equal(req.tokens, _solo_tokens(pipe, ids, 7, 256))
        want = [c["tts_speech"][0] for c in pipe.synthesize(ids, max_len_cap=256, seed=7,
                                                            stream=True)]
        assert len(chunks) == len(want) == len(pipe.stream_plan(240)) == 3
        for g, w in zip(chunks, want):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    finally:
        eng.stop()


def test_mid_flight_admission_and_slot_reuse(pipe):
    """Three requests through two slots: the third joins when the short one
    frees its row while the long one is still decoding, and every stream
    equals its solo decode."""
    eng = ContinuousBatchEngine(pipe, slots=2, prefix_len=32, max_len=256)
    try:
        texts = [_ids(12, 4), _ids(3, 5), _ids(5, 6)]  # 240, 60 and 100 tokens
        reqs = [eng.submit(x, seed=10 + i) for i, x in enumerate(texts)]
        outs = [_drain(r) for r in reqs]
        assert all(o and all(np.isfinite(c).all() for c in o) for o in outs)
        assert reqs[0].admitted_segment == reqs[1].admitted_segment == 0
        assert 0 < reqs[2].admitted_segment < eng.segments_run
        for i, r in enumerate(reqs):
            assert np.array_equal(r.tokens, _solo_tokens(pipe, texts[i], 10 + i, 256))
        deadline = time.time() + WAIT
        while eng._active() and time.time() < deadline:
            time.sleep(0.01)
        assert not eng._active()
    finally:
        eng.stop()


def test_concurrent_consumers(pipe):
    eng = ContinuousBatchEngine(pipe, slots=2, prefix_len=32, max_len=256, seg_tokens=8)
    try:
        results = {}

        def one(i, n):
            req = eng.submit(_ids(n, 20 + i), seed=i)
            results[i] = np.concatenate(_drain(req))

        threads = [threading.Thread(target=one, args=(0, 8)),
                   threading.Thread(target=one, args=(1, 2))]
        threads[0].start()
        time.sleep(0.05)
        threads[1].start()
        for th in threads:
            th.join(timeout=2 * WAIT)
            assert not th.is_alive()
        assert set(results) == {0, 1} and all(v.size > 0 for v in results.values())
    finally:
        eng.stop()


def test_cancel_running_request_frees_slot(pipe):
    eng = ContinuousBatchEngine(pipe, slots=1, prefix_len=32, max_len=256, seg_tokens=20)
    try:
        req = eng.submit(_ids(12, 7), seed=2)  # 240 tokens
        assert req.q.get(timeout=WAIT) is not None  # admitted and producing
        eng.cancel(req)
        deadline = time.time() + WAIT
        while eng._active() and time.time() < deadline:
            time.sleep(0.01)
        assert not eng._active(), "the cancelled row never freed"
        while req.q.get(timeout=WAIT) is not None:
            pass
        assert req.tokens is not None and len(req.tokens) < 240
        req2 = eng.submit(_ids(2, 8), seed=3)
        assert np.concatenate(_drain(req2)).size > 0
    finally:
        eng.stop()


def test_cancel_pending_request(pipe):
    eng = ContinuousBatchEngine(pipe, slots=1, prefix_len=32, max_len=256, seg_tokens=20)
    try:
        r1 = eng.submit(_ids(8, 9), seed=4)
        assert r1.q.get(timeout=WAIT) is not None  # r1 holds the only slot
        r2 = eng.submit(_ids(2, 10), seed=5)
        eng.cancel(r2)
        assert _drain(r2) == [] and r2.err is None
        rest = _drain(r1)
        assert r1.tokens is not None and all(np.isfinite(c).all() for c in rest)
    finally:
        eng.stop()


def test_prefix_too_long_fails_only_that_request(pipe):
    eng = ContinuousBatchEngine(pipe, slots=2, prefix_len=16, max_len=256)
    try:
        long_req = eng.submit(_ids(20, 11), seed=6)  # prefix 23 rows > 16
        ok_req = eng.submit(_ids(2, 12), seed=7)
        with pytest.raises(ValueError, match="prefix length"):
            _drain(long_req)
        assert np.concatenate(_drain(ok_req)).size > 0
    finally:
        eng.stop()
