"""The dispatch pipelining on the device-resident decode (CPU, tiny
configs), after the JAX package's sites (cosy_tpu/infer/pipeline.py:641-662
and 697, pipeline2.py:339 and 378, engine.py:140-152, 295-298, 322-362,
443-448, 464):

- (e) ``_token_segments`` (both pipelines' ``generate_tokens_stream``) and
  ``synthesize_stream_batch`` enqueue segment k + 1 before they read
  segment k, and both ``synthesize_batch`` enqueue every request's
  token2wav before they read a wav; the outputs equal the same calls with
  every segment read as soon as it is enqueued (the order before);
- (f) the engine at slots = 1, seg_tokens = 4: hits > 0 with prefetch on and
  0 with it off, the same tokens and chunks;
- (g) no prefetched segment is kept once the engine is idle;
- (h) an admission and a cancel while a segment is prefetched: the case in
  which the dropped segment's steps stay in the state (rows are
  independent), so every other request keeps its solo decode's tokens;
  the followers of a tensor-parallel server replay the prefetch sections in
  rank 0's order and enqueue the same steps;
- (i) ``serve --engine-prefetch`` is accepted and ``/stats`` carries
  ``prefetch_hits``.

Every engine wait has a timeout and every engine is stopped in a finally."""

import json
import time

import numpy as np
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu_torch import config as TC
from cosy_tpu_torch.config import InferenceConfig, tiny_model_config
from cosy_tpu_torch.infer import pipeline2 as TP2
from cosy_tpu_torch.infer.engine import ContinuousBatchEngine
from cosy_tpu_torch.infer.pipeline import StreamCursor, TTSPipeline, stream_seed
from cosy_tpu_torch.models import decode as TD
from cosy_tpu_torch.models import flow2 as TF2
from cosy_tpu_torch.models import qwen2lm as TQ
from cosy_tpu_torch.models.flow import init_flow_params
from cosy_tpu_torch.models.hift import init_hift_params
from cosy_tpu_torch.models.llm import init_llm_params
from cosy_tpu_torch.params import save_torch_checkpoint
from cosy_tpu_torch.serve import build_parser, build_server
from test_torch_common import port_config, tiny_flats
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_cv2 import FCFG, HCFG, HOP, LCFG
from test_torch_serve import _Live, _pcm_ok

WAIT = 120  # seconds any single wait may take
SPK = np.zeros((1, 192), np.float32)


@pytest.fixture(scope="module")
def pipe():
    cfg = tiny_model_config()
    # EOS held off to 20 tokens a text id: a request of n ids decodes 20 n
    return TTSPipeline(cfg, init_llm_params(cfg.llm, "cpu", seed=1),
                       init_flow_params(cfg.flow, "cpu", seed=2),
                       init_hift_params(cfg.hift, "cpu", seed=3),
                       InferenceConfig(min_token_text_ratio=20.0))


@pytest.fixture(scope="module")
def pipe2():
    mods = (TQ.init_qwen2lm_params(LCFG, "cpu", seed=11),
            TF2.init_flow2_params(FCFG, "cpu", seed=12), init_hift_params(HCFG, "cpu", seed=13))
    return TP2.TTS2Pipeline(LCFG, FCFG, HCFG, *mods,
                            TC.InferenceConfig(nfe_short=2, min_token_text_ratio=8.0),
                            hop_samples=HOP)


def _ids(n, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


class _Order:
    """Records the decode's launches ("L", "A" ahead of a read) and reads
    ("W") in order."""

    def __init__(self, monkeypatch):
        self.events = []
        launch, wait = TD.DeviceDecode.launch, TD.Segment.wait

        def rec_launch(st, stop_at=None, ahead=False):
            self.events.append("A" if ahead else "L")
            return launch(st, stop_at, ahead)

        def rec_wait(seg):
            if seg.copy is None or seg.seq > seg.state._taken:
                self.events.append("W")
            return wait(seg)

        monkeypatch.setattr(TD.DeviceDecode, "launch", rec_launch)
        monkeypatch.setattr(TD.Segment, "wait", rec_wait)

    def ahead(self) -> bool:
        """Every read follows the next segment's launch ahead of it, the
        last one's excepted."""
        s = "".join(self.events)
        return (s.startswith("LAW") and "L" not in s[1:] and "WW" not in s[:-1]
                and s.count("W") >= 2)


def _start(p, ids_list, seed, cv2):
    """The decode state of the pipeline's batch or stream, and its bounds."""
    if cv2:
        return p._decode_start(ids_list, 64, seed)
    return p._decode_batch(ids_list, [p._spk(None)] * len(ids_list), 400, seed)


def _serial_segments(p, ids, seed, cv2):
    """The segmented decode before the pipelining: each segment read as
    soon as it is enqueued (the reference)."""
    st = _start(p, [ids], seed, cv2)
    if cv2:
        step = 2 * p.token_hop_len
        target = step
    else:
        step, target = p.token_min_hop_len, p.first_hop + p.token_overlap_len
    out = []
    while True:
        st.run(min(target, st.caps[0]))
        out.append((np.asarray(st.tokens[0], np.int64)[None], st.done[0]))
        if st.done[0]:
            return out
        target += step


def _stream(p, ids, seed, cv2):
    gen = p._decode_generator(seed, 0)
    if cv2:
        return [(t.copy(), d) for t, d in p.generate_tokens_stream(ids, max_len_cap=64,
                                                                    generator=gen)]
    return [(t.copy(), d) for t, d in p.generate_tokens_stream(ids, SPK, 400, gen)]


@pytest.mark.parametrize("cv2", [False, True], ids=["cosyvoice", "cosyvoice2"])
def test_token_segments_enqueue_ahead_and_keep_the_tokens(pipe, pipe2, cv2, monkeypatch):
    p = pipe2 if cv2 else pipe
    ids = _ids(6 if cv2 else 12, 1, LCFG.qwen.vocab_size if cv2 else 256)
    with torch.inference_mode():
        want = _serial_segments(p, ids, 3, cv2)
        order = _Order(monkeypatch)
        got = _stream(p, ids, 3, cv2)
    assert len(got) == len(want) >= 2 and got[-1][1]
    for (g, gd), (w, wd) in zip(got, want):
        assert np.array_equal(g, w) and gd == wd
    assert order.ahead(), order.events


def _serial_stream_batch(p, texts, cv2):
    """``synthesize_stream_batch`` before the pipelining (the reference)."""
    B = len(texts)
    st = _start(p, texts, 4, cv2)
    if cv2:
        curs = [TP2.Stream2Cursor(p._spk(None), 4, b, p.token_hop_len) for b in range(B)]
        hop = target = 2 * p.token_hop_len
    else:
        hop = p.token_min_hop_len
        curs = [StreamCursor(p._spk(None), 4, b, hop) for b in range(B)]
        target = hop + p.token_overlap_len
    out, finished = {}, [False] * B
    while not all(finished):
        st.run(target)
        for b in range(B):
            if finished[b]:
                continue
            finished[b] = st.done[b]
            wavs = list(p.stream_chunks(curs[b], np.asarray(st.tokens[b], np.int64)[None],
                                        finished[b]))
            out.setdefault(b, []).extend((w, finished[b] and i == len(wavs) - 1)
                                         for i, w in enumerate(wavs))
        target += hop
    return out


def _stream_batch(p, texts, cv2):
    out = {}
    for b, wav, last in p.synthesize_stream_batch(texts, max_len_cap=64 if cv2 else 400,
                                                  seed=4):
        out.setdefault(b, []).append((wav, last))
    return out


@pytest.mark.parametrize("cv2", [False, True], ids=["cosyvoice", "cosyvoice2"])
def test_stream_batch_enqueues_ahead_with_the_same_chunks(pipe, pipe2, cv2, monkeypatch):
    p = pipe2 if cv2 else pipe
    lens = (7, 4, 6) if cv2 else (7, 12, 9)
    texts = [_ids(n, 10 + n, LCFG.qwen.vocab_size if cv2 else 256) for n in lens]
    with torch.inference_mode():
        want = _serial_stream_batch(p, texts, cv2)
    order = _Order(monkeypatch)
    got = _stream_batch(p, texts, cv2)
    assert order.ahead(), order.events
    assert sorted(got) == sorted(want) == [0, 1, 2]
    assert max(len(got[b]) for b in range(3)) > 1
    for b in range(3):
        assert len(got[b]) == len(want[b]) and got[b][-1][1]
        for (g, gl), (w, wl) in zip(got[b], want[b]):
            assert np.array_equal(g, w) and gl == wl


@pytest.mark.parametrize("cv2", [False, True], ids=["cosyvoice", "cosyvoice2"])
def test_synthesize_batch_enqueues_every_token2wav_before_a_read(pipe, pipe2, cv2,
                                                                monkeypatch):
    """The wavs equal a token2wav call a request on the batch's tokens and
    draws; the record shows every token2wav enqueued before the first read
    of a wav (``Tensor.cpu``)."""
    p = pipe2 if cv2 else pipe
    texts = [_ids(n, 20 + n, LCFG.qwen.vocab_size if cv2 else 256) for n in (2, 3, 1)]
    events = []
    t2w, cpu = p._token2wav, torch.Tensor.cpu
    monkeypatch.setattr(p, "_token2wav", lambda *a: (events.append("t2w"), t2w(*a))[1])
    monkeypatch.setattr(torch.Tensor, "cpu", lambda x, *a, **k: (events.append("read"),
                                                                  cpu(x, *a, **k))[1])
    got = p.synthesize_batch(texts, max_len_cap=64 if cv2 else 2048, seed=5)
    monkeypatch.undo()
    assert events == ["t2w"] * 3 + ["read"] * 3
    with torch.inference_mode():
        if cv2:
            rows = p.decode_batch(texts, 64, 5)
            want = [p.token2wav(np.asarray(r, np.int64)[None], None, None, p._spk(None), 0,
                                generator=p._wav_generator(5, b, 0))[0]
                    for b, r in enumerate(rows)]
        else:
            st = p._decode_batch(texts, [p._spk(None)] * 3, 2048, 5).run()
            want = [p.token2wav(np.asarray(st.tokens[b], np.int64)[None], p._spk(None),
                                generator=p._wav_generator(5, b, 0)) for b in range(3)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


# -- the engine -------------------------------------------------------------


def _drain(req):
    return [c[0] for c in req.chunks(timeout=WAIT)]


def _wait_idle(eng):
    deadline = time.time() + WAIT
    while eng._active() and time.time() < deadline:
        time.sleep(0.01)
    assert not eng._active()


def _solo_tokens(pipe, ids, seed, cap):
    return pipe.generate_tokens(ids, SPK, cap, torch.Generator().manual_seed(
        stream_seed(seed, 0, 0)))[0]


def _one_slot(pipe, prefetch):
    eng = ContinuousBatchEngine(pipe, slots=1, prefix_len=32, max_len=256, seg_tokens=4,
                                prefetch=prefetch)
    try:
        outs = []
        for i, n in enumerate((12, 7)):
            req = eng.submit(_ids(n, 30 + i), seed=40 + i)
            outs.append((req, _drain(req)))
            _wait_idle(eng)
            assert eng._ahead is None  # (g) nothing prefetched is kept while idle
        return eng, outs
    finally:
        eng.stop(timeout=WAIT)


def test_engine_prefetch_hits_only_when_on_with_the_same_tokens(pipe):
    on, got = _one_slot(pipe, True)
    off, want = _one_slot(pipe, False)
    assert on.prefetch_hits > 0 and off.prefetch_hits == 0
    assert on._ahead is None and off._ahead is None
    for i, ((r, chunks), (r0, chunks0)) in enumerate(zip(got, want)):
        assert np.array_equal(r.tokens, r0.tokens)
        assert np.array_equal(r.tokens, _solo_tokens(pipe, _ids((12, 7)[i], 30 + i), 40 + i, 256))
        assert len(chunks) == len(chunks0) > 1
        for c, c0 in zip(chunks, chunks0):
            assert np.array_equal(c, c0)


class _Recorder:
    """A replay ``Leader`` stand-in: keeps the ops rank 0 sends."""

    def __init__(self):
        self.ops = []

    def send(self, op):
        self.ops.append(op)


def _admit_and_cancel(pipe, prefetch):
    """Three slots: r0 alone; r1 and r2 submitted while r0's first window is
    synthesized (after the next segment was prefetched), so their
    admission drops it; r2 cancelled at its own first window, so the next
    segment drops the prefetched one (a row frozen since)."""
    rec = _Recorder()
    eng = ContinuousBatchEngine(pipe, slots=3, prefix_len=32, max_len=256, seg_tokens=4,
                                replay=rec, prefetch=prefetch)
    seen = {"admit_drops": 0, "cancel_drops": 0}
    reqs = []
    admit, segment, run, window = eng._admit, eng._segment, eng._run, eng._window

    def spy_admit(req, slot):
        seen["admit_drops"] += eng._ahead is not None
        return admit(req, slot)

    def spy_segment():
        seen["ahead"] = eng._ahead is not None
        return segment()

    def spy_run(frozen, stop_at):
        seen["cancel_drops"] += bool(frozen) and seen["ahead"]
        return run(frozen, stop_at)

    def spy_window(slot, tokens, done):
        wav = window(slot, tokens, done)
        if wav is not None and len(reqs) == 1:
            reqs.extend([eng.submit(_ids(3, 51), seed=61), eng.submit(_ids(8, 52), seed=62)])
        elif wav is not None and eng._slots[slot] is reqs[2] and not reqs[2].cancelled:
            eng.cancel(reqs[2])
        return wav

    eng._admit, eng._segment, eng._run, eng._window = spy_admit, spy_segment, spy_run, spy_window
    try:
        reqs.append(eng.submit(_ids(12, 50), seed=60))
        outs = [_drain(reqs[0])]
        deadline = time.time() + WAIT
        while len(reqs) < 3 and time.time() < deadline:
            time.sleep(0.01)
        outs.append(_drain(reqs[1]))
        _drain(reqs[2])
        _wait_idle(eng)
        assert eng._ahead is None
        return eng, reqs, outs, seen, rec
    finally:
        eng.stop(timeout=WAIT)


def test_admission_and_cancel_during_a_prefetch_keep_the_tokens(pipe):
    eng, reqs, outs, seen, rec = _admit_and_cancel(pipe, True)
    off, reqs0, outs0, _, _ = _admit_and_cancel(pipe, False)
    assert eng.prefetch_hits > 0 and seen["admit_drops"] >= 1 and seen["cancel_drops"] >= 1
    for i in (0, 1):
        solo = _solo_tokens(pipe, _ids((12, 3)[i], 50 + i), 60 + i, 256)
        assert np.array_equal(reqs[i].tokens, solo) and np.array_equal(reqs0[i].tokens, solo)
        assert len(outs[i]) == len(outs0[i])
        for c, c0 in zip(outs[i], outs0[i]):
            assert np.array_equal(c, c0)
    cancelled = reqs[2].tokens
    solo = _solo_tokens(pipe, _ids(8, 52), 62, 256)
    assert cancelled is not None and len(cancelled) < len(solo)
    assert np.array_equal(cancelled, solo[:len(cancelled)])
    # a follower replays rank 0's sections in order on its own mirror (it
    # reads nothing back) and enqueues the same steps
    names = [op[1] for op in rec.ops]
    assert "prefetch" in names and names.index("prefetch") > names.index("run")
    fol = ContinuousBatchEngine(pipe, slots=3, prefix_len=32, max_len=256, seg_tokens=4)
    with torch.inference_mode():
        for _, name, args in rec.ops:
            fol.apply(name, args)
    assert fol._state.i == eng._state.i and fol._state.segments_run == eng._state.segments_run
    eng._state.run(eng._state.i)
    fol._state.run(fol._state.i)
    assert fol._state.tokens == eng._state.tokens


# -- the server -------------------------------------------------------------


def test_serve_engine_prefetch_is_accepted_and_reported(tmp_path, monkeypatch):
    import cosy_tpu_torch.api as TAPI

    jcfg = j_tiny()
    tcfg = port_config(jcfg)
    for part, flat in tiny_flats(jcfg, seed=43).items():
        save_torch_checkpoint(flat, str(tmp_path / f"{part}.pt"))
    real = TAPI.CosyVoice
    monkeypatch.setattr(TAPI, "CosyVoice", lambda d, **kw: real(d, model_cfg=tcfg, **kw))
    server = build_server(build_parser().parse_args(
        ["--model-dir", str(tmp_path), "--device", "cpu", "--finetuned-norm", "1",
         "--engine-slots", "1", "--engine-prefetch"]))
    assert server.engine is not None and server.engine._prefetch_on
    server.engine.max_len, server.engine.seg = 64, 2
    with _Live(server) as live:
        _pcm_ok(live.post({"text": "hello there.", "stream": True})[1])
        stats = json.loads(live.get("/stats"))
    assert stats["engine"]["prefetch_hits"] == server.engine.prefetch_hits > 0
    assert stats["engine"]["segments_run"] > stats["engine"]["prefetch_hits"]
