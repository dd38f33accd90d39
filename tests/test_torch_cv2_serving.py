"""CosyVoice2 serving in the port on the CPU, at the tiny configs of
tests/test_pipeline2.py: slot admission into an idle and a running
``Qwen2DecodeState`` (tokens equal to the solo decode), batched streaming
(``synthesize_stream_batch``: tokens and chunks equal to solo streams, the
windows held to the JAX pipeline's ``token2wav`` on the same tokens with
its HiFT draws injected), the continuous-batching engine with a
``TTS2Pipeline`` (mid-flight admission, cancel, a prefix too long), and
the streaming-text decoder (``Qwen2StreamDecoder.advance`` logits and
``qwen2lm_inference_bistream`` token streams against JAX with a scripted
sampler on both sides; the capacity check).  Tolerance 2e-4 for wavs and
logits, exact for tokens.  Every engine wait has a timeout."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosy_tpu.infer import pipeline2 as JP2
from cosy_tpu.models import qwen2lm as JLM
from cosy_tpu.params import P as JP
from cosy_tpu_torch import config as TC
from cosy_tpu_torch.infer import pipeline2 as TP2
from cosy_tpu_torch.infer.engine import ContinuousBatchEngine
from cosy_tpu_torch.infer.pipeline import _batch_prefixes
from cosy_tpu_torch.models import flow2 as TF2
from cosy_tpu_torch.models import qwen2lm as TQ
from cosy_tpu_torch.models.hift import init_hift_params
from test_torch_common import assert_close, t
from test_torch_cv2 import FCFG, HCFG, HOP, LCFG, jax_config
from test_torch_hift import _jax_draws
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)
WAIT = 120  # seconds any single engine wait may take
CAP = 64


@pytest.fixture(scope="module")
def cv2():
    """Tiny CosyVoice2 weights from the port's inits, EOS held off to 8
    attempts a text id; both pipelines."""
    mods = (TQ.init_qwen2lm_params(LCFG, "cpu", seed=11),
            TF2.init_flow2_params(FCFG, "cpu", seed=12), init_hift_params(HCFG, "cpu", seed=13))
    flat = [{k: v.numpy() for k, v in m.state_dict().items()} for m in mods]
    icfg = TC.InferenceConfig(nfe_short=2, min_token_text_ratio=8.0)
    jpipe = JP2.TTS2Pipeline(jax_config(LCFG), jax_config(FCFG), jax_config(HCFG),
                             *({k: jnp.asarray(v) for k, v in f.items()} for f in flat),
                             jax_config(icfg), hop_samples=HOP)
    tpipe = TP2.TTS2Pipeline(LCFG, FCFG, HCFG, *mods, icfg, hop_samples=HOP)
    return jpipe, tpipe, flat


def _text(n, seed):
    return np.random.default_rng(seed).integers(0, LCFG.qwen.vocab_size, (1, n))


def _solo(tpipe, text, seed, row=0, cap=CAP):
    return tpipe.generate_tokens(text, max_len_cap=cap,
                                 generator=tpipe._decode_generator(seed, row))[0].tolist()


def _solo_stream(tpipe, text, seed, row=0, cap=CAP):
    """A solo streamed synthesis with row ``row``'s draws: (tokens, chunks)."""
    cur = TP2.Stream2Cursor(tpipe._spk(None), seed, row, tpipe.token_hop_len)
    chunks, tokens = [], None
    for tokens, done in tpipe.generate_tokens_stream(
            text, max_len_cap=cap, generator=tpipe._decode_generator(seed, row)):
        chunks += list(tpipe.stream_chunks(cur, tokens, done))
    return tokens[0].tolist(), chunks


# ---------------------------------------------------------------------------
# slot admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("into", ["idle", "running"])
def test_admitted_rows_decode_as_their_solo_runs(cv2, into):
    """Idle: a state of 2 free rows and 64 attempt columns a row; row 0 takes
    a request with min_len 12 and cap 20, and after 7 steps row 1 a request
    with cap 60, larger than the first cohort's.  Running: a batched start
    of 2 rows (caps 10 and 40); row 0 finishes and takes a new request
    while row 1 is still decoding.  Every row's tokens equal its solo
    decode's; a cap past the state's columns is refused."""
    _, tpipe, _ = cv2
    p, sampling = tpipe.llm_p, tpipe._sampling()
    texts = [_text(n, 30 + n) for n in (3, 5, 2)]
    built = [tpipe._build_prefix(x, None, None, CAP) for x in texts]
    L0 = 16

    def padded(b):
        pr = built[b][0]
        return torch.nn.functional.pad(pr, (0, 0, L0 - pr.shape[1], 0)), pr.shape[1]

    def solo(b, min_len, cap, seed):
        return TQ.qwen2lm_decode(p, LCFG, built[b][0], min_len, cap,
                                 generator=torch.Generator().manual_seed(seed), **sampling)

    if into == "idle":
        state = TQ.qwen2lm_decode_idle(p, LCFG, 2, L0, CAP, torch.float32, "cpu", **sampling)
        TQ.qwen2lm_admit_slot(state, *padded(0), 12, 20, torch.Generator().manual_seed(1), 0)
        state.run(state.i + 7)
        i_before = state.i
        TQ.qwen2lm_admit_slot(state, *padded(1), 0, 60, torch.Generator().manual_seed(2), 1)
        assert state.i == i_before
        state.run()
        assert state.tokens[0] == solo(0, 12, 20, 1) and len(state.tokens[0]) > 0
        assert state.tokens[1] == solo(1, 0, 60, 2)
        assert state.attempts[0] <= 20 and 12 <= state.attempts[0]
        with pytest.raises(ValueError, match="cap 65"):
            TQ.qwen2lm_admit_slot(state, *padded(2), 0, CAP + 1, None, 0)
    else:
        prefix, valid, _, _ = _batch_prefixes(built[:2])
        prefix = torch.nn.functional.pad(prefix, (0, 0, L0 - prefix.shape[1], 0))
        state = TQ.qwen2lm_decode_start(p, LCFG, prefix, valid, [0, 0], [10, 40],
                                        [torch.Generator().manual_seed(s) for s in (3, 4)],
                                        **sampling)
        while not state.done[0]:
            state.run(state.i + 1)
        assert not state.done[1]
        first = list(state.tokens[0])
        TQ.qwen2lm_admit_slot(state, *padded(2), 5, 30, torch.Generator().manual_seed(5), 0)
        state.run()
        assert first == solo(0, 0, 10, 3)
        assert state.tokens[0] == solo(2, 5, 30, 5)
        assert state.tokens[1] == solo(1, 0, 40, 4)
        with pytest.raises(ValueError, match="does not fit"):
            TQ.qwen2lm_admit_slot(state, *padded(0), 0, 41, None, 0)


# ---------------------------------------------------------------------------
# batched streaming
# ---------------------------------------------------------------------------


def test_synthesize_stream_batch_rows_equal_solo_streams(cv2):
    """3 requests in one lock-step segmented decode: each row's tokens are
    its solo decode's, and its chunks (count, order, wav at 2e-4) a solo
    streamed synthesis with row b's draws; the last chunk of a row is
    flagged, once."""
    _, tpipe, _ = cv2
    texts = [_text(n, 40 + n) for n in (4, 2, 6)]
    seed = 9
    got = {b: [] for b in range(3)}
    lasts = []
    for b, wav, last in tpipe.synthesize_stream_batch(texts, max_len_cap=CAP, seed=seed):
        assert not got[b] or not got[b][-1][1], "a chunk after the last"
        got[b].append((wav, last))
        lasts.append(b) if last else None
    assert sorted(lasts) == [0, 1, 2]
    assert set(tpipe.stage_seconds) >= {"decode", "flow", "hift"}
    rows = tpipe.decode_batch(texts, CAP, seed)
    for b, text in enumerate(texts):
        tokens, chunks = _solo_stream(tpipe, text, seed, b)
        assert rows[b] == tokens == _solo(tpipe, text, seed, b)
        assert len(got[b]) == len(chunks) == (len(tokens) - 3) // 25 + 1
        assert sum(w.shape[1] for w, _ in got[b]) == len(tokens) * 2 * HOP
        for k, ((g, _), w) in enumerate(zip(got[b], chunks)):
            assert g.shape == w.shape
            assert_close(g, w, **TOL, name=f"row {b} chunk {k}")


def test_stream_windows_match_the_jax_pipeline(cv2):
    """Row 0's windows, cut by the port's planner from its own tokens, run
    through JAX's token2wav (the window plan of JAX's
    synthesize_stream_batch: cumulative windows of offset + 25 + 3 tokens,
    then the rest) and through the port's with JAX's HiFT draws injected:
    the same number of chunks, every wav and carry at 2e-4."""
    jpipe, tpipe, _ = cv2
    text, seed = _text(6, 46), 9
    tokens, chunks = _solo_stream(tpipe, text, seed, 0)
    tok = np.asarray(tokens, np.int32)[None]
    spk = np.zeros((1, FCFG.spk_embed_dim), np.float32)
    base = jax.random.PRNGKey(5)
    jstate, tstate = JP2.Stream2State(), TP2.Stream2State()
    H, la, hop, r = HCFG.nb_harmonics + 1, FCFG.pre_lookahead_len, 25, FCFG.token_mel_ratio
    off, k, n = 0, 0, tok.shape[1]
    plan = []
    while n >= off + hop + la:
        plan.append((off + hop + la, off, False))
        off += hop
    plan.append((n, off, True))
    assert len(plan) == len(chunks) >= 2
    for k, (end, off, final) in enumerate(plan):
        key = jax.random.fold_in(base, k)
        want, jstate = jpipe.token2wav(key, tok[:, :end], None, None, spk, off, jstate,
                                       stream=not final, finalize=final)
        frames = (tpipe._final_out_tokens if final else hop) * r + (8 if k else 0)
        phase, noise = _jax_draws(key, 1, H, frames * HOP)
        got, tstate = tpipe.token2wav(tok[:, :end], None, None, spk, off, tstate,
                                      stream=not final, finalize=final, hift_phase=phase,
                                      hift_noise=noise)
        assert got.shape == np.asarray(want).shape == chunks[k].shape, k
        assert_close(got, np.asarray(want), **TOL, name=f"chunk {k}")
        if not final:
            for f in ("hift_mel", "hift_source", "hift_speech"):
                assert_close(getattr(tstate, f), np.asarray(getattr(jstate, f)), **TOL,
                             name=f"{k} {f}")


# ---------------------------------------------------------------------------
# the engine's CosyVoice2 branch
# ---------------------------------------------------------------------------


def _drain(req):
    return [c for c in req.chunks(timeout=WAIT)]


def _wait_idle(eng):
    deadline = time.time() + WAIT
    while eng._active() and time.time() < deadline:
        time.sleep(0.01)
    assert not eng._active()


def test_engine_streams_equal_solo_with_a_mid_flight_admission(cv2):
    """2 slots, 4 requests: the two short ones free their rows while a long
    one decodes, so a later request joins mid-flight; every request's
    tokens equal its solo decode and its chunks its solo stream (2e-4)."""
    _, tpipe, _ = cv2
    eng = ContinuousBatchEngine(tpipe, slots=2, prefix_len=16, max_len=CAP)
    assert eng.is_cv2 and eng.seg == 50
    try:
        texts = [_text(n, 50 + i) for i, n in enumerate((7, 1, 2, 3))]
        reqs = [eng.submit(x, seed=20 + i) for i, x in enumerate(texts)]
        outs = [_drain(r) for r in reqs]
        assert reqs[0].admitted_segment == reqs[1].admitted_segment == 0
        assert any(0 < r.admitted_segment for r in reqs[2:])
        for i, (req, out) in enumerate(zip(reqs, outs)):
            assert req.tokens.tolist() == _solo(tpipe, texts[i], 20 + i)
            want = [c["tts_speech"] for c in tpipe.synthesize(texts[i], max_len_cap=CAP,
                                                              seed=20 + i, stream=True)]
            assert len(out) == len(want) > 0
            for g, w in zip(out, want):
                assert_close(g, w, **TOL, name=f"request {i}")
        _wait_idle(eng)
    finally:
        eng.stop()


def test_engine_cancel_frees_the_slot_and_a_long_prefix_fails_alone(cv2):
    _, tpipe, _ = cv2
    eng = ContinuousBatchEngine(tpipe, slots=1, prefix_len=8, max_len=CAP, seg_tokens=10)
    try:
        req = eng.submit(_text(5, 60), seed=1)  # 40-64 attempts
        assert req.q.get(timeout=WAIT) is not None  # admitted and producing
        eng.cancel(req)
        _wait_idle(eng)
        while req.q.get(timeout=WAIT) is not None:
            pass
        assert req.tokens is not None and len(req.tokens) < CAP
        long_req = eng.submit(_text(7, 61), seed=2)  # prefix 9 rows > 8
        ok_req = eng.submit(_text(2, 62), seed=3)
        with pytest.raises(ValueError, match="prefix length 9"):
            _drain(long_req)
        assert sum(c.shape[1] for c in _drain(ok_req)) == len(ok_req.tokens) * 2 * HOP > 0
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# streaming-text decode (bistream)
# ---------------------------------------------------------------------------


def test_stream_decoder_advance_matches_jax(cv2):
    """Segments of 3, 1, 5, 1 and 2 embeddings: each advance's logits
    against JAX's (2e-4), and the position counter."""
    _, tpipe, flat = cv2
    jp = JP({k: jnp.asarray(v) for k, v in flat[0].items()})
    jdec = JLM.Qwen2StreamDecoder(jp, jax_config(LCFG), capacity=32)
    tdec = TQ.Qwen2StreamDecoder(tpipe.llm_p, LCFG, capacity=32)
    rng = np.random.default_rng(7)
    for n in (3, 1, 5, 1, 2):
        emb = rng.standard_normal((1, n, LCFG.llm_input_size)).astype(np.float32)
        assert_close(tdec.advance(t(emb)), np.asarray(jdec.advance(jnp.asarray(emb))), **TOL)
    assert tdec.L == jdec.L == 12


def _scripted(fill_at, fill):
    """A sampler for both packages: the argmax of the masked log-probs,
    except the fill token at the calls numbered in ``fill_at``."""
    calls = []

    def pick(logp):
        calls.append(len(calls))
        return fill if calls[-1] in fill_at else int(np.argmax(np.asarray(logp)))

    return pick


@pytest.mark.parametrize("prompt", [False, True], ids=["no_prompt", "speech_prompt"])
def test_bistream_token_stream_matches_jax(cv2, monkeypatch, prompt):
    """4 text chunks (with and without a prompt text and 20 prompt speech
    tokens to interleave): the same scripted sampler installed in both
    packages gives the same token stream, fill tokens and the forced fill
    schedule included."""
    _, tpipe, flat = cv2
    fill = LCFG.speech_token_size + 2
    jpick, tpick = _scripted({1, 9}, fill), _scripted({1, 9}, fill)
    monkeypatch.setattr(JLM, "ras_sample", lambda key, logp, *a: jpick(logp))
    monkeypatch.setattr(TQ, "ras_sample", lambda logp, *a, **k: tpick(logp))
    chunks = [_text(n, 70 + n) for n in (3, 7, 2, 6)]
    kw = {}
    if prompt:
        kw = dict(prompt_text=_text(4, 80),
                  prompt_speech_token=np.random.default_rng(81).integers(0, 30, (1, 20)))
    jp = JP({k: jnp.asarray(v) for k, v in flat[0].items()})
    want = list(JLM.qwen2lm_inference_bistream(
        jp, jax_config(LCFG), jax.random.PRNGKey(0), iter(chunks),
        **{k: jnp.asarray(v) for k, v in kw.items()}, capacity=160, max_tokens=40))
    got = list(TQ.qwen2lm_inference_bistream(tpipe.llm_p, LCFG, iter(chunks), **kw,
                                             capacity=160, max_tokens=40))
    assert got == want and len(got) > 5
    assert all(0 <= x < LCFG.speech_token_size for x in got)


def test_bistream_capacity_overflow_raises(cv2):
    _, tpipe, _ = cv2
    dec = TQ.Qwen2StreamDecoder(tpipe.llm_p, LCFG, capacity=8)
    dec.advance(torch.zeros(1, 6, LCFG.llm_input_size))
    with pytest.raises(ValueError, match=r"6 \+ 3 > 8"):
        dec.advance(torch.zeros(1, 3, LCFG.llm_input_size))
    assert dec.L == 6
    gen = TQ.qwen2lm_inference_bistream(tpipe.llm_p, LCFG, iter([_text(12, 90)]), capacity=4)
    with pytest.raises(ValueError, match="capacity"):
        list(gen)
