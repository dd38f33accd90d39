"""Streaming synthesis of the port (infer/pipeline.py) against the JAX
package's TTSPipeline at tiny_model_config(), with JAX's own draws
injected (z at the shape JAX draws it, the HiFT phase and noise at the
full source length): every chunk's wav and every StreamState field, a
prompted window whose flow cache covers the prompt region, and the
bucketed final chunk, all at 2e-4; the port's bucketed final against its
own unbucketed one; the fades at 1e-6; the first hop and the chunk
geometry; the streamed tokens; the CLI's --stream."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import replace as j_replace, tiny_model_config as j_tiny
from cosy_tpu.infer import pipeline as JPL
from cosy_tpu_torch.config import InferenceConfig
from cosy_tpu_torch.infer import pipeline as TPL
from cosy_tpu_torch.models.flow import Flow, init_flow_params
from cosy_tpu_torch.models.hift import HiFT, init_hift_params
from cosy_tpu_torch.models.llm import TransformerLM, init_llm_params
from cosy_tpu_torch.params import from_numpy
from test_torch_common import assert_close, port_config, port_init, t
from test_torch_hift import _jax_draws
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)
FIELDS = ("mel_overlap", "hift_mel", "hift_source", "hift_speech", "flow_cache")


@pytest.fixture(scope="module")
def pair():
    jcfg = j_tiny()
    tcfg = port_config(jcfg)
    flat = {"llm": port_init(init_llm_params, jcfg.llm, 1),
            "flow": port_init(init_flow_params, jcfg.flow, 2),
            "hift": port_init(init_hift_params, jcfg.hift, 3)}
    jpipe = JPL.TTSPipeline(jcfg, *({k: jnp.asarray(v) for k, v in flat[n].items()}
                                    for n in ("llm", "flow", "hift")), finetuned_norm=True)
    mods = []
    for cls, n in ((TransformerLM, "llm"), (Flow, "flow"), (HiFT, "hift")):
        m = cls(getattr(tcfg, n), "cpu")
        m.load_state_dict(from_numpy(flat[n], "cpu"), strict=True)
        mods.append(m)
    return jcfg, jpipe, TPL.TTSPipeline(tcfg, *mods, finetuned_norm=True), mods


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (1, n)).astype(np.int32)


def _draws(jcfg, rng, T_pad, hift_frames):
    """JAX's draws of one chunk under ``rng``, as token2wav splits it."""
    k_flow, k_hift = jax.random.split(rng)
    z = t(np.asarray(jax.random.normal(k_flow, (1, 80, T_pad))))
    phase, noise = _jax_draws(k_hift, 1, jcfg.hift.nb_harmonics + 1, hift_frames * 256)
    return dict(z=z, hift_phase=phase, hift_noise=noise)


def _chunk_draws(jcfg, tpipe, rng, n_win, k, final, prompt_frames=0):
    """Draws of chunk k (a window of n_win tokens): z at the padded mel
    length (the bucket's for a bucketed final), noise at the source length
    HiFT sees (previous mel cache + this window's mel after the trim, less
    the held-back overlap unless final)."""
    mel = tpipe._mel_len(n_win)
    cache = tpipe.mel_cache_len if k else 0
    if final and 0 < n_win <= tpipe._final_tok_bucket and not prompt_frames:
        Tb = tpipe._mel_len(tpipe._final_tok_bucket)
        return _draws(jcfg, rng, Tb, cache + Tb)
    T = prompt_frames + mel
    trim = int(prompt_frames * 0.2)
    hift = cache + mel - trim - (0 if final else tpipe.mel_overlap_len)
    return _draws(jcfg, rng, T + T % 2, hift)


def _assert_state(tstate, jstate, name):
    for f in FIELDS:
        assert_close(getattr(tstate, f), np.asarray(getattr(jstate, f)), **TOL,
                     name=f"{name} {f}")


@pytest.mark.parametrize("n", [400, 320])
def test_stream_chunks_match_jax(pair, n):
    """Three 120-token windows, then the bucketed final: 100 tokens (172
    mel frames), or the shortest final a window leaves, 20 tokens (34
    frames, the whole fade window, in a bucket of 220)."""
    jcfg, jpipe, tpipe, _ = pair
    tok = _tokens(n)
    spk = np.zeros((1, 192), np.float32)
    base = jax.random.PRNGKey(n)
    jstate = JPL.StreamState(mel_overlap=np.zeros((1, 80, 0), np.float32))
    tstate = TPL.StreamState()
    plan = tpipe.stream_plan(n)
    assert len(plan) == 4 and plan[-1][1] - plan[-1][0] == n - 300
    for k, (a, b, samples) in enumerate(plan):
        final = k == len(plan) - 1
        rng = jax.random.fold_in(base, k)
        want, jstate = jpipe.token2wav(rng, tok[:, a:b], None, None, spk,
                                       stream_state=jstate, finalize=final)
        got = tpipe.token2wav(tok[:, a:b], spk, stream_state=tstate, finalize=final,
                              **_chunk_draws(jcfg, tpipe, rng, b - a, k, final))
        assert got.shape == want.shape == (1, samples)
        assert_close(got, want, **TOL, name=f"chunk {k}")
        if not final:
            _assert_state(tstate, jstate, f"chunk {k}")


def test_prompted_chunks_match_jax(pair):
    """Two windows with a 17-token / 29-frame prompt: the boundary trim and
    a flow cache of prompt region + 34 frames (63 frames) carried between
    them."""
    jcfg, jpipe, tpipe, _ = pair
    rng = np.random.default_rng(7)
    ptok = rng.integers(0, 128, (1, 17)).astype(np.int32)
    pfeat = (rng.standard_normal((1, 29, 80)) * 2 - 6).astype(np.float32)
    spk = rng.standard_normal((1, 192)).astype(np.float32)
    tok = _tokens(220, 8)
    jstate = JPL.StreamState(mel_overlap=np.zeros((1, 80, 0), np.float32))
    tstate = TPL.StreamState()
    for k, a in enumerate((0, 100)):
        key = jax.random.PRNGKey(40 + k)
        want, jstate = jpipe.token2wav(key, tok[:, a:a + 120], ptok, pfeat, spk,
                                       stream_state=jstate, finalize=False)
        got = tpipe.token2wav(tok[:, a:a + 120], spk, ptok, pfeat, stream_state=tstate,
                              finalize=False, **_chunk_draws(jcfg, tpipe, key, 120, k, False, 29))
        assert tstate.flow_cache.shape == (1, 80, 29 + 34, 2)
        assert_close(got, want, **TOL, name=f"prompted chunk {k}")
        _assert_state(tstate, jstate, f"prompted chunk {k}")


def test_bucketed_final_matches_unbucketed(pair):
    """The port's bucketed final against its own unbucketed final, the
    bucket's draws cut to the true length: equal on the valid samples
    (100 tokens: 172 mel frames, even, so the unpadded solve has no pad
    frame; see test_torch_bucket_masking)."""
    jcfg, _, tpipe, mods = pair
    plain = TPL.TTSPipeline(tpipe.cfg, *mods, InferenceConfig(bucket_final=False))
    tok = _tokens(400, 3)
    spk = np.zeros((1, 192), np.float32)
    state = TPL.StreamState()
    for k, (a, b, _) in enumerate(tpipe.stream_plan(400)[:-1]):
        tpipe.token2wav(tok[:, a:b], spk, stream_state=state, finalize=False,
                        generator=torch.Generator().manual_seed(k))
    d = _chunk_draws(jcfg, tpipe, jax.random.PRNGKey(9), 100, 3, True)
    assert d["z"].shape[2] == 220
    got = tpipe.token2wav(tok[:, 300:], spk, stream_state=copy.deepcopy(state), finalize=True,
                          **d)
    L = (20 + 172) * 256
    want = plain.token2wav(tok[:, 300:], spk, stream_state=state, finalize=True,
                           z=d["z"][:, :, :172], hift_phase=d["hift_phase"],
                           hift_noise=d["hift_noise"][:, :, :L])
    assert got.shape == want.shape == (1, L)
    assert_close(got, want, **TOL)


@pytest.mark.parametrize("n_in,n_out,valid", [(50, 34, None), (10, 34, None), (6, 34, None),
                                              (50, 34, 10), (50, 34, 40), (20000, 5120, None)])
def test_fades_match_jax(pair, n_in, n_out, valid):
    _, jpipe, tpipe, _ = pair
    window = jpipe.mel_window if n_out == 34 else jpipe.speech_window
    rng = np.random.default_rng(n_in)
    a = rng.standard_normal((1, 80, n_in)).astype(np.float32)
    b = rng.standard_normal((1, 80, n_out)).astype(np.float32)
    if valid is None:
        want = JPL.fade_in_out(a, b, window)
    else:
        want = JPL.fade_in_out_valid_jnp(jnp.asarray(a), jnp.asarray(b), window,
                                         jnp.asarray(valid))
    tw = tpipe.mel_window if n_out == 34 else tpipe.speech_window
    got = TPL.fade_in_out(t(a), t(b), tw, valid)
    assert_close(got, np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("first", [0, 1, 4, 30, 99, 150])
def test_first_hop_matches_jax(pair, first):
    jcfg, jpipe, tpipe, mods = pair
    jp = JPL.TTSPipeline(j_replace(jcfg), jpipe.llm_params, jpipe.flow_params,
                         jpipe.hift_params,
                         j_replace(JPL.InferenceConfig(), first_chunk_tokens=first))
    tp = TPL.TTSPipeline(tpipe.cfg, *mods, InferenceConfig(first_chunk_tokens=first))
    assert tp.first_hop == jp.first_hop
    assert (tp.token_min_hop_len, tp.token_overlap_len, tp.mel_overlap_len, tp.mel_cache_len,
            tp.source_cache_len, tp._final_tok_bucket) == (
        jp.token_min_hop_len, jp.token_overlap_len, jp.mel_overlap_len, jp.mel_cache_len,
        jp.source_cache_len, jp._final_tok_bucket)


def test_short_first_hop_chunks_follow_plan(pair):
    """With first_chunk_tokens = 30 the first window is 50 tokens and the
    rest keep the 100-token hop: chunk count and lengths are stream_plan's,
    for tokens fed as the decode would (growing prefixes)."""
    _, _, tpipe, mods = pair
    tp = TPL.TTSPipeline(tpipe.cfg, *mods, InferenceConfig(first_chunk_tokens=30))
    tok = _tokens(250, 5).astype(np.int64)
    producer = [(tok[:, :n], n == 250) for n in (50, 150, 250)]
    with torch.inference_mode():
        got = [w.shape[1] for w in tp.stream_token2wav(producer, np.zeros((1, 192), np.float32))]
    plan = tp.stream_plan(250)
    assert [(a, b) for a, b, _ in plan] == [(0, 50), (30, 150), (130, 250), (230, 250)]
    assert got == [s for _, _, s in plan] and all(s > 0 for s in got)


def test_stream_rejects_speed(pair):
    _, _, tpipe, _ = pair
    ids = np.asarray([[1, 2, 3]])
    with pytest.raises(ValueError):
        next(tpipe.synthesize(ids, speed=1.1, stream=True))
    state = TPL.StreamState(hift_mel=torch.zeros((1, 80, 20)))
    with pytest.raises(ValueError):
        tpipe.token2wav(_tokens(30), np.zeros((1, 192), np.float32), speed=0.9,
                        stream_state=state)


def test_streamed_tokens_equal_generate_tokens(pair):
    """Segments of one paused decode give generate_tokens' stream; the
    streamed synthesis emits stream_plan's chunks, finite."""
    _, _, tpipe, mods = pair
    tp = TPL.TTSPipeline(tpipe.cfg, *mods, InferenceConfig(min_token_text_ratio=20.0))
    ids = np.random.default_rng(2).integers(0, 256, (1, 12))
    spk = np.zeros((1, 192), np.float32)
    whole = tp.generate_tokens(ids, spk, 240, torch.Generator().manual_seed(4))
    segs = list(tp.generate_tokens_stream(ids, spk, 240, torch.Generator().manual_seed(4)))
    assert [s.shape[1] for s, _ in segs] == [120, 220, 240]
    assert [d for _, d in segs] == [False, False, True]
    assert np.array_equal(segs[-1][0], whole)
    chunks = [c["tts_speech"] for c in tp.synthesize(ids, spk_embedding=spk, max_len_cap=240,
                                                      seed=4, stream=True)]
    assert [c.shape[1] for c in chunks] == [s for _, _, s in tp.stream_plan(240)]
    assert all(np.isfinite(c).all() for c in chunks)


def test_stream_batch_equals_solo_streams(pair):
    """synthesize_stream_batch's row b yields the chunks of a solo streamed
    synthesis seeded stream_seed(seed, b, 0) (same tokens, same draws),
    flagged last only on its final chunk."""
    _, _, tpipe, mods = pair
    tp = TPL.TTSPipeline(tpipe.cfg, *mods, InferenceConfig(min_token_text_ratio=20.0))
    texts = [np.random.default_rng(30 + b).integers(0, 256, (1, n)) for b, n in enumerate((3, 7, 5))]
    got = {b: [] for b in range(3)}
    lasts = {b: [] for b in range(3)}
    for b, wav, last in tp.synthesize_stream_batch(texts, seed=3):
        got[b].append(wav)
        lasts[b].append(last)
    for b, ids in enumerate(texts):
        want = [c["tts_speech"] for c in tp.synthesize(
            ids, spk_embedding=np.zeros((1, 192), np.float32), seed=TPL.stream_seed(3, b, 0),
            stream=True)]
        assert len(got[b]) == len(want) == len(tp.stream_plan(20 * ids.shape[1]))
        assert lasts[b] == [False] * (len(want) - 1) + [True]
        for g, w in zip(got[b], want):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


def test_cli_stream_tiny_cpu(tmp_path, capsys):
    from cosy_tpu_torch.infer.__main__ import main

    out = tmp_path / "out.wav"
    main(["--text", "hello there", "--tiny", "--device", "cpu", "--pretrained", str(tmp_path),
          "--output", str(out), "--stream"])
    printed = capsys.readouterr().out
    assert "first chunk after" in printed and out.stat().st_size > 44
