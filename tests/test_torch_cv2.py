"""CosyVoice2 synthesis in the port (causal flow, 24 kHz HiFT, TTS2Pipeline)
on the CPU against the torch-recorded goldens and the JAX package, at the
tiny configs of tests/test_pipeline2.py: the ``upsample_encoder`` golden
with and without context and in streaming, the ``causal_decoder`` golden,
the streaming estimator with a masked chunk bias against JAX, the fixed
noise bit-equal to JAX's, ``flow2_inference`` against JAX (prompted, a
non-final window with its lookahead context, the length-masked bucket),
``token2wav`` against the JAX pipeline for two streaming windows and the
bucketed final given the same tokens and HiFT draws, ``synthesize`` and
``synthesize_batch`` end to end, and the full-width trees' keys and shapes.
Tolerance 2e-4 (goldens and modules), exact for tokens and the noise."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu import config as JC
from cosy_tpu.ctx import EVAL
from cosy_tpu.infer import pipeline2 as JP2
from cosy_tpu.layers.qwen2 import Qwen2Config as JQwen2Config
from cosy_tpu.layers.unet import conditional_decoder as j_decoder
from cosy_tpu.models import flow2 as JF2
from cosy_tpu.models import hift as JH
from cosy_tpu.models import qwen2lm as JLM
from cosy_tpu.params import P as JP
from cosy_tpu_torch import config as TC
from cosy_tpu_torch.infer import pipeline2 as TP2
from cosy_tpu_torch.layers.qwen2 import Qwen2Config
from cosy_tpu_torch.layers.unet import conditional_decoder as t_decoder
from cosy_tpu_torch.layers.upsample_encoder import upsample_encoder_forward
from cosy_tpu_torch.models import flow2 as TF2
from cosy_tpu_torch.models.hift import HiFT, init_hift_params
from cosy_tpu_torch.models.qwen2lm import Qwen2LM, Qwen2LMConfig, init_qwen2lm_params
from cosy_tpu_torch.params import P as TP, from_numpy
from golden_seed import seeded_param
from test_torch_common import GOLDEN_DIR, assert_close, t
from test_torch_hift import _jax_draws
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)

LCFG = Qwen2LMConfig(llm_input_size=32, llm_output_size=32, speech_token_size=30,
                     qwen=Qwen2Config(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                      num_attention_heads=4, num_key_value_heads=2,
                                      head_dim=8, vocab_size=50))
FCFG = TF2.Flow2Config(
    input_size=16, output_size=80, spk_embed_dim=12, vocab_size=33,
    encoder=TC.EncoderConfig(input_size=16, output_size=16, attention_heads=2,
                             linear_units=24, num_blocks=1, static_chunk_size=4),
    num_up_blocks=1,
    estimator=TC.EstimatorConfig(in_channels=320, out_channels=80, channels=(12, 12),
                                 attention_head_dim=4, n_blocks=1, num_mid_blocks=1,
                                 num_heads=2),
    decoder_static_chunk_size=4)
HCFG = TC.HiFTConfig(
    in_channels=80, base_channels=16, nb_harmonics=2, upsample_rates=(8, 8),
    upsample_kernel_sizes=(16, 16), istft_n_fft=16, istft_hop_len=4,
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    source_resblock_kernel_sizes=(3, 3), source_resblock_dilation_sizes=((1,), (1,)),
    f0_predictor_cond_channels=8)
HOP = 256
JMODULES = {"Qwen2LMConfig": JLM.Qwen2LMConfig, "Qwen2Config": JQwen2Config,
            "Flow2Config": JF2.Flow2Config}


def jax_config(cfg):
    """The JAX package's copy of a port config dataclass."""
    name = type(cfg).__name__
    cls = JMODULES.get(name) or getattr(JC, name)
    return cls(**{f.name: jax_config(getattr(cfg, f.name))
                  if dataclasses.is_dataclass(getattr(cfg, f.name)) else getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def _golden(name):
    """(port params, ins, outs) of a golden, seeded parameters rebuilt."""
    blob = np.load(f"{GOLDEN_DIR}/{name}.npz")
    params, ins, outs = {}, {}, {}
    for k in blob.files:
        kind, key = k.split(":", 1)
        if kind == "param":
            params[key] = blob[k].astype(np.float32)
        elif kind == "pshape":
            params[key] = seeded_param(key, blob[k])
        elif kind == "in":
            ins[key] = blob[k]
        else:
            outs[key] = blob[k]
    return TP(from_numpy(params, "cpu")), ins, outs


UP_CFG = TC.EncoderConfig(input_size=512, output_size=512, attention_heads=8, linear_units=64,
                          num_blocks=1, dropout_rate=0.0, positional_dropout_rate=0.0,
                          attention_dropout_rate=0.0, static_chunk_size=25,
                          layer_norm_eps=1e-12)


@pytest.mark.parametrize("case", ["full", "stream", "context"])
def test_upsample_encoder_golden(case):
    p, ins, outs = _golden("upsample_encoder")
    y, _ = upsample_encoder_forward(
        p, UP_CFG, t(ins["x"]), torch.as_tensor(ins["lens"]), streaming=case == "stream",
        context=t(ins["context"]) if case == "context" else None)
    assert_close(y, outs[{"full": "y", "stream": "y_stream", "context": "y_ctx"}[case]], **TOL)


@pytest.mark.parametrize("streaming", [False, True], ids=["full", "stream"])
def test_causal_decoder_golden(streaming):
    p, ins, outs = _golden("causal_decoder")
    cfg = TC.EstimatorConfig(in_channels=24, out_channels=6, channels=(16, 16), dropout=0.0,
                             attention_head_dim=4, n_blocks=1, num_mid_blocks=1, num_heads=2,
                             act_fn="gelu")
    y = t_decoder(p, cfg, *(t(ins[k]) for k in ("x", "mask", "mu", "t", "spks", "cond")),
                  causal=True, streaming=streaming, static_chunk_size=4)
    assert_close(y, outs["y_stream" if streaming else "y"], **TOL)


@pytest.fixture(scope="module")
def cv2():
    """Tiny CosyVoice2 weights from the port's inits; both pipelines."""
    mods = (init_qwen2lm_params(LCFG, "cpu", seed=1), TF2.init_flow2_params(FCFG, "cpu", seed=2),
            init_hift_params(HCFG, "cpu", seed=3))
    flat = [{k: v.numpy() for k, v in m.state_dict().items()} for m in mods]
    icfg = TC.InferenceConfig(nfe_short=2)
    jpipe = JP2.TTS2Pipeline(jax_config(LCFG), jax_config(FCFG), jax_config(HCFG),
                             *({k: jnp.asarray(v) for k, v in f.items()} for f in flat),
                             jax_config(icfg), hop_samples=HOP)
    tpipe = TP2.TTS2Pipeline(LCFG, FCFG, HCFG, *mods, icfg, hop_samples=HOP)
    return jpipe, tpipe, flat


def test_streaming_estimator_with_a_masked_chunk_bias_matches_jax(cv2):
    """The causal estimator with a mask and the static-chunk bias, whose
    pad rows past every valid key of their chunk see all keys (the "dead
    row" rule), against JAX: 2e-4."""
    _, tpipe, flat = cv2
    rng = np.random.default_rng(4)
    B, T = 2, 20
    x, mu, cond = (rng.standard_normal((B, 80, T)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((B, 80)).astype(np.float32)
    tt = rng.uniform(size=(B,)).astype(np.float32)
    mask = np.ones((B, 1, T), np.float32)
    mask[1, :, 9:] = 0.0
    jp = {k: jnp.asarray(v) for k, v in flat[1].items()}
    jest = jax_config(FCFG).estimator
    want = jax.jit(lambda p, *a: j_decoder(JP(p).sub("decoder.estimator"), jest, *a, EVAL,
                                           causal=True, streaming=True, static_chunk_size=4))(
        jp, *(jnp.asarray(a) for a in (x, mask, mu, tt, spks, cond)))
    got = t_decoder(tpipe.flow_p.sub("decoder.estimator"), FCFG.estimator,
                    *(t(a) for a in (x, mask, mu, tt, spks, cond)), causal=True,
                    streaming=True, static_chunk_size=4)
    assert_close(got, np.asarray(want), **TOL)


def test_fixed_noise_is_the_reference_buffer():
    got = TF2.fixed_noise()
    assert got.shape == (1, 80, 15000) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), JF2.fixed_noise(80))
    assert TF2.fixed_noise() is got  # cached


FLOW_CASES = ["prompted", "window_with_context", "bucket"]


@pytest.mark.parametrize("case", FLOW_CASES)
def test_flow2_inference_matches_jax(cv2, case):
    """A prompted whole utterance; a non-final streaming window, whose last
    3 tokens enter as the encoder's lookahead context; and the length-masked
    bucket (10 tokens in 16), which also equals the unpadded solve."""
    _, tpipe, flat = cv2
    rng = np.random.default_rng(FLOW_CASES.index(case))
    tok = rng.integers(0, 33, (1, 10))
    spk = rng.standard_normal((1, 12)).astype(np.float32)
    ptok, pfeat = np.zeros((1, 0), np.int64), np.zeros((1, 0, 80), np.float32)
    kw = dict(n_timesteps=2)
    if case == "prompted":
        ptok, pfeat = rng.integers(0, 33, (1, 4)), rng.standard_normal((1, 8, 80)).astype(np.float32)
    elif case == "window_with_context":
        kw.update(finalize=False, streaming=True)
    else:
        tok = np.concatenate([tok, np.zeros((1, 6), np.int64)], axis=1)
        kw.update(token_valid=10)
    jp = {k: jnp.asarray(v) for k, v in flat[1].items()}
    jcfg = jax_config(FCFG)
    jkw = dict(kw, token_valid=jnp.asarray(10)) if "token_valid" in kw else kw
    want = jax.jit(lambda p, *a: JF2.flow2_inference(JP(p), jcfg, *a, **jkw))(
        jp, *(jnp.asarray(a) for a in (tok, ptok, pfeat, spk)))
    got = TF2.flow2_inference(tpipe.flow_p, FCFG, *(torch.as_tensor(a) for a in (tok, ptok, pfeat,
                                                                             spk)), **kw)
    frames = {"prompted": 20, "window_with_context": 14, "bucket": 32}[case]
    assert got.shape == (1, 80, frames)
    assert_close(got, np.asarray(want), **TOL)
    if case == "bucket":
        solo = TF2.flow2_inference(tpipe.flow_p, FCFG, torch.as_tensor(tok[:, :10]),
                                   *(torch.as_tensor(a) for a in (ptok, pfeat, spk)), n_timesteps=2)
        assert_close(got[:, :, :20], solo, **TOL)
        assert not got[:, :, 20:].any()


def test_sampler_and_int8_options_that_are_not_ported_raise(cv2):
    """An unknown sampler and a step count below 1 raise; the MeanFlow
    sampler (ported, tests/test_torch_distill.py) is refused on weights
    without the distilled branch.  int8 decode is ported (A16): it is
    taken, and quantizes the seven projections of every Qwen2 block
    (tests/test_torch_quant.py holds the values to JAX's)."""
    _, tpipe, _ = cv2
    args = (tpipe.flow_p, FCFG, torch.zeros((1, 4), dtype=torch.long),
            torch.zeros((1, 0), dtype=torch.long), torch.zeros((1, 0, 80)), torch.zeros((1, 12)))
    with pytest.raises(ValueError, match="unknown sampler"):
        TF2.flow2_inference(*args, sampler="heun")
    with pytest.raises(ValueError, match=">= 1"):
        TF2.flow2_inference(*args, sampler="meanflow", n_timesteps=0)
    mods = (Qwen2LM(LCFG, "meta"), TF2.Flow2(FCFG, "meta"), HiFT(HCFG, "meta"))
    with pytest.raises(ValueError, match="MeanFlow-distilled"):
        TP2.TTS2Pipeline(LCFG, FCFG, HCFG, *mods, TC.InferenceConfig(sampler="meanflow"))
    q = TP2.TTS2Pipeline(LCFG, FCFG, HCFG, *mods, TC.InferenceConfig(int8_decode=True))
    assert sum(v.dtype == torch.int8 for v in q.llm_p.d.values()) == 7 * LCFG.qwen.num_hidden_layers


def _state_np(st):
    return {f: getattr(st, f) for f in ("hift_mel", "hift_source", "hift_speech")}


def test_token2wav_stream_windows_and_bucketed_final_match_jax(cv2):
    """Windows of 28 and 53 cumulative tokens (offsets 0 and 25) with their
    HiFT carries, then the bucketed final of 60 tokens from offset 50, each
    with JAX's HiFT draws injected at the source length HiFT sees: every
    wav and carry at 2e-4."""
    jpipe, tpipe, _ = cv2
    rng = np.random.default_rng(9)
    tok = rng.integers(0, 30, (1, 60)).astype(np.int32)
    spk = rng.standard_normal((1, 12)).astype(np.float32)
    base = jax.random.PRNGKey(3)
    jstate, tstate = JP2.Stream2State(), TP2.Stream2State()
    H = HCFG.nb_harmonics + 1
    plan = [(28, 0, 50, False), (53, 25, 58, False), (60, 50, 72, True)]  # n, offset, frames
    for k, (n, off, frames, final) in enumerate(plan):
        key = jax.random.fold_in(base, k)
        want, jstate = jpipe.token2wav(key, tok[:, :n], None, None, spk, off, jstate,
                                       stream=not final, finalize=final)
        phase, noise = _jax_draws(key, 1, H, frames * HOP)
        got, tstate = tpipe.token2wav(tok[:, :n], None, None, spk, off, tstate,
                                      stream=not final, finalize=final, hift_phase=phase,
                                      hift_noise=noise)
        assert got.shape == np.asarray(want).shape, k
        assert_close(got, np.asarray(want), **TOL, name=f"chunk {k}")
        if not final:
            for f, v in _state_np(tstate).items():
                assert_close(v, np.asarray(getattr(jstate, f)), **TOL, name=f"{k} {f}")
    assert tstate is None and got.shape == (1, (60 - 50) * 2 * HOP + 8 * HOP)


def test_synthesize_whole_and_streamed(cv2):
    """Whole-utterance and streamed synthesis of the same decode: the
    streamed chunks add up to the whole utterance's length (every token's
    two mel frames once), the first chunk leaves after one hop of
    tokens, and the tokens equal the solo decode's."""
    _, tpipe, _ = cv2
    text = np.asarray([[3, 8, 14, 2, 9, 40, 7]])
    whole = list(tpipe.synthesize(text, seed=5, max_len_cap=64))
    toks = tpipe.generate_tokens(text, max_len_cap=64, generator=tpipe._decode_generator(5, 0))
    n = toks.shape[1]
    assert len(whole) == 1 and whole[0]["tts_speech"].shape == (1, n * 2 * HOP)
    assert set(tpipe.stage_seconds) == {"decode", "flow", "hift"}
    chunks = [c["tts_speech"] for c in tpipe.synthesize(text, seed=5, max_len_cap=64,
                                                        stream=True)]
    assert sum(c.shape[1] for c in chunks) == n * 2 * HOP
    assert n >= 28 and len(chunks) == (n - 3) // 25 + 1  # windows, then the final
    assert chunks[0].shape[1] == (50 - 8) * HOP
    assert all(np.isfinite(c).all() for c in chunks)
    streamed = [tk for tk, _ in tpipe.generate_tokens_stream(
        text, max_len_cap=64, generator=tpipe._decode_generator(5, 0))][-1]
    assert np.array_equal(streamed, toks)


def test_synthesize_prompted_and_voice_conversion(cv2):
    """A flow prompt (6 tokens, 12 frames) with an LLM prompt, streamed (the
    first hop padded to end the prompt on a hop boundary), and voice
    conversion from given source tokens."""
    _, tpipe, _ = cv2
    rng = np.random.default_rng(2)
    kw = dict(prompt_text=np.asarray([[4, 5]]), llm_prompt_speech_token=rng.integers(0, 30, (1, 6)),
              flow_prompt_speech_token=rng.integers(0, 30, (1, 6)),
              prompt_feat=rng.standard_normal((1, 12, 80)).astype(np.float32),
              flow_embedding=rng.standard_normal((1, 12)).astype(np.float32))
    chunks = [c["tts_speech"] for c in tpipe.synthesize(np.asarray([[3, 8, 14]]), stream=True,
                                                        seed=1, max_len_cap=60, **kw)]
    assert all(np.isfinite(c).all() and c.shape[1] > 0 for c in chunks)
    src = rng.integers(0, 30, (1, 40))
    vc = next(tpipe.synthesize(source_speech_token=src, flow_embedding=kw["flow_embedding"]))
    assert vc["tts_speech"].shape == (1, 40 * 2 * HOP)


def test_synthesize_batch_rows_equal_solo_decodes(cv2):
    _, tpipe, _ = cv2
    texts = [np.asarray([[3, 8, 14, 2]]), np.asarray([[9, 1]]), np.asarray([[5, 6, 7, 8, 9, 10]])]
    rows = tpipe.decode_batch(texts, max_len_cap=48, seed=11)
    solo = [tpipe.generate_tokens(tx, max_len_cap=48,
                                  generator=tpipe._decode_generator(11, b))[0].tolist()
            for b, tx in enumerate(texts)]
    assert rows == solo and any(rows)
    wavs = tpipe.synthesize_batch(texts, max_len_cap=48, seed=11)
    assert [w.shape[1] for w in wavs] == [len(r) * 2 * HOP for r in rows]


@pytest.mark.parametrize("part", ["llm", "flow", "hift"])
def test_full_width_key_and_shape_equality(part):
    """Qwen2LMConfig() (Qwen2-0.5B), Flow2Config() and the 24 kHz HiFT:
    JAX init shapes through jax.eval_shape against the port's modules on
    the meta device."""
    if part == "llm":
        jinit, tree = (lambda k: JLM.init_qwen2lm_params(k, JLM.Qwen2LMConfig())), \
            Qwen2LM(Qwen2LMConfig(), "meta")
    elif part == "flow":
        jinit, tree = (lambda k: JF2.init_flow2_params(k, JF2.Flow2Config())), \
            TF2.Flow2(TF2.Flow2Config(), "meta")
    else:
        hcfg = TP2.hift24k_config()
        jinit, tree = (lambda k: JH.init_hift_params(k, jax_config(hcfg))), HiFT(hcfg, "meta")
    want = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    got = tree.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
