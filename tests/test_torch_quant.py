"""Weight-only int8 in the port against the JAX package (CPU, f32):
``quantize_int8`` / ``count_quantized`` (int8 values and ``@scale``
siblings exactly equal), ``dense`` on an int8 weight (with and without a
LoRA delta) and a Qwen2 forward over quantized weights at 1e-5, the 300M
decode step's int8 view against JAX's stacked ``wqkv`` / ``linear_out`` /
``w_1`` / ``w_2`` (exact), the int8 decode's per-step log-probs and tokens
against JAX's ``llm_decode(int8_weights=True)`` with and without a voice's
adapters (the same Gumbel uniforms injected into both samplers; 1e-5,
tokens equal) and their gap to the full-precision decode, every
``TTSPipeline`` decode route on the int8 step, ``TTS2Pipeline``'s
quantized Qwen2 dict, ``validate_int8_voice``, ``mcd`` on
tests/test_mcd.py's inputs, and the refusal of an int8 weight under
tensor parallelism."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import EncoderConfig as JEnc, LLMConfig as JLLM, replace as jreplace
from cosy_tpu.ctx import Ctx as JCtx
from cosy_tpu.layers import qwen2 as JQ
from cosy_tpu.layers.basic import dense as j_dense
from cosy_tpu.models import llm as JL
from cosy_tpu.ops import mcd as JM
from cosy_tpu.params import P as JP
from cosy_tpu.quant import count_quantized as j_count, quantize_int8 as j_quantize
from cosy_tpu_torch import quant as TQT
from cosy_tpu_torch.config import InferenceConfig
from cosy_tpu_torch.ctx import Ctx
from cosy_tpu_torch.infer.engine import ContinuousBatchEngine
from cosy_tpu_torch.infer.pipeline import TTSPipeline
from cosy_tpu_torch.layers import qwen2 as TQ
from cosy_tpu_torch.layers.basic import dense
from cosy_tpu_torch.models import llm as TL
from cosy_tpu_torch.ops import mcd as TM
from cosy_tpu_torch.parallel.tp import tensor_parallel
from cosy_tpu_torch.params import P, Spec, spec_tensors
from test_torch_common import port_config, port_init, port_modules, tiny_flats
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=1e-5, rtol=1e-5)
QCFG = TQ.Qwen2Config(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, head_dim=8, vocab_size=100)
J_QCFG = JQ.Qwen2Config(**QCFG.__dict__)
# the tiny LLM of tests/test_parity.py:286 (test_llm_decode_int8_weights_smoke)
_ENC = JEnc(input_size=16, output_size=16, attention_heads=2, linear_units=24, num_blocks=2)
J_LCFG = JLLM(text_encoder_input_size=16, llm_input_size=16, llm_output_size=16,
              text_token_size=40, speech_token_size=30, spk_embed_dim=12,
              text_encoder=jreplace(_ENC, static_chunk_size=1),
              llm=jreplace(_ENC, static_chunk_size=1, input_layer="linear_legacy"))
T_LCFG = port_config(J_LCFG)
DECODE_MODS = ("self_attn.linear_q", "self_attn.linear_k", "self_attn.linear_v",
               "self_attn.linear_out", "feed_forward.w_1", "feed_forward.w_2")


@pytest.fixture(scope="module")
def qwen():
    """Seeded Qwen2 weights (the port's initializers) as a flat numpy dict."""
    spec = TQ.qwen2_spec(Spec(), QCFG)
    return {k: v.numpy() for k, v in spec_tensors(spec, "cpu",
                                                  torch.Generator().manual_seed(0)).items()}


@pytest.fixture(scope="module")
def lm():
    return port_init(TL.init_llm_params, J_LCFG, seed=3)


def _jq(flat, prefix=""):
    """JAX's ``quantize_int8`` of a numpy dict, run eagerly as the JAX
    pipelines run it.  (Under ``jax.jit`` XLA turns the division by 127
    into a product with its reciprocal, which moves a few scales by one
    ulp: the jitted 300M decode is held to the port at 1e-5 below.)"""
    return j_quantize({k: jnp.asarray(v) for k, v in flat.items()}, prefix=prefix)


@pytest.fixture(scope="module")
def jq_qwen(qwen):
    return _jq(qwen)


def _port(flat):
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _assert_same_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_quantized_dict_equals_jax(qwen, jq_qwen):
    want = jq_qwen
    got = TQT.quantize_int8(_port(qwen))
    _assert_same_dict(got, want)
    assert TQT.count_quantized(got) == j_count(want) == 7 * QCFG.num_hidden_layers
    # the prefix filter
    pre = "model.layers.1."
    _assert_same_dict(TQT.quantize_int8(_port(qwen), prefix=pre), _jq(qwen, pre))


def test_decode_step_view_equals_jax_stacked_int8(lm):
    """The six matrices of every block in the port's step view against
    JAX's ``_stack_decode_layers(int8_weights=True)`` run eagerly: the
    fused ``wqkv`` rows are linear_q's, then k's, then v's."""
    step = TL.quantize_decode_step(P(_port(lm)), T_LCFG).d
    nl = J_LCFG.llm.num_blocks
    assert TQT.count_quantized(step) == 6 * nl
    st = JL._stack_decode_layers(JP({k: jnp.asarray(v) for k, v in lm.items()}).sub("llm"),
                                 nl, True)
    for name, parts in (("wqkv", DECODE_MODS[:3]), ("self_attn.linear_out.weight", DECODE_MODS[3:4]),
                        ("feed_forward.w_1.weight", DECODE_MODS[4:5]),
                        ("feed_forward.w_2.weight", DECODE_MODS[5:])):
        for suffix in ("", "@scale"):
            want = np.asarray(st[name + suffix])
            got = np.stack([np.concatenate([step[f"llm.encoders.{i}.{m}.weight{suffix}"].numpy()
                                            for m in parts]) for i in range(nl)])
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name + suffix)
    # the prefill's weights, the positional keys and the text encoder stay full precision
    assert step["llm.encoders.0.self_attn.linear_pos.weight"].dtype == torch.float32
    assert step["text_encoder.encoders.0.self_attn.linear_q.weight"].dtype == torch.float32


@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
def test_dense_int8_matches_jax(qwen, jq_qwen, lora):
    rng = np.random.default_rng(1)
    name = "model.layers.0.self_attn.q_proj"
    q = jq_qwen
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jctx, tctx = None, Ctx()
    if lora:
        ad = {name + ".lora_A": rng.standard_normal((2, 32)).astype(np.float32),
              name + ".lora_B": rng.standard_normal((32, 2)).astype(np.float32)}
        jctx = JCtx(lora={k: jnp.asarray(v) for k, v in ad.items()}, lora_scale=2.0)
        tctx = Ctx(lora=_port(ad), lora_scale=2.0)
    want = j_dense(JP(q), name, jnp.asarray(x), *([jctx] if jctx else []))
    got = dense(P(TQT.quantize_int8(_port(qwen))), name, torch.from_numpy(x), tctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = dense(P(_port(qwen)), name, torch.from_numpy(x), tctx)
    assert (got - full).abs().max() > 1e-4  # the weights really were rounded


def test_qwen2_forward_int8_matches_jax(qwen, jq_qwen):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    lens = np.array([6, 4])
    want = jax.jit(lambda d, a, n: JQ.qwen2_forward(JP(d).sub("model"), J_QCFG, a, n))(
        jq_qwen, jnp.asarray(x), jnp.asarray(lens))
    got = TQ.qwen2_forward(P(TQT.quantize_int8(_port(qwen))).sub("model"), QCFG,
                           torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want)[0], **TOL)
    np.testing.assert_allclose(got.numpy()[1, :4], np.asarray(want)[1, :4], **TOL)


class _Mesh:
    """A model axis of 2 without a process group: the split products run
    with identity collectives on one rank's view of the whole weight."""

    def group(self, axis):
        return None

    def size(self, axis):
        return 2


@pytest.mark.parametrize("name, axis", [("model.layers.0.mlp.up_proj", 0),
                                        ("model.layers.0.mlp.down_proj", 1)])
def test_int8_weight_under_tensor_parallel_equals_unsplit(qwen, name, axis):
    """An int8 weight under a tensor-parallel layout once raised; it now runs
    the split product with its scales (a row split takes this rank's rows
    of them, a column split scales after the sum) and the bias after them:
    with identity collectives it equals the unsplit int8 product exactly.
    The two-rank products are held to one process in
    tests/test_torch_parallel.py."""
    q = TQT.quantize_int8(_port(qwen))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, q[name + ".weight"].shape[1])).astype(np.float32))
    want = dense(P(q), name, x)
    with tensor_parallel(_Mesh(), {name + ".weight": axis}):
        got = dense(P(q), name, x)
    assert torch.equal(got, want)


def _voice_adapters(lm, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(J_LCFG.llm.num_blocks):
        for m in DECODE_MODS:
            w = lm[f"llm.encoders.{i}.{m}.weight"]
            out[f"llm.encoders.{i}.{m}.lora_A"] = rng.standard_normal((2, w.shape[1])
                                                                      ).astype(np.float32)
            out[f"llm.encoders.{i}.{m}.lora_B"] = 0.3 * rng.standard_normal((w.shape[0], 2)
                                                                            ).astype(np.float32)
    return out


def _gumbel(n, v, seed=5):
    return -np.log(-np.log(np.random.default_rng(seed).uniform(1e-6, 1 - 1e-6, (n, v))))


def _jax_decode(lm, prefix, gumbel, monkeypatch, lora=None):
    """JAX's int8 decode with its sampler replaced by Gumbel-max over the
    injected uniforms; returns (tokens, the log-probs of every step)."""
    rec = []
    g = jnp.asarray(gumbel, jnp.float32)

    def pick(rng, logp, decoded, n, *a):
        jax.debug.callback(lambda x: rec.append(np.array(x)), logp, ordered=True)
        return jnp.argmax(logp + g[n]).astype(jnp.int32)

    monkeypatch.setattr(JL, "ras_sample", pick)
    kw = {} if lora is None else dict(lora={k: jnp.asarray(v) for k, v in lora.items()},
                                      lora_scale=2.0)
    res = jax.jit(lambda p, x, lo: JL.llm_decode(
        JP(p), J_LCFG, jax.random.PRNGKey(2), x, prefix.shape[1], jnp.asarray(2), 12,
        int8_weights=True, **lo))({k: jnp.asarray(v) for k, v in lm.items()},
                                  jnp.asarray(prefix), kw)
    jax.effects_barrier()
    return list(np.asarray(res.tokens)[:int(res.length)]), rec


def _port_decode(lm, prefix, gumbel, monkeypatch, step_p, lora=None):
    rec = []

    def pick(logp, decoded, *a, **k):
        rec.append(logp.numpy().copy())
        return int(np.argmax(logp.numpy() + gumbel[len(decoded)].astype(np.float32)))

    monkeypatch.setattr(TL, "ras_sample", pick)
    p = P(_port(lm))
    kw = {} if lora is None else dict(lora=_port(lora), lora_scale=2.0)
    toks = TL.llm_decode(p, T_LCFG, torch.from_numpy(prefix), 2, 12,
                         step_p=TL.quantize_decode_step(p, T_LCFG) if step_p else None, **kw)
    return toks, rec


@pytest.mark.parametrize("voiced", [False, True], ids=["base", "voice"])
def test_int8_decode_logits_match_jax(lm, monkeypatch, voiced):
    """Every step's log-probs (the prefill's, full precision in both, and
    the int8 steps') at 1e-5 and the tokens equal; the full-precision
    decode's first step differs, so the int8 view is not a no-op.  With a
    voice, its adapters add their deltas on top of the int8 products."""
    prefix = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 7, 16)))
    gumbel = _gumbel(13, J_LCFG.speech_token_size + 1)
    lora = _voice_adapters(lm, 9) if voiced else None
    want_tok, want = _jax_decode(lm, prefix, gumbel, monkeypatch, lora)
    got_tok, got = _port_decode(lm, prefix, gumbel, monkeypatch, True, lora)
    assert got_tok == want_tok and len(got_tok) >= 2
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {i}")
    _, full = _port_decode(lm, prefix, gumbel, monkeypatch, False, lora)
    np.testing.assert_allclose(full[0], got[0], **TOL)  # the same prefill
    fin = np.isfinite(got[1])
    assert np.abs(full[1][fin] - got[1][fin]).max() > 1e-4


@pytest.fixture(scope="module")
def pipes():
    from cosy_tpu.config import tiny_model_config as j_tiny

    jcfg = j_tiny()
    tcfg = port_config(jcfg)
    mods = port_modules(tcfg, tiny_flats(jcfg, seed=50))
    icfg = InferenceConfig(max_token_text_ratio=4.0)
    return tcfg, mods, {q: TTSPipeline(tcfg, *mods, InferenceConfig(
        max_token_text_ratio=4.0, int8_decode=q)) for q in (False, True)}, icfg


def _steps(monkeypatch):
    """Records the weights every decode step reads."""
    seen = []
    real = TL.llm_decode_step_batch

    def spy(p, *a, **k):
        seen.append(p.d)
        return real(p, *a, **k)

    monkeypatch.setattr(TL, "llm_decode_step_batch", spy)
    return seen


def test_every_decode_route_runs_the_int8_step(pipes, monkeypatch):
    """Solo, streamed, batched and engine-admitted decodes of an
    ``int8_decode`` pipeline all step on its int8 view (84 int8 weights at
    14 blocks; 12 here), and the solo tokens equal ``llm_decode`` on that
    view."""
    tcfg, _, by_q, _ = pipes
    pipe = by_q[True]
    assert TQT.count_quantized(pipe.llm_step_p.d) == 6 * tcfg.llm.llm.num_blocks
    assert by_q[False].llm_step_p is by_q[False].llm_p
    seen = _steps(monkeypatch)
    ids = np.random.default_rng(3).integers(1, 200, (1, 4))
    spk = np.zeros((1, 192), np.float32)
    solo = pipe.generate_tokens(ids, spk, 64, torch.Generator().manual_seed(1))
    for _ in pipe.generate_tokens_stream(ids, spk, 64, torch.Generator().manual_seed(1)):
        pass
    pipe._decode_batch([ids, ids[:, :2]], [spk, spk], 64, seed=0).run()
    n_direct = len(seen)
    eng = ContinuousBatchEngine(pipe, slots=2, prefix_len=32, max_len=64)
    try:
        req = eng.submit(ids[:, :2], seed=1)
        list(req.chunks(timeout=120))
    finally:
        eng.stop()
    assert len(seen) > n_direct > 0
    assert all(d is pipe.llm_step_p.d for d in seen)
    prefix, min_len, max_len = pipe._build_prefix(ids, None, None, spk, 64, None)
    want = TL.llm_decode(pipe.llm_p, tcfg.llm, prefix, min_len, max_len,
                         generator=torch.Generator().manual_seed(1), step_p=pipe.llm_step_p,
                         **pipe._sampling())
    assert list(solo[0]) == want


def test_tts2_pipeline_quantizes_every_qwen2_projection():
    """``TTS2Pipeline(int8_decode=True)`` reads JAX's quantized dict."""
    from cosy_tpu_torch.infer.pipeline2 import TTS2Pipeline
    from cosy_tpu_torch.models.flow2 import init_flow2_params
    from cosy_tpu_torch.models.hift import init_hift_params
    from cosy_tpu_torch.models.qwen2lm import init_qwen2lm_params
    from test_torch_cv2 import FCFG, HCFG, LCFG

    mods = (init_qwen2lm_params(LCFG, "cpu", seed=1), init_flow2_params(FCFG, "cpu", seed=2),
            init_hift_params(HCFG, "cpu", seed=3))
    pipe = TTS2Pipeline(LCFG, FCFG, HCFG, *mods, InferenceConfig(int8_decode=True))
    flat = {k: v.detach().numpy() for k, v in mods[0].state_dict().items()}
    _assert_same_dict(pipe.llm_p.d, _jq(flat))
    assert TQT.count_quantized(pipe.llm_p.d) == 7 * LCFG.qwen.num_hidden_layers


def test_validate_int8_voice(pipes):
    """The harness over two prompts and two seeds: a well-formed report;
    identical token streams give an MCD of exactly 0."""
    tcfg, mods, _, icfg = pipes
    texts = [np.random.default_rng(s).integers(1, 200, (1, 3)) for s in (4, 5)]
    rep = TQT.validate_int8_voice(tcfg, *mods, icfg, texts, seeds=(0, 1), max_len_cap=24)
    assert len(rep["prompts"]) == 4
    for r in rep["prompts"]:
        assert 0.0 <= r["agreement"] <= 1.0 and r["mcd_db"] >= 0.0
        assert r["tokens_full"] > 0 and r["tokens_int8"] > 0
        if r["agreement"] == 1.0:
            assert r["mcd_db"] == 0.0
    assert rep["agreement_min"] <= rep["agreement_mean"] <= 1.0
    assert rep["mcd_db_max"] == max(r["mcd_db"] for r in rep["prompts"])


def _fake_log_mel(T=80, M=80, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6, T)[:, None]
    f = np.linspace(0, 3, M)[None, :]
    return np.sin(t + f) + 0.1 * rng.standard_normal((T, M)) - 6.0


def test_mcd_equals_jax():
    """tests/test_mcd.py's inputs through both packages: equal."""
    x = _fake_log_mel()
    noise = np.random.default_rng(1).standard_normal(x.shape)
    idx = np.sort(np.concatenate([np.arange(80), np.arange(0, 80, 4)]))
    for a, b in ((x, x), (x, x + 0.05 * noise), (x, x + 0.5 * noise), (x, x[idx])):
        for align in (True, False):
            assert TM.mcd(a, b, align=align) == JM.mcd(a, b, align=align)
    np.testing.assert_array_equal(TM.mel_to_cepstra(x + 3.0, 13), JM.mel_to_cepstra(x + 3.0, 13))
    assert TM.mcd(x, x) < 1e-9
    assert TM.mcd(x, x[idx], align=True) < TM.mcd(x, x[idx], align=False)
