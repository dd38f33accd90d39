"""The port's speech-token LLM against the JAX package (CPU): the text
encoder and prefix logits; the KV-cache decode step, teacher-forced, against
JAX's full causal forward at every position (which catches an off-by-one in
the S-1-L positional window); the RAS sampler's rule with injected
uniforms.  Tolerance 2e-4 for whole modules."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.ctx import EVAL
from cosy_tpu.layers.basic import dense as j_dense, layer_norm as j_ln
from cosy_tpu.layers.conformer import transformer_layer as j_layer
from cosy_tpu.layers.posenc import rel_pos_table as j_table
from cosy_tpu.models import llm as JL
from cosy_tpu.ops.masks import NEG_BIAS
from cosy_tpu.params import P as JP
from cosy_tpu_torch.models import llm as TL
from cosy_tpu_torch.ops import sampling as TS
from test_torch_common import assert_close, port_config, port_init, t, torch_params
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def tiny_llm():
    jcfg = j_tiny().llm
    params = port_init(TL.init_llm_params, jcfg)
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, torch_params(params)


def _jax_causal_logits(jp, jcfg, x_emb):
    """JAX full causal forward: linear_legacy embed, transformer_layer stack,
    after_norm, llm_decoder -> logits at every position."""
    return np.asarray(jax.jit(lambda p, x: _causal_forward(p, jcfg, x))(jp, x_emb))


def _causal_forward(jp, jcfg, x_emb):
    p = JP(jp)
    sp = p.sub("llm")
    x = JL._token_embed_legacy(sp, jcfg.llm.output_size, x_emb.dtype)(x_emb)
    L = x.shape[1]
    causal = jnp.where(jnp.arange(L)[:, None] >= jnp.arange(L)[None, :], 0.0, NEG_BIAS)[None]
    pe = j_table(L, jcfg.llm.output_size)
    for i in range(jcfg.llm.num_blocks):
        x = j_layer(sp, f"encoders.{i}", jcfg.llm, x, causal, pe, EVAL)
    x = j_ln(sp, "after_norm", x, eps=1e-5)
    return j_dense(p, "llm_decoder", x)[0]


def test_text_encoder_and_prefix_logits(tiny_llm):
    jcfg, jp, tp = tiny_llm
    ids = np.random.default_rng(0).integers(0, 255, (1, 9)).astype(np.int32)
    want_enc = jax.jit(lambda p, i, n: JL.llm_encode_text(JP(p), jcfg, i, n, EVAL))(
        jp, jnp.asarray(ids), jnp.asarray([9]))
    got_enc = TL.llm_encode_text(tp, port_config(jcfg), t(ids, torch.long),
                                 torch.tensor([9], dtype=torch.int32))
    assert_close(got_enc, np.asarray(want_enc), **TOL, name="text encoder")
    prefix = np.random.default_rng(1).standard_normal((1, 7, 16)).astype(np.float32)
    logits, _ = TL.llm_prefill(tp, port_config(jcfg), t(prefix), 7 + 4)
    want = _jax_causal_logits(jp, jcfg, jnp.asarray(prefix))[-1]
    assert_close(logits, want, **TOL, name="prefix logits")


def test_kv_cache_decode_teacher_forced(tiny_llm):
    jcfg, jp, tp = tiny_llm
    tcfg = port_config(jcfg)
    rng = np.random.default_rng(2)
    L0, n = 6, 9
    prefix = rng.standard_normal((1, L0, 16)).astype(np.float32)
    tokens = rng.integers(0, jcfg.speech_token_size, n)
    emb = np.asarray(jp["speech_embedding.weight"])[tokens][None]
    want = _jax_causal_logits(jp, jcfg, jnp.asarray(np.concatenate([prefix, emb], 1)))
    logits, cache = TL.llm_prefill(tp, tcfg, t(prefix), L0 + n + 3)
    got = [logits]
    for i, tok in enumerate(tokens):
        got.append(TL.llm_decode_step(tp, tcfg, cache, int(tok), L0 + i))
    assert_close(torch.stack(got), want[L0 - 1:], **TOL)


def _numpy_ras(logits, decoded, top_p, top_k, win_size, tau_r, u1, u2):
    """The rule of cosy_tpu/ops/sampling.py:14-62 stated in numpy, with
    inverse-CDF draws for the two categorical samples."""
    def pick(w, u):
        c = np.cumsum(w.astype(np.float64))
        return min(int((c <= u * c[-1]).sum()), len(w) - 1)

    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    order = np.argsort(-probs, kind="stable")[:top_k]
    vals = probs[order]
    kept = np.where(np.cumsum(vals) - vals < top_p, vals, 0.0)
    cand = int(order[pick(kept, u1)])
    window = decoded[max(0, len(decoded) - win_size):]
    if sum(1 for x in window if x == cand) >= win_size * tau_r:
        return pick(probs, u2)
    return cand


@pytest.mark.parametrize("case", range(6))
def test_ras_sample_rule(case):
    rng = np.random.default_rng(case)
    logits = (3 * rng.standard_normal(40)).astype(np.float32)
    u1, u2 = rng.uniform(size=2)
    top = int(np.argmax(logits))
    # cases 3-5 repeat the likeliest token in the window: the fallback fires
    decoded = list(rng.integers(0, 40, 12)) + ([top] * case if case >= 3 else [])
    top_p, top_k = (0.8, 25) if case % 2 == 0 else (0.5, 3)
    got = TS.ras_sample(torch.from_numpy(logits), decoded, top_p, top_k, 10, 0.1,
                        uniforms=(u1, u2))
    assert got == _numpy_ras(logits, decoded, top_p, top_k, 10, 0.1, u1, u2)


def test_ras_kept_set_is_the_nucleus():
    """Every nucleus draw lands in the kept set: top_k, and cumulative
    probability before the token < top_p."""
    logits = torch.tensor([4.0, 3.0, 2.9, 1.0, 0.5, -1.0])
    probs = torch.softmax(logits, 0)
    seen = {TS.nucleus_sample(logits, 0.8, 4, u=u) for u in np.linspace(0, 0.999, 50)}
    cum_before = torch.cumsum(probs, 0) - probs
    assert seen == {i for i in range(4) if cum_before[i] < 0.8}


def test_llm_decode_respects_min_and_max_len(tiny_llm):
    jcfg, _, tp = tiny_llm
    tcfg = port_config(jcfg)
    prefix = torch.randn((1, 5, 16), generator=torch.Generator().manual_seed(0))
    toks = TL.llm_decode(tp, tcfg, prefix, min_len=12, max_len=12,
                         generator=torch.Generator().manual_seed(1))
    assert len(toks) == 12 and all(0 <= x < tcfg.speech_token_size for x in toks)
