"""The port's LLM training forward against the JAX package at the tiny
config: the dense packing (exact), the label-smoothing loss at 0 and 0.1,
the loss and accuracy of ``llm_forward_train`` (2e-4), and the LoRA
gradients against ``jax.grad`` (cosine >= 0.9999, max relative error
<= 2e-3 of the largest gradient entry: f32 sums in another order through
two encoders).  Dropout is 0 in both packages (their random streams
differ); the dropout plumbing is checked for the port alone."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu import lora as JL
from cosy_tpu.config import LLM_LORA_DEFAULT, tiny_model_config as j_tiny
from cosy_tpu.ctx import Ctx as JCtx
from cosy_tpu.models import llm as JLLM
from cosy_tpu.params import P as JP
from cosy_tpu_torch import lora as TL
from cosy_tpu_torch.ctx import Ctx as TCtx
from cosy_tpu_torch.models import llm as TLLM
from test_torch_common import (assert_close, grad_agreement, port_config, port_init, t,
                               torch_params)

TOL = dict(atol=2e-4, rtol=2e-4)


def no_dropout(enc):
    return dataclasses.replace(enc, dropout_rate=0.0, positional_dropout_rate=0.0,
                               attention_dropout_rate=0.0)


@pytest.fixture(scope="module")
def tiny_llm():
    jcfg = j_tiny().llm
    jcfg = dataclasses.replace(jcfg, text_encoder=no_dropout(jcfg.text_encoder),
                               llm=no_dropout(jcfg.llm))
    params = port_init(TLLM.init_llm_params, jcfg)
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, torch_params(params)


def make_batch(seed=0, B=3, Tt=7, Ts=11, vocab=128):
    rng = np.random.default_rng(seed)
    return {
        "text_token": rng.integers(0, 300, (B, Tt)).astype(np.int32),
        "text_token_len": np.asarray([Tt, Tt - 3, Tt - 1][:B], np.int32),
        "speech_token": rng.integers(0, vocab, (B, Ts)).astype(np.int32),
        "speech_token_len": np.asarray([Ts - 2, Ts, Ts - 5][:B], np.int32),
        "embedding": rng.standard_normal((B, 192)).astype(np.float32),
    }


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_pack_lm_inputs_exact(tiny_llm):
    jcfg, jp, tp = tiny_llm
    rng = np.random.default_rng(1)
    B, Tt, Ts, D = 3, 6, 9, 16
    text_enc = rng.standard_normal((B, Tt, D)).astype(np.float32)
    speech_emb = rng.standard_normal((B, Ts, D)).astype(np.float32)
    spk = rng.standard_normal((B, D)).astype(np.float32)
    tl, sl = np.asarray([6, 2, 4], np.int32), np.asarray([9, 5, 1], np.int32)
    tok = rng.integers(0, 128, (B, Ts)).astype(np.int32)
    want = JLLM.pack_lm_inputs(JP(jp), jcfg, *(jnp.asarray(a) for a in (
        text_enc, tl, spk, speech_emb, sl, tok)))
    got = TLLM.pack_lm_inputs(tp, port_config(jcfg), t(text_enc), torch.from_numpy(tl), t(spk),
                              t(speech_emb), torch.from_numpy(sl), torch.from_numpy(tok))
    for g, w, name in zip(got, want, ("lm_input", "lm_len", "lm_target")):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got[2][1] == TLLM.IGNORE_ID).sum() == got[2].shape[1] - 5 - 1  # 5 tokens + EOS


@pytest.mark.parametrize("normalize_length", [True, False])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_loss_and_accuracy(smoothing, normalize_length):
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((3, 10, 17))).astype(np.float32)
    target = rng.integers(0, 17, (3, 10)).astype(np.int32)
    target[0, :4] = -1
    target[2, 7:] = -1
    target[1, 2] = int(logits[1, 2].argmax())  # at least one hit
    want = JLLM.label_smoothing_loss(jnp.asarray(logits), jnp.asarray(target), smoothing,
                                     normalize_length)
    got = TLLM.label_smoothing_loss(t(logits), torch.from_numpy(target).long(), smoothing,
                                    normalize_length)
    assert_close(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    acc = TLLM.th_accuracy(t(logits), torch.from_numpy(target).long())
    assert_close(acc, np.asarray(JLLM.th_accuracy(jnp.asarray(logits), jnp.asarray(target))),
                 atol=1e-6, rtol=1e-6)
    assert float(acc) > 0


@pytest.mark.parametrize("lsm", [0.0, 0.1])
def test_forward_train_loss_and_accuracy(tiny_llm, lsm):
    jcfg, jp, tp = tiny_llm
    jcfg = dataclasses.replace(jcfg, lsm_weight=lsm)
    batch = make_batch(3)
    want = jax.jit(lambda p, b: JLLM.llm_forward_train(JP(p), jcfg, b, JCtx(train=True)))(
        jp, jbatch(batch))
    with torch.no_grad():
        got = TLLM.llm_forward_train(tp, port_config(jcfg), tbatch(batch), TCtx(train=True))
    assert_close(got["loss"], np.asarray(want["loss"]), **TOL, name="loss")
    assert_close(got["acc"], np.asarray(want["acc"]), atol=1e-6, rtol=1e-6, name="acc")
    assert float(got["loss"]) > 1.0


def test_lora_gradients_match_jax_grad(tiny_llm):
    jcfg, jp, tp = tiny_llm
    batch = make_batch(4)
    lcfg = LLM_LORA_DEFAULT
    jl = JL.init_lora(jax.random.PRNGKey(5), jp, dataclasses.replace(lcfg, dropout=0.0))
    # B ~ 0.01 N(0,1) leaves A's gradient tiny; scale B up so both count
    jl = {k: (v * 30 if k.endswith("lora_B") else v) for k, v in jl.items()}
    assert len(jl) == 2 * len(JL.find_lora_targets(jp, lcfg.target_modules)) > 0

    def jloss(lora):
        ctx = JCtx(train=True, lora=lora, lora_scale=lcfg.scaling)
        return JLLM.llm_forward_train(JP(jp), jcfg, jbatch(batch), ctx)["loss"]

    jl_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(jl)
    tl = TL.lora_from_numpy({k: np.asarray(v) for k, v in jl.items()}, "cpu")
    ctx = TCtx(train=True, lora=tl, lora_scale=lcfg.scaling)
    loss = TLLM.llm_forward_train(tp, port_config(jcfg), tbatch(batch), ctx)["loss"]
    loss.backward()
    assert_close(loss, np.asarray(jl_loss), **TOL, name="loss with adapters")
    assert all(v.grad is not None for v in tl.values())
    cos, rel = grad_agreement({k: v.grad.numpy() for k, v in tl.items()},
                              {k: np.asarray(v) for k, v in jgrads.items()})
    assert cos >= 0.9999 and rel <= 2e-3, (cos, rel)
    # the base weights are frozen: no gradient reaches them
    assert all(v.grad is None and not v.requires_grad for v in tp.d.values())


def test_dropout_needs_train_and_a_generator(tiny_llm):
    """With the config's own dropout rates (0.1) eval is deterministic,
    training differs from eval, and a fixed generator seed repeats."""
    jcfg, _, tp = tiny_llm
    cfg = port_config(j_tiny().llm)
    batch = tbatch(make_batch(6))

    def run(ctx):
        with torch.no_grad():
            return float(TLLM.llm_forward_train(tp, cfg, batch, ctx)["loss"])

    ev = run(TCtx())
    assert ev == run(TCtx(torch.Generator().manual_seed(0)))
    tr = run(TCtx(torch.Generator().manual_seed(0), train=True))
    assert tr != ev and tr == run(TCtx(torch.Generator().manual_seed(0), train=True))
    assert tr != run(TCtx(torch.Generator().manual_seed(1), train=True))
    with pytest.raises(ValueError, match="generator"):
        run(TCtx(train=True))
