"""The port's flow training forward against the JAX package at the tiny
config, with JAX's own random numbers fed into both: ``cfm_compute_loss``
(noise given) and ``flow_forward_train`` in the no-prompt ``full`` and
``mixed`` modes, the vendored style, and the anti-leakage strategies (with
a cross-sample batch, and with the silence band on); the strategy draws are
the ones JAX makes from its key.  Loss tolerance 2e-4; LoRA gradients
against ``jax.grad``: cosine >= 0.9999, max relative error <= 2e-3 of the
largest gradient entry (f32 sums in another order through the U-Net).
Dropout is 0 in both packages."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu import lora as JL
from cosy_tpu.config import (FLOW_LORA_DEFAULT, AntiLeakageConfig as JLeak,
                             NoPromptConfig as JNoPrompt, tiny_model_config as j_tiny)
from cosy_tpu.ctx import Ctx as JCtx
from cosy_tpu.models import flow as JF
from cosy_tpu.params import P as JP
from cosy_tpu_torch import lora as TL
from cosy_tpu_torch.ctx import Ctx as TCtx
from cosy_tpu_torch.models import flow as TF
from test_torch_common import (assert_close, grad_agreement, port_config, port_init, t,
                               torch_params)
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)
B, T, TTOK = 4, 24, 14


@pytest.fixture(scope="module")
def tiny_flow():
    jcfg = j_tiny().flow
    enc = dataclasses.replace(jcfg.encoder, dropout_rate=0.0, positional_dropout_rate=0.0,
                              attention_dropout_rate=0.0)
    jcfg = dataclasses.replace(jcfg, encoder=enc)
    params = port_init(TF.init_flow_params, jcfg)
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, torch_params(params)


def make_batch(seed=0, cross=False):
    rng = np.random.default_rng(seed)
    batch = {
        "speech_token": rng.integers(0, 128, (B, TTOK)).astype(np.int32),
        "speech_token_len": np.asarray([14, 12, 14, 9], np.int32),
        "speech_feat": (rng.standard_normal((B, T, 80)) * 2 - 6).astype(np.float32),
        "speech_feat_len": np.asarray([24, 20, 23, 16], np.int32),
        "embedding": rng.standard_normal((B, 192)).astype(np.float32),
    }
    if cross:  # its own, shorter bucket; one sample without a cross prompt
        batch["cross_sample_mel"] = (rng.standard_normal((B, 10, 80)) * 2 - 6).astype(np.float32)
        batch["cross_sample_mel_len"] = np.asarray([10, 0, 3, 7], np.int32)
    return batch


def make_noise(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(B, 1, 1)).astype(np.float32),
            rng.standard_normal((B, 80, T)).astype(np.float32),
            np.asarray([0.9, 0.1, 0.5, 0.3], np.float32))  # one CFG-dropped sample


def jax_draws(rng, kind, leak=None):
    """The strategy draws ``flow_forward_train`` of the JAX package makes
    from ``rng`` (cosy_tpu/models/flow.py, k_strat and its splits)."""
    k_strat = jax.random.fold_in(rng, 1)
    u = lambda k: np.array(jax.random.uniform(k, (B,)))
    if kind == "mixed":
        ks = jax.random.split(k_strat, 2)
        return {"bare_u": u(ks[0]), "plen_u": u(ks[1])}
    if kind == "vendored":
        ks = jax.random.split(k_strat, 2)
        return {"drop": np.array(jax.random.bernoulli(ks[0], 0.5, (B,))), "plen_u": u(ks[1])}
    ks = jax.random.split(k_strat, 4)
    return {"dropout_u": u(ks[0]), "prompt_u": u(ks[1]), "blind_u": u(ks[2]),
            "sil_tok": np.array(jax.random.randint(
                ks[3], (B,), leak.silence_min_tokens, leak.silence_max_tokens + 1))}


def test_cfm_compute_loss_matches_jax(tiny_flow):
    jcfg, jp, tp = tiny_flow
    rng = np.random.default_rng(1)
    x1, mu, cond = (rng.standard_normal((B, 80, T)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((B, 80)).astype(np.float32)
    mask = (np.arange(T)[None, None, :] < np.asarray([24, 20, 23, 16])[:, None, None]).astype(np.float32)
    plens = np.asarray([0, 5, 2, 9], np.int32)  # boundary weighting on three samples
    noise = make_noise(2)
    for prompt_lens in (None, plens):
        want = JF.cfm_compute_loss(
            JP(jp).sub("decoder.estimator"), jcfg, jax.random.PRNGKey(0), jnp.asarray(x1),
            jnp.asarray(mask), jnp.asarray(mu), jnp.asarray(spks), jnp.asarray(cond),
            JCtx(train=True), prompt_lens=None if prompt_lens is None else jnp.asarray(prompt_lens),
            noise=noise)
        with torch.no_grad():
            got = TF.cfm_compute_loss(
                tp.sub("decoder.estimator"), port_config(jcfg), None, t(x1), t(mask), t(mu),
                t(spks), t(cond), TCtx(train=True),
                prompt_lens=None if prompt_lens is None else torch.from_numpy(prompt_lens).long(),
                noise=noise)
        assert_close(got, np.asarray(want), **TOL, name=f"prompt_lens={prompt_lens}")


CASES = {
    "full": dict(no_prompt=True),
    "mixed": dict(no_prompt=JNoPrompt(enabled=True, mode="mixed", no_prompt_ratio=0.5)),
    "vendored": dict(vendored_style=True),
    "anti_leakage_cross": dict(leak=JLeak(), cross=True),
    "anti_leakage_silence": dict(leak=JLeak(silence_padding_enabled=True,
                                            prompt_dropout_prob=0.3, text_blinding_prob=0.6)),
}


def _kwargs(case):
    kw = dict(CASES[case])
    cross = kw.pop("cross", False)
    jkw = dict(kw)
    tkw = {k: port_config(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}
    kind = "mixed" if case == "mixed" else "vendored" if case == "vendored" else "leak"
    return jkw, tkw, cross, kind


@pytest.mark.parametrize("case", sorted(CASES))
def test_flow_forward_train_matches_jax(tiny_flow, case):
    jcfg, jp, tp = tiny_flow
    jkw, tkw, cross, kind = _kwargs(case)
    batch = make_batch(3, cross)
    noise = make_noise(4)
    rng = jax.random.PRNGKey(11)
    want = JF.flow_forward_train(JP(jp), jcfg, rng, {k: jnp.asarray(v) for k, v in batch.items()},
                                 JCtx(train=True), noise=noise, **jkw)
    draws = None if case == "full" else jax_draws(rng, kind, jkw.get("leak"))
    if draws is not None:  # the draws reach both sides of each strategy's threshold
        assert all(0 < np.asarray(v).astype(np.float64).std() for v in draws.values()), draws
    with torch.no_grad():
        got = TF.flow_forward_train(tp, port_config(jcfg), None,
                                    {k: torch.from_numpy(v) for k, v in batch.items()},
                                    TCtx(train=True), noise=noise, draws=draws, **tkw)
    assert_close(got, np.asarray(want), **TOL, name=case)
    assert float(got) > 0.1


def test_draws_come_from_the_generator_when_not_given(tiny_flow):
    jcfg, _, tp = tiny_flow
    batch = {k: torch.from_numpy(v) for k, v in make_batch(5, cross=True).items()}

    def run(seed):
        with torch.no_grad():
            return float(TF.flow_forward_train(tp, port_config(jcfg),
                                               torch.Generator().manual_seed(seed), batch,
                                               TCtx(train=True)))

    assert run(0) == run(0) and run(0) != run(1)


@pytest.mark.parametrize("case", ["full", "anti_leakage_cross"])
def test_lora_gradients_match_jax_grad(tiny_flow, case):
    jcfg, jp, tp = tiny_flow
    jkw, tkw, cross, kind = _kwargs(case)
    batch = make_batch(6, cross)
    noise = make_noise(7)
    rng = jax.random.PRNGKey(12)
    lcfg = dataclasses.replace(FLOW_LORA_DEFAULT, dropout=0.0)
    jl = JL.init_lora(jax.random.PRNGKey(5), jp, lcfg)
    jl = {k: (v * 30 if k.endswith("lora_B") else v) for k, v in jl.items()}
    assert any(".attn1.to_q" in k for k in jl) and any("encoder.encoders" in k for k in jl)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(lora):
        ctx = JCtx(train=True, lora=lora, lora_scale=lcfg.scaling)
        return JF.flow_forward_train(JP(jp), jcfg, rng, jb, ctx, noise=noise, **jkw)

    jl_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(jl)
    tl = TL.lora_from_numpy({k: np.asarray(v) for k, v in jl.items()}, "cpu")
    draws = None if case == "full" else jax_draws(rng, kind, jkw.get("leak"))
    loss = TF.flow_forward_train(tp, port_config(jcfg), None,
                                 {k: torch.from_numpy(v) for k, v in batch.items()},
                                 TCtx(train=True, lora=tl, lora_scale=lcfg.scaling),
                                 noise=noise, draws=draws, **tkw)
    loss.backward()
    assert_close(loss, np.asarray(jl_loss), **TOL, name="loss with adapters")
    cos, rel = grad_agreement({k: v.grad.numpy() for k, v in tl.items()},
                              {k: np.asarray(v) for k, v in jgrads.items()})
    assert cos >= 0.9999 and rel <= 2e-3, (cos, rel)
    assert all(v.grad is None for v in tp.d.values())


def test_mel_normalization_round_trip():
    cfg = port_config(j_tiny())
    mel = t(np.random.default_rng(8).standard_normal((2, 5, 80)).astype(np.float32))
    norm = TF.normalize_mel(cfg, mel)
    assert_close(norm, (mel.numpy() + 6.0) / 2.0, atol=1e-6, rtol=1e-6)
    assert_close(TF.denormalize_mel(cfg, norm), mel.numpy(), atol=1e-6, rtol=1e-6)
