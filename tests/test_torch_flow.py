"""The port's estimator, CFM solve and flow inference against the JAX
package (CPU) and the torch-recorded goldens.  Tolerance 2e-4 for whole
modules (as tests/test_parity.py), 5e-4 for the multi-step Euler golden
(as tests/test_parity.py:206)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.ctx import EVAL
from cosy_tpu.layers.unet import conditional_decoder as j_decoder
from cosy_tpu.models import flow as JF
from cosy_tpu.params import P as JP
from cosy_tpu_torch import config as TC
from cosy_tpu_torch.layers.unet import conditional_decoder as t_decoder
from cosy_tpu_torch.models import flow as TF
from test_torch_common import assert_close, golden_np, port_config, port_init, t, torch_params
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def tiny_flow():
    jcfg = j_tiny().flow
    params = port_init(TF.init_flow_params, jcfg)
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, torch_params(params)


def _estimator_inputs(seed, B, T, n_mels=80):
    rng = np.random.default_rng(seed)
    x, mu, cond = (rng.standard_normal((B, n_mels, T)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((B, n_mels)).astype(np.float32)
    tt = rng.uniform(size=(B,)).astype(np.float32)
    return x, mu, tt, spks, cond


@pytest.mark.parametrize("case", ["dense", "masked", "window"])
def test_conditional_decoder_matches_jax(tiny_flow, case):
    """Dense path (even T, mask None), the masked path an odd mel length
    takes after padding (mask, (B, T, T) bias), and the opt-in local-band
    attention window (a band bias on the CPU)."""
    import dataclasses

    jcfg, jp, tp = tiny_flow
    if case == "window":
        jcfg = dataclasses.replace(
            jcfg, estimator=dataclasses.replace(jcfg.estimator, attn_window=8))
    masked = case == "masked"
    B, T = 2, 24
    x, mu, tt, spks, cond = _estimator_inputs(1 + masked, B, T)
    mask = None
    if masked:
        mask = np.ones((B, 1, T), np.float32)
        mask[:, :, 23:] = 0.0
        mask[1, :, 17:] = 0.0
    want = jax.jit(lambda p, x, m, *a: j_decoder(
        JP(p).sub("decoder.estimator"), jcfg.estimator, x, m, *a, EVAL))(
        jp, jnp.asarray(x), None if mask is None else jnp.asarray(mask), jnp.asarray(mu),
        jnp.asarray(tt), jnp.asarray(spks), jnp.asarray(cond))
    got = t_decoder(tp.sub("decoder.estimator"), port_config(jcfg.estimator), t(x),
                    None if mask is None else t(mask), t(mu), t(tt), t(spks), t(cond))
    assert_close(got, np.asarray(want), **TOL)


EST_CFG = TC.EstimatorConfig(in_channels=24, out_channels=6, channels=(16, 16),
                             dropout=0.0, attention_head_dim=4, n_blocks=1,
                             num_mid_blocks=2, num_heads=2, act_fn="gelu")


@pytest.mark.parametrize("iso", [False, True])
def test_estimator_golden(iso):
    params, ins, outs = golden_np("estimator")
    pl = int(ins["prompt_len"])
    y = t_decoder(torch_params(params), EST_CFG, t(ins["x"]), t(ins["mask"]), t(ins["mu"]),
                  t(ins["t"]), t(ins["spks"]), t(ins["cond"]),
                  prompt_lens=[pl, pl] if iso else None)
    assert_close(y, outs["y_iso" if iso else "y"], **TOL)


@pytest.mark.parametrize("prompt", [True, False])
def test_regulator_inference_golden(prompt):
    """The seam-preserving length regulator, with and without a prompt
    segment (golden regulator.npz, as tests/test_parity.py:221)."""
    params, ins, outs = golden_np("regulator")
    x1 = ins["x1"] if prompt else ins["x1"][:, :0]
    y = TF.length_regulator_inference(torch_params(params), t(x1), t(ins["x2"]),
                                      11 if prompt else 0, 69, 4, 50)
    assert_close(y, outs["y_inf" if prompt else "y_inf_np"], **TOL)


def test_cfm_euler_golden():
    params, ins, outs = golden_np("cfm_euler")
    cfg = TC.FlowConfig(
        output_size=80,
        estimator=TC.EstimatorConfig(in_channels=320, out_channels=80, channels=(16, 16),
                                     dropout=0.0, attention_head_dim=4, n_blocks=1,
                                     num_mid_blocks=1, num_heads=2, act_fn="gelu"),
        cfm=TC.CFMConfig(inference_cfg_rate=0.7))
    y = TF.cfm_solve_euler(torch_params(params), cfg, t(ins["z"]), t(ins["mask"]),
                           t(ins["mu"]), t(ins["spks"]), t(ins["cond"]),
                           int(ins["n_timesteps"]))
    assert_close(y, outs["y"], atol=5e-4, rtol=5e-4)


def test_cfm_solve_euler_matches_jax(tiny_flow):
    jcfg, jp, tp = tiny_flow
    z, mu, _, spks, cond = _estimator_inputs(5, 1, 20)
    want = JF.cfm_solve_euler(JP(jp).sub("decoder.estimator"), jcfg, jnp.asarray(z), None,
                              jnp.asarray(mu), jnp.asarray(spks[:, :80]),
                              jnp.asarray(cond), 4, EVAL)
    got = TF.cfm_solve_euler(tp.sub("decoder.estimator"), port_config(jcfg), t(z), None, t(mu),
                             t(spks[:, :80]), t(cond), 4)
    assert_close(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("n_tok", [23, 45])
def test_flow_inference_matches_jax(tiny_flow, n_tok):
    """Prompt-free flow inference with JAX's own z draw injected: 23 tokens
    -> 39 mel frames (odd: padded, masked), 45 tokens -> 77 frames (odd,
    and over 40 tokens: the 3-segment length regulator)."""
    jcfg, jp, tp = tiny_flow
    rng = np.random.default_rng(n_tok)
    tok = rng.integers(0, jcfg.vocab_size, (1, n_tok)).astype(np.int32)
    spk = rng.standard_normal((1, 192)).astype(np.float32)
    key = jax.random.PRNGKey(n_tok)
    want = jax.jit(lambda p, k, tk, s: JF.flow_inference(
        JP(p), jcfg, k, tk, jnp.zeros((1, 0), jnp.int32), jnp.zeros((1, 0, 80)), s,
        n_timesteps=3, finetuned_norm=True))(jp, key, jnp.asarray(tok), jnp.asarray(spk))
    T = int(n_tok / 50 * 22050 / 256)
    T_pad = T + T % 2
    z = np.asarray(jax.random.normal(key, (1, 80, T_pad)))
    got = TF.flow_inference(tp, port_config(jcfg), t(tok, torch.long), torch.zeros((1, 0), dtype=torch.long),
                            torch.zeros((1, 0, 80)), t(spk), n_timesteps=3,
                            finetuned_norm=True, z=t(z))
    assert got.shape == (1, 80, T)
    assert_close(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("prompt", [False, True], ids=["no_prompt", "prompt"])
def test_flow_inference_like_training_matches_jax(tiny_flow, prompt):
    """Train-style inference (one regulation of all 23 tokens to the frame
    count, the prompt mel as conditioning only, the whole mel returned)
    with JAX's z injected: 39 frames (odd: padded, masked) without a
    prompt; 40 frames whose first 12 take a 15-frame prompt mel's."""
    jcfg, jp, tp = tiny_flow
    rng = np.random.default_rng(11 + prompt)
    tok = rng.integers(0, jcfg.vocab_size, (1, 23)).astype(np.int32)
    spk = rng.standard_normal((1, 192)).astype(np.float32)
    T = 40 if prompt else 39
    pfeat = (rng.standard_normal((1, 15, 80)) * 2 - 6).astype(np.float32) if prompt else None
    plen = 12 if prompt else 0
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, k, tk, s, pf: JF.flow_inference_like_training(
        JP(p), jcfg, k, tk, T, s, pf, plen, n_timesteps=3))(
        jp, key, jnp.asarray(tok), jnp.asarray(spk), None if pfeat is None else jnp.asarray(pfeat))
    z = np.asarray(jax.random.normal(key, (1, 80, T + T % 2)))
    got = TF.flow_inference_like_training(tp, port_config(jcfg), t(tok, torch.long), T, t(spk),
                                          None if pfeat is None else t(pfeat), plen,
                                          n_timesteps=3, z=t(z))
    assert got.shape == (1, 80, T)
    assert_close(got, np.asarray(want), **TOL)
