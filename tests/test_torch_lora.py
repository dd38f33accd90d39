"""The port's LoRA against the JAX package: the same targets at tiny and
(by shapes only: ``jax.eval_shape`` against ``meta`` tensors) at full
CosyVoice-300M width, init shapes and bounds, ``merge_lora`` against JAX and
the torch-recorded golden, the dense and 1x1-conv deltas in both layouts,
and the adapter bridge.  Tolerance 1e-5 (f32; small products in another
summation order)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu import config as JC
from cosy_tpu import lora as JL
from cosy_tpu.ctx import Ctx as JCtx
from cosy_tpu.layers import basic as JB
from cosy_tpu.models import flow as JF, llm as JLLM
from cosy_tpu.params import P as JP
from cosy_tpu_torch import config as TC
from cosy_tpu_torch import lora as TL
from cosy_tpu_torch.ctx import Ctx as TCtx
from cosy_tpu_torch.layers import basic as TB
from cosy_tpu_torch.models import flow as TF, llm as TLLM
from cosy_tpu_torch.params import P as TP
from test_torch_common import assert_close, golden_np, port_config, t

TOL = dict(atol=1e-5, rtol=1e-5)


def _shapes(model, width):
    """(JAX param shapes, port param dict, JAX LoRAConfig) of one model."""
    jcfg = JC.tiny_model_config() if width == "tiny" else JC.ModelConfig()
    if model == "llm":
        jshapes = jax.eval_shape(lambda: JLLM.init_llm_params(jax.random.PRNGKey(0), jcfg.llm))
        tparams = TLLM.init_llm_params(port_config(jcfg.llm), "meta").state_dict()
        return jshapes, tparams, JC.LLM_LORA_DEFAULT
    jshapes = jax.eval_shape(lambda: JF.init_flow_params(jax.random.PRNGKey(0), jcfg.flow))
    tparams = TF.init_flow_params(port_config(jcfg.flow), "meta").state_dict()
    return jshapes, tparams, JC.FLOW_LORA_DEFAULT


@pytest.mark.parametrize("width", ["tiny", "full"])
@pytest.mark.parametrize("model", ["llm", "flow"])
def test_targets_and_adapter_shapes_equal_jax(model, width):
    jshapes, tparams, jlora = _shapes(model, width)
    assert {k: tuple(v.shape) for k, v in jshapes.items()} == \
        {k: tuple(v.shape) for k, v in tparams.items()}
    want = JL.find_lora_targets(jshapes, jlora.target_modules)
    got = TL.find_lora_targets(tparams, port_config(jlora).target_modules)
    assert got == want and len(got) > 0
    if model == "flow":  # the estimator's 1x1 convs match no default target
        assert any(".attn1.to_q" in p for p in got)
    jl = jax.eval_shape(lambda: JL.init_lora(
        jax.random.PRNGKey(1), {k: jnp.zeros(v.shape) for k, v in jshapes.items()}, jlora))
    tl = TL.init_lora(None, tparams, port_config(jlora))
    assert {k: tuple(v.shape) for k, v in jl.items()} == \
        {k: tuple(v.shape) for k, v in tl.items()}
    assert TL.lora_num_params(tl) == sum(math.prod(v.shape) for v in jl.values())


def test_substring_match_and_conv_eligibility():
    params = {"a.linear_q.weight": torch.zeros(4, 6), "a.my_w_1_x.weight": torch.zeros(4, 6),
              "a.w_1.bias": torch.zeros(4), "w_1.sub.weight": torch.zeros(4, 6),
              "c.w_2.weight": torch.zeros(4, 6, 1), "c3.w_2.weight": torch.zeros(4, 6, 3),
              "n.w_1.weight": torch.zeros(4)}
    jparams = {k: jnp.zeros(v.shape) for k, v in params.items()}
    got = TL.find_lora_targets(params, ("linear_q", "w_1", "w_2"))
    assert got == JL.find_lora_targets(jparams, ("linear_q", "w_1", "w_2"))
    assert got == ["a.linear_q", "a.my_w_1_x", "c.w_2"]


def test_init_shapes_bounds_and_leaves():
    params = {"enc.linear_q.weight": torch.zeros(64, 400),
              "est.w_1.weight": torch.zeros(32, 100, 1)}
    cfg = TC.LoRAConfig(r=8, alpha=16, target_modules=("linear_q", "w_1"))
    lora = TL.init_lora(torch.Generator().manual_seed(0), params, cfg)
    assert sorted(lora) == ["enc.linear_q.lora_A", "enc.linear_q.lora_B",
                            "est.w_1.lora_A.weight", "est.w_1.lora_B.weight"]
    a, b = lora["enc.linear_q.lora_A"], lora["enc.linear_q.lora_B"]
    ca, cb = lora["est.w_1.lora_A.weight"], lora["est.w_1.lora_B.weight"]
    assert a.shape == (8, 400) and b.shape == (64, 8)
    assert ca.shape == (8, 100, 1) and cb.shape == (32, 8, 1)
    for x, fan_in in ((a, 400), (ca, 100)):  # kaiming-uniform, a = sqrt(5)
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
        assert x.abs().max() <= bound and x.abs().max() > 0.9 * bound
        assert abs(float(x.detach().mean())) < 0.1 * bound
    # B ~ 0.01 * N(0, 1), NOT zero: adapters perturb the model from step 0
    assert 0.008 < float(b.std()) < 0.012 and float(b.abs().max()) > 0.02
    assert all(v.requires_grad and v.is_leaf and v.dtype == torch.float32
               for v in lora.values())
    again = TL.init_lora(torch.Generator().manual_seed(0), params, cfg)
    assert all(torch.equal(lora[k], again[k]) for k in lora)


def _random_case(seed=0):
    rng = np.random.default_rng(seed)
    base = {"m.linear_q.weight": rng.standard_normal((6, 5)), "m.linear_q.bias": rng.standard_normal(6),
            "m.res_conv.weight": rng.standard_normal((7, 5, 1)), "m.res_conv.bias": rng.standard_normal(7),
            "m.other.weight": rng.standard_normal((3, 3))}
    lora = {"m.linear_q.lora_A": rng.standard_normal((2, 5)), "m.linear_q.lora_B": rng.standard_normal((6, 2)),
            "m.res_conv.lora_A.weight": rng.standard_normal((2, 5, 1)),
            "m.res_conv.lora_B.weight": rng.standard_normal((7, 2, 1))}
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}
    return f32(base), f32(lora), rng


def test_merge_matches_jax_linear_and_conv():
    base, lora, _ = _random_case()
    want = JL.merge_lora({k: jnp.asarray(v) for k, v in base.items()},
                         {k: jnp.asarray(v) for k, v in lora.items()}, 1.5)
    tbase = {k: t(v) for k, v in base.items()}
    got = TL.merge_lora(tbase, TL.lora_from_numpy(lora, "cpu"), 1.5)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], np.asarray(want[k]), **TOL, name=k)
        assert not got[k].requires_grad
    assert torch.equal(tbase["m.linear_q.weight"], t(base["m.linear_q.weight"]))  # untouched
    assert not torch.equal(got["m.linear_q.weight"], tbase["m.linear_q.weight"])


def test_forward_and_merge_match_the_golden():
    params, ins, outs = golden_np("lora")
    base = {f"{m}.{w}": t(params[f"{m}.original_layer.{w}"])
            for m in ("linear_q", "w_1") for w in ("weight", "bias")}
    lora = TL.lora_from_numpy({f"{m}.{ab}": params[f"{m}.{ab}"]
                               for m in ("linear_q", "w_1") for ab in ("lora_A", "lora_B")}, "cpu")
    ctx = TCtx(lora=lora, lora_scale=4 / 2)
    x = t(ins["x"])
    with torch.no_grad():
        y = TB.dense(TP(base), "w_1", TB.dense(TP(base), "linear_q", x, ctx), ctx)
    assert_close(y, outs["y"], **TOL, name="lora-forward")
    merged = TL.merge_lora(base, lora, scaling=4 / 2)
    for k in base:
        assert_close(merged[k], outs["merged:" + k], **TOL, name=f"merged-{k}")
    y_m = TB.dense(TP(merged), "w_1", TB.dense(TP(merged), "linear_q", x))
    assert_close(y_m, outs["y_merged"], **TOL, name="lora-merged-forward")


@pytest.mark.parametrize("layer", ["dense", "conv1d_bct", "conv1d_btc"])
def test_delta_matches_jax(layer):
    base, lora, rng = _random_case(1)
    jp, jl = ({k: jnp.asarray(v) for k, v in d.items()} for d in (base, lora))
    jctx = JCtx(lora=jl, lora_scale=1.5)
    tctx = TCtx(lora=TL.lora_from_numpy(lora, "cpu"), lora_scale=1.5)
    tp = TP({k: t(v) for k, v in base.items()}).sub("m")
    if layer == "dense":
        x = rng.standard_normal((2, 9, 5)).astype(np.float32)
        want = JB.dense(JP(jp).sub("m"), "linear_q", jnp.asarray(x), jctx)
        plain = JB.dense(JP(jp).sub("m"), "linear_q", jnp.asarray(x))
        got = TB.dense(tp, "linear_q", t(x), tctx)
    elif layer == "conv1d_bct":
        x = rng.standard_normal((2, 5, 9)).astype(np.float32)
        want = JB.conv1d(JP(jp).sub("m"), "res_conv", jnp.asarray(x), ctx=jctx)
        plain = JB.conv1d(JP(jp).sub("m"), "res_conv", jnp.asarray(x))
        got = TB.conv1d(tp, "res_conv", t(x), ctx=tctx)
    else:
        x = rng.standard_normal((2, 9, 5)).astype(np.float32)
        want = JB.conv1d_nwc(JP(jp).sub("m"), "res_conv", jnp.asarray(x), ctx=jctx)
        plain = JB.conv1d_nwc(JP(jp).sub("m"), "res_conv", jnp.asarray(x))
        got = TB.conv1d_nwc(tp, "res_conv", t(x), ctx=tctx)
    assert_close(got, np.asarray(want), **TOL)
    assert np.abs(np.asarray(want) - np.asarray(plain)).max() > 0.1  # the delta is there
    assert got.requires_grad  # and differentiable through the adapters


def test_lora_dropout_applies_to_the_delta_input_only():
    base, lora, rng = _random_case(2)
    tp = TP({k: t(v) for k, v in base.items()}).sub("m")
    tl = TL.lora_from_numpy(lora, "cpu")
    x = t(rng.standard_normal((4, 50, 5)).astype(np.float32))
    plain = TB.dense(tp, "linear_q", x)
    full = TB.dense(tp, "linear_q", x, TCtx(lora=tl, lora_scale=1.0))
    ev = TB.dense(tp, "linear_q", x, TCtx(lora=tl, lora_scale=1.0, lora_dropout=0.5))
    tr = TB.dense(tp, "linear_q", x, TCtx(torch.Generator().manual_seed(0), train=True,
                                          lora=tl, lora_scale=1.0, lora_dropout=0.5))
    assert torch.equal(ev, full)  # eval: no dropout
    assert not torch.allclose(tr, full)
    # E[dropout(x)] = x: the mean delta stays near the undropped one
    assert abs(float((tr - plain).mean() - (full - plain).mean())) < 0.2
    with pytest.raises(ValueError, match="generator"):
        TB.dense(tp, "linear_q", x, TCtx(train=True, lora=tl, lora_dropout=0.5))


def test_adapter_bridge_round_trip():
    _, lora, _ = _random_case(3)
    tl = TL.lora_from_numpy(lora, "cpu")
    assert all(v.requires_grad and v.is_leaf for v in tl.values())
    back = TL.lora_to_numpy(tl)
    assert sorted(back) == sorted(lora)
    assert all(np.array_equal(back[k], lora[k]) for k in lora)
    state = TL.export_torch_lora_state(tl)
    assert sorted(state) == sorted(lora) and not any(v.requires_grad for v in state.values())
