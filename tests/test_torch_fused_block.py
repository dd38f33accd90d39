"""The port's fused transformer block (plain version on CPU tensors) against
the JAX package's Pallas kernel in interpret mode and its XLA
basic_transformer_block, with and without a (B, T, T) bias; the port's
unfused CPU block against the same; the kernel gate and the wrappers'
refusals.  Tolerance 2e-5 (f32, kernel plain version)."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.ctx import EVAL
from cosy_tpu.layers.unet import basic_transformer_block as j_block
from cosy_tpu.ops.fused_block import fused_transformer_block as j_fused
from cosy_tpu.params import P as JP, KeyGen, init_linear
from cosy_tpu_torch.layers.unet import basic_transformer_block as t_block
from cosy_tpu_torch.ops import fused_block as tfb
from test_torch_common import assert_close, t, torch_params
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-5, rtol=2e-5)
NAMES = ("norm1.weight", "norm1.bias", "attn1.to_q.weight", "attn1.to_k.weight",
         "attn1.to_v.weight", "attn1.to_out.0.weight", "attn1.to_out.0.bias",
         "norm3.weight", "norm3.bias", "ff.net.0.proj.weight", "ff.net.0.proj.bias",
         "ff.net.2.weight", "ff.net.2.bias")


def _params(C=32, heads=2, dh=8, ff=64):
    kg = KeyGen(jax.random.PRNGKey(0))
    d = {}
    for n in ("norm1", "norm3"):
        d[f"blk.{n}.weight"] = jax.random.normal(kg(), (C,)) * 0.1 + 1.0
        d[f"blk.{n}.bias"] = jax.random.normal(kg(), (C,)) * 0.1
    for qkv in ("to_q", "to_k", "to_v"):
        init_linear(kg(), d, f"blk.attn1.{qkv}", C, heads * dh, bias=False)
    init_linear(kg(), d, "blk.attn1.to_out.0", heads * dh, C)
    init_linear(kg(), d, "blk.ff.net.0.proj", C, ff)
    init_linear(kg(), d, "blk.ff.net.2", ff, C)
    return d


def _bias(with_bias):
    if not with_bias:
        return None
    bias = np.zeros((2, 16, 16), np.float32)
    bias[1, :, -5:] = -1e10
    return bias


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_block_matches_pallas_interpret_and_xla(with_bias):
    d = _params()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1 + with_bias), (2, 16, 32)))
    bias = _bias(with_bias)
    jb = None if bias is None else jnp.asarray(bias)
    sp = JP(d).sub("blk")
    want_kernel = j_fused(jnp.asarray(x), jb, *(sp[n] for n in NAMES), heads=2,
                          scale=8 ** -0.5, interpret=True)
    want_xla = j_block(JP(d), "blk", jnp.asarray(x), jb, 2, "gelu", EVAL)
    tp = torch_params(d).sub("blk")
    got = tfb.fused_transformer_block(t(x), None if bias is None else t(bias),
                                      *(tp[n] for n in NAMES), heads=2, scale=8 ** -0.5)
    assert_close(got, want_kernel, **TOL, name="vs pallas interpret")
    assert_close(got, want_xla, **TOL, name="vs xla block")
    # the port's CPU path (unfused layer sequence) agrees too
    got_unfused = t_block(torch_params(d), "blk", t(x), None if bias is None else t(bias),
                          2, "gelu")
    assert_close(got_unfused, want_xla, **TOL, name="unfused vs xla block")


def test_gate_routes_cuda_inference_blocks_only():
    cuda_x = types.SimpleNamespace(device=torch.device("cuda"))
    cpu_x = torch.zeros(1)
    assert tfb.use_fused_block(cuda_x, "gelu", None, None)
    assert tfb.use_fused_block(cuda_x, "gelu", 3, None)
    assert tfb.use_fused_block(cuda_x, "gelu-approximate", None, None)
    assert not tfb.use_fused_block(cpu_x, "gelu", None, None)
    assert not tfb.use_fused_block(cuda_x, "gelu", 4, None)
    assert not tfb.use_fused_block(cuda_x, "geglu", None, None)
    assert not tfb.use_fused_block(cuda_x, "gelu", None, 64)


def test_non_cpu_tensors_never_reach_the_plain_versions(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("plain version reached")

    for name in ("fused_transformer_block_ref", "gemm_ref", "layer_norm_rows_ref"):
        monkeypatch.setattr(tfb, name, boom)
    m = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfb.gemm(m, (m,))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfb.layer_norm_rows(m, m[0], m[0], torch.float32)
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfb.fused_transformer_block(x, None, *([m] * 13), heads=1, scale=1.0)


def test_plain_gemm_and_layer_norm_rounding_points():
    """The kernels' plain versions: f32 epilogue (bias, GELU, residual), one
    rounding to the output type; LayerNorm with f32 statistics."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 8)).astype(np.float32)
    ws = [rng.standard_normal((3, 8)).astype(np.float32) for _ in range(3)]
    b = rng.standard_normal(9).astype(np.float32)
    res = rng.standard_normal((5, 9)).astype(np.float32)
    y = tfb.gemm(t(a), [t(w) for w in ws], t(b), t(res), torch.float32, "tanh")
    h = a @ np.concatenate(ws).T + b
    gelu = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h ** 3)))
    assert_close(y, res + gelu, **TOL)
    w, bb = rng.standard_normal(8).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    y = tfb.layer_norm_rows(t(a), t(w), t(bb), torch.bfloat16)
    mu, var = a.mean(-1, keepdims=True), a.var(-1, keepdims=True)
    want = torch.from_numpy((a - mu) / np.sqrt(var + 1e-5) * w + bb).to(torch.bfloat16)
    assert torch.equal(y, want)
