"""The port's flash attention (plain version on CPU tensors) against the JAX
package's Pallas kernel in interpret mode, on the cases of
tests/test_flash_attention.py; and the wrapper's refusal of every tensor it
has no kernel or plain version for.  Tolerance 2e-5 (f32, kernel plain
version)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.ops import flash_attention as jfa
from cosy_tpu_torch.ops import flash_attention as tfa
from test_torch_common import assert_close, t
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, B, H, T, S, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, T, d), (B, H, S, d), (B, H, S, d))]


def _both(q, k, v, bias, k_valid, **jax_kw):
    d = q.shape[-1]
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if bias is None else jnp.asarray(bias), d ** -0.5,
                               k_valid=None if k_valid is None else jnp.asarray(k_valid),
                               interpret=True, **jax_kw)
    got = tfa.flash_attention(t(q), t(k), t(v), None if bias is None else t(bias),
                              d ** -0.5,
                              None if k_valid is None else t(k_valid, torch.int32))
    return got, np.asarray(want)


def test_bias():
    q, k, v = _qkv(0, 2, 3, 100, 150, 32)
    bias = np.zeros((2, 100, 150), np.float32)
    bias[1, :, -30:] = -1e10
    got, want = _both(q, k, v, bias, None, block_q=64, block_k=64)
    assert_close(got, want, **TOL)


def test_k_valid_no_bias():
    q, k, v = _qkv(2, 2, 2, 80, 80, 32)
    got, want = _both(q, k, v, None, np.asarray([80, 55], np.int32),
                      block_q=64, block_k=64)
    assert_close(got, want, **TOL)


def test_fully_masked_rows_are_finite_uniform():
    q, k, v = _qkv(1, 1, 2, 64, 64, 16)
    bias = np.full((1, 64, 64), -1e10, np.float32)
    got, want = _both(q, k, v, bias, None, block_q=64, block_k=64)
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    # -1e10 (never -inf): a fully masked row is the uniform average of v
    assert_close(got, np.broadcast_to(v.mean(axis=2, keepdims=True), got.shape), **TOL)


def test_qblocked_large_s():
    S = jfa.MAX_ONE_TILE_S + 64  # 1216: the JAX package's q-blocked route
    q, k, v = _qkv(3, 1, 2, 64, S, 32)
    got, want = _both(q, k, v, None, np.asarray([S - 100], np.int32),
                      block_q=64, block_k=128)
    assert_close(got, want, **TOL)


def test_qblocked_multiblock_with_bias():
    bq = jfa._qblock_for(1280, True)
    T, S = 2 * bq + 40, jfa.MAX_ONE_TILE_S + 100
    q, k, v = _qkv(7, 1, 2, T, S, 32)
    bias = np.zeros((1, T, S), np.float32)
    bias[:, :, -50:] = -1e10
    bias[:, 5, :10] = -1e10
    got, want = _both(q, k, v, bias, None)
    assert_close(got, want, **TOL)


def test_streaming_length_s8320():
    """S > MAX_QBLOCK_S, the JAX streaming kernel's range; held against the
    einsum reference of tests/test_flash_attention.py (interpret mode of
    the streaming kernel is slow at this S)."""
    S = jfa.MAX_QBLOCK_S + 128
    q, k, v = _qkv(8, 1, 1, 16, S, 32)
    bias = np.zeros((1, 16, S), np.float32)
    bias[:, :, S - 200:] = -1e10
    s = np.einsum("bhtd,bhsd->bhts", q, k) * 32 ** -0.5 + bias[:, None]
    a = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhts,bhsd->bhtd", a / a.sum(-1, keepdims=True), v)
    got = tfa.flash_attention(t(q), t(k), t(v), None, 32 ** -0.5,
                              torch.tensor([S - 200], dtype=torch.int32))
    assert_close(got, want, **TOL)


def test_non_cpu_tensors_never_reach_the_plain_version(monkeypatch):
    """A tensor on a device without a kernel raises before any math runs;
    CUDA is absent here, so asking for it raises too."""
    def boom(*a, **kw):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(tfa, "flash_attention_ref", boom)
    q = torch.empty((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q, q, q, None, 0.125)
    from cosy_tpu_torch.params import resolve_device

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


@pytest.mark.parametrize("case", ["fp16", "head_dim", "bias_dtype", "k_valid_dtype",
                                  "shape"])
def test_kernel_argument_checks(case):
    """The checks the CUDA wrapper applies before a launch."""
    q = k = v = torch.zeros((2, 2, 8, 64))
    bias, kv = None, None
    if case == "fp16":
        q = k = v = q.half()
    elif case == "head_dim":
        q = k = v = torch.zeros((2, 2, 8, 32))
    elif case == "bias_dtype":
        bias = torch.zeros((2, 8, 8), dtype=torch.float64)
    elif case == "k_valid_dtype":
        kv = torch.zeros((2,), dtype=torch.int64)
    else:
        k = torch.zeros((2, 2, 8, 32))
    with pytest.raises((TypeError, ValueError)):
        tfa.check_kernel_args(q, k, v, bias, kv)
    tfa.check_kernel_args(*(torch.zeros((2, 2, 8, 64)),) * 3, None, None)
