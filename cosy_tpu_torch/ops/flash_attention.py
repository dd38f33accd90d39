"""Flash attention: softmax(scale * QK^T + bias) V with a head-shared bias,
and its banded (windowed) variant.

``flash_attention`` launches the hand-written CUDA kernel A
(``csrc/flash_attention.cu``) for CUDA tensors and runs the plain PyTorch
version, ``flash_attention_ref``, for CPU tensors; any other device raises.
It is the port of the JAX package's ``ops/flash_attention.py`` Pallas
kernels (one-tile, q-blocked and streaming): one kernel serves every key
length.  ``banded_attention`` is kernel C, the port of that module's
``banded_attention``: self-attention over the keys with ``|t - s| <=
window`` and ``s < k_valid[b]``, with ``banded_attention_ref`` beside it.

The kernels have no backward: every wrapper refuses an input that requires
a gradient (the training path runs plain torch ops).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda
from .masks import NEG_BIAS

HEAD_DIM = 64  # kernel A is instantiated for the estimator's head dim only


def flash_attention_ref(q, k, v, bias, scale: float, k_valid=None) -> torch.Tensor:
    """Plain PyTorch version, following the Pallas one-tile kernel's
    arithmetic: f32 scores, bias added, keys at ``kpos >= k_valid`` replaced
    by -1e10, probabilities rounded to v's type before PV with f32
    accumulation, denominator clamped at 1e-30, output in q's type."""
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, None]
    if k_valid is not None:
        kpos = torch.arange(k.shape[2], device=q.device)
        s = torch.where(kpos[None, None, None, :] < k_valid.reshape(-1, 1, 1, 1),
                        s, NEG_BIAS)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).float(), v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def check_kernel_args(q, k, v, bias, k_valid, out=None):
    """Raise on anything kernel A does not take: a dtype other than f32 or
    bf16, a head dim other than 64, mismatched shapes or devices, a
    non-contiguous head dim, a bias that is not a contiguous (B, T, S) of
    q's dtype, a ``k_valid`` that is not (B,) int32."""
    if q.dtype not in _cuda.DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes f32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, T|S, d)")
    B, H, T, d = q.shape
    S = k.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dim {HEAD_DIM}, got {d}")
    if k.shape != (B, H, S, d) or v.shape != (B, H, S, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if T == 0 or S == 0:
        raise ValueError("empty attention")
    tensors = [q, k, v] + [t for t in (bias, k_valid, out) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all flash_attention tensors must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v) + ((out,) if out is not None else ())):
        raise ValueError("the head dim of q/k/v/out must be contiguous")
    if bias is not None and (bias.shape != (B, T, S) or bias.dtype != q.dtype
                             or not bias.is_contiguous()):
        raise ValueError("bias must be a contiguous (B, T, S) tensor of q's dtype")
    if k_valid is not None and (k_valid.shape != (B,) or k_valid.dtype != torch.int32
                                or not k_valid.is_contiguous()):
        raise ValueError("k_valid must be a contiguous (B,) int32 tensor")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype):
        raise ValueError("out must match q's shape and dtype")


def _launch(q, k, v, bias, scale: float, k_valid, out):
    """Launch kernel A on the current stream (arguments already checked)."""
    B, H, T, d = q.shape
    S = k.shape[2]
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    fn = _cuda.function("cosy_flash_attention")
    _cuda.check(fn(_cuda.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), _cuda.ptr(bias), _cuda.ptr(k_valid),
                   out.data_ptr(), B, H, T, S, d, strides, float(scale),
                   _cuda.stream_ptr(q)), "flash_attention")
    flash_attention.launches += 1


def flash_attention(
    q: torch.Tensor,  # (B, H, T, d)
    k: torch.Tensor,  # (B, H, S, d)
    v: torch.Tensor,  # (B, H, S, d)
    bias: Optional[torch.Tensor],  # (B, T, S) additive, shared across heads
    scale: float,
    k_valid: Optional[torch.Tensor] = None,  # (B,) int32 valid key counts
    out: Optional[torch.Tensor] = None,  # (B, H, T, d) view to write into
) -> torch.Tensor:
    """Fused attention.  CUDA tensors launch kernel A (strided q/k/v/out
    views are taken as they are, no copies); CPU tensors run the plain
    version; anything else raises."""
    _cuda.refuse_grad("flash_attention", q, k, v, bias)
    if q.device.type == "cpu":
        res = flash_attention_ref(q, k, v, bias, scale, k_valid)
        if out is None:
            return res
        out.copy_(res)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    check_kernel_args(q, k, v, bias, k_valid, out)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, bias, scale, k_valid, out)
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Kernel C: banded self-attention
# ---------------------------------------------------------------------------


def banded_attention_ref(q, k, v, scale: float, window: int, k_valid=None) -> torch.Tensor:
    """Plain PyTorch version, following the Pallas banded kernel's
    arithmetic: f32 scores; a key outside the band ``|t - s| <= window`` or
    at ``s >= k_valid[b]`` has its score replaced by -1e10; probabilities
    rounded to v's type before PV with f32 accumulation; denominator clamped
    at 1e-30; output in q's type.  A row with no admissible key averages V
    over all T keys (such rows lie at ``t >= k_valid[b] + window``)."""
    T = q.shape[2]
    pos = torch.arange(T, device=q.device)
    ok = ((pos[:, None] - pos[None, :]).abs() <= window)[None, None]
    if k_valid is not None:
        ok = ok & (pos[None, None, None, :] < k_valid.reshape(-1, 1, 1, 1))
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    s = torch.where(ok, s, NEG_BIAS)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).float(), v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def banded_attention(
    q: torch.Tensor,  # (B, H, T, d)
    k: torch.Tensor,  # (B, H, T, d): self-attention, S == T
    v: torch.Tensor,  # (B, H, T, d)
    scale: float,
    window: int,  # a query attends the keys with |t - s| <= window
    k_valid: Optional[torch.Tensor] = None,  # (B,) int32 valid key counts
) -> torch.Tensor:
    """Local-band attention.  CUDA tensors launch kernel C (strided views
    taken as they are; T need not be a multiple of anything; a window >= T
    is full attention); CPU tensors run the plain version; anything else
    raises.  Rows ``t >= k_valid[b] + window`` have no admissible key: the
    kernel and the plain version both give finite values there, not the
    same ones, and callers discard them."""
    _cuda.refuse_grad("banded_attention", q, k, v)
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("banded attention is self-attention: q, k, v must share "
                         f"one (B, H, T, d) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if int(window) != window or window < 0:
        raise ValueError(f"window must be a non-negative integer, got {window}")
    if q.device.type == "cpu":
        return banded_attention_ref(q, k, v, scale, int(window), k_valid)
    if q.device.type != "cuda":
        raise ValueError(f"banded_attention runs on cuda or cpu tensors, got {q.device}")
    check_kernel_args(q, k, v, None, k_valid)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    B, H, T, d = q.shape
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    fn = _cuda.function("cosy_banded_attention")
    _cuda.check(fn(_cuda.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   _cuda.ptr(k_valid), out.data_ptr(), B, H, T, d, strides,
                   float(scale), min(int(window), T), _cuda.stream_ptr(q)),
                "banded_attention")
    banded_attention.launches += 1
    return out


banded_attention.launches = 0
