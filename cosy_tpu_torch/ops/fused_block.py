"""The estimator's diffusers transformer block as a chain of hand kernels.

``fused_transformer_block`` is the port of the JAX package's
``ops/fused_block.py`` Pallas kernel.  For CUDA tensors it runs seven
launches of hand-written kernels (``csrc/fused_block.cu`` and kernel A):

    LN1 -> QKV GEMM -> flash attention -> out-proj GEMM (+bo, +x, f32 x1)
        -> LN3 -> FF1 GEMM (+b1, GELU) -> FF2 GEMM (+b2, +x1)

rounding to the compute dtype (x's dtype) at the Pallas kernel's points.
For CPU tensors it runs the plain version, ``fused_transformer_block_ref``,
built from the plain versions of the two kernels below; any other device
raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ctx import EVAL, Ctx
from . import _cuda
from .flash_attention import flash_attention, flash_attention_ref

_GELU_CODE = {None: 0, "tanh": 1}


# ---------------------------------------------------------------------------
# Row LayerNorm
# ---------------------------------------------------------------------------


def layer_norm_rows_ref(x, w, b, out_dtype, eps: float = 1e-5) -> torch.Tensor:
    """Plain version: LayerNorm over the last dim with f32 statistics and
    f32 affine, cast to ``out_dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(out_dtype)


def layer_norm_rows(x, w, b, out_dtype, eps: float = 1e-5) -> torch.Tensor:
    """(rows, C) LayerNorm.  ``x`` is f32 or of the weights' dtype."""
    _cuda.refuse_grad("layer_norm_rows", x, w, b)
    if x.device.type == "cpu":
        return layer_norm_rows_ref(x, w, b, out_dtype, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_rows runs on cuda or cpu tensors, got {x.device}")
    codes = _cuda.DTYPE_CODE
    if w.dtype not in codes or x.dtype not in codes or out_dtype not in codes:
        raise TypeError("layer_norm_rows takes f32 or bf16")
    if x.dtype not in (torch.float32, w.dtype) or b.dtype != w.dtype:
        raise TypeError("x must be f32 or of the weights' dtype")
    if x.ndim != 2 or w.shape != (x.shape[1],) or b.shape != w.shape:
        raise ValueError("layer_norm_rows takes x (rows, C) with w, b (C,)")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("layer_norm_rows takes contiguous tensors")
    if w.device != x.device or b.device != x.device:
        raise ValueError("layer_norm_rows tensors must be on one device")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    fn = _cuda.function("cosy_layer_norm")
    _cuda.check(fn(codes[w.dtype], codes[x.dtype], codes[out_dtype], x.data_ptr(),
                   w.data_ptr(), b.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                   float(eps), _cuda.stream_ptr(x)), "layer_norm_rows")
    layer_norm_rows.launches += 1
    return y


layer_norm_rows.launches = 0


# ---------------------------------------------------------------------------
# GEMM with fused epilogue
# ---------------------------------------------------------------------------


def gemm_ref(a, weights, bias=None, residual=None, out_dtype=None,
             gelu: Optional[str] = None) -> torch.Tensor:
    """Plain version: ``act(a . W^T + bias) + residual`` in f32, where W is
    the row-wise concatenation of ``weights``; cast to ``out_dtype``."""
    w = torch.cat([t.float() for t in weights]) if len(weights) > 1 else weights[0].float()
    y = a.float() @ w.t()
    if bias is not None:
        y = y + bias.float()
    if gelu is not None:
        y = F.gelu(y, approximate="tanh" if gelu == "tanh" else "none")
    if residual is not None:
        y = residual.float() + y
    return y.to(out_dtype or a.dtype)


def gemm(a, weights, bias=None, residual=None, out_dtype=None,
         gelu: Optional[str] = None) -> torch.Tensor:
    """``Y (M, N) = act(a (M, K) . W^T + bias) + residual``; W is one to
    three equal row segments (``weights``), read in place — Wq, Wk and Wv
    make one QKV product without a concat.  ``residual`` is f32 or a's
    dtype; ``gelu`` is None or "tanh" (the kernel's only GELU; the plain
    version also takes "erf")."""
    out_dtype = out_dtype or a.dtype
    _cuda.refuse_grad("gemm", a, *weights, bias, residual)
    if a.device.type == "cpu":
        return gemm_ref(a, weights, bias, residual, out_dtype, gelu)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on cuda or cpu tensors, got {a.device}")
    codes = _cuda.DTYPE_CODE
    if a.dtype not in codes or out_dtype not in codes:
        raise TypeError("gemm takes f32 or bf16")
    if not 1 <= len(weights) <= 3 or gelu not in _GELU_CODE:
        raise ValueError("gemm takes 1-3 weight segments and gelu None or 'tanh'")
    M, K = a.shape
    seg = weights[0].shape[0]
    N = seg * len(weights)
    tensors = list(weights) + [t for t in (bias, residual) if t is not None]
    if any(w.shape != (seg, K) or w.dtype != a.dtype for w in weights):
        raise ValueError("weight segments must be (seg, K) of a's dtype")
    if bias is not None and (bias.shape != (N,) or bias.dtype != a.dtype):
        raise ValueError("bias must be (N,) of a's dtype")
    if residual is not None and (residual.shape != (M, N)
                                 or residual.dtype not in (torch.float32, a.dtype)):
        raise ValueError("residual must be (M, N), f32 or a's dtype")
    if not all(t.is_contiguous() for t in [a] + tensors):
        raise ValueError("gemm takes contiguous tensors")
    if any(t.device != a.device for t in tensors):
        raise ValueError("gemm tensors must be on one device")
    y = torch.empty((M, N), dtype=out_dtype, device=a.device)
    w = list(weights) + [None] * (3 - len(weights))
    fn = _cuda.function("cosy_gemm")
    _cuda.check(fn(codes[a.dtype], codes[residual.dtype] if residual is not None else -1,
                   codes[out_dtype], a.data_ptr(), *(_cuda.ptr(t) for t in w), seg,
                   _cuda.ptr(bias), _cuda.ptr(residual), y.data_ptr(), M, N, K,
                   _GELU_CODE[gelu], _cuda.stream_ptr(a)), "gemm")
    gemm.launches += 1
    return y


gemm.launches = 0


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def _block(x, bias, n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2,
           heads, scale, gelu, ln, mm, attend):
    """The block's math over (rows, C) views; ``ln``/``mm``/``attend`` are
    the kernels or their plain versions."""
    B, T, C = x.shape
    cd = x.dtype
    inner = wq.shape[0]
    d = inner // heads
    x2 = x.reshape(B * T, C)
    h = ln(x2, n1w, n1b, cd)
    qkv = mm(h, (wq, wk, wv), out_dtype=cd).view(B, T, 3, heads, d)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # (B, H, T, d)
    a = attend(q, k, v, bias, scale).reshape(B * T, inner)
    x1 = mm(a, (wo,), bias=bo, residual=x2, out_dtype=torch.float32)
    h2 = ln(x1, n3w, n3b, cd)
    f = mm(h2, (w1,), bias=b1, out_dtype=cd, gelu=gelu)
    y = mm(f, (w2,), bias=b2, residual=x1, out_dtype=cd)
    return y.view(B, T, C)


def fused_transformer_block_ref(x, bias, n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b,
                                w1, b1, w2, b2, heads: int, scale: float,
                                gelu_approximate: bool = True) -> torch.Tensor:
    """Plain version of the block, with the kernels' rounding points."""
    def attend(q, k, v, bias, scale):
        return flash_attention_ref(q, k, v, bias, scale).permute(0, 2, 1, 3)

    return _block(x, bias, n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2,
                  heads, scale, "tanh" if gelu_approximate else "erf",
                  layer_norm_rows_ref, gemm_ref, attend)


def fused_transformer_block(
    x: torch.Tensor,  # (B, T, C)
    bias: Optional[torch.Tensor],  # (B, T, T) additive or None
    n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2,
    heads: int,
    scale: float,
    gelu_approximate: bool = True,
) -> torch.Tensor:
    """One inference diffusers block: seven kernel launches on CUDA tensors,
    the plain version on CPU tensors.  The kernels' GELU is the tanh
    approximation (the estimator's); erf GELU raises on CUDA."""
    _cuda.refuse_grad("fused_transformer_block", x, bias, n1w, n1b, wq, wk, wv, wo, bo,
                      n3w, n3b, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_transformer_block_ref(x, bias, n1w, n1b, wq, wk, wv, wo, bo,
                                           n3w, n3b, w1, b1, w2, b2, heads, scale,
                                           gelu_approximate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_transformer_block runs on cuda or cpu tensors, got {x.device}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, T, C) tensor")
    if not gelu_approximate:
        raise NotImplementedError("the block kernels compute tanh GELU only")

    def attend(q, k, v, bias, scale):
        B, H, T, d = q.shape
        out = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
        # (B, H, T, d) view of the (B*T, inner) rows
        flash_attention(q, k, v, bias, scale, out=out.permute(0, 2, 1, 3))
        return out

    y = _block(x, bias, n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2,
               heads, scale, "tanh", layer_norm_rows, gemm, attend)
    fused_transformer_block.launches += 1
    return y


fused_transformer_block.launches = 0


def use_fused_block(x: torch.Tensor, act_fn: str, bias_ndim: Optional[int],
                    window: Optional[int], ctx: Ctx = EVAL) -> bool:
    """Route basic_transformer_block through the kernel chain: CUDA tensors
    at inference without LoRA (the chain has no backward and reads the base
    weights only), a GELU activation, a bias that is None or (B, T, T), no
    attention window.  True at every T: the H100's engage bands are a
    measurement still to make."""
    return (x.device.type == "cuda" and not ctx.train and ctx.lora is None
            and act_fn in ("gelu", "gelu-approximate")
            and bias_ndim in (None, 3) and window is None)
