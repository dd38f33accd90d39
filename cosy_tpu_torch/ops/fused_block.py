"""The estimator's diffusers transformer block as a chain of hand kernels.

``fused_transformer_block`` is the port of the JAX package's
``ops/fused_block.py`` Pallas kernel.  For CUDA tensors it runs three
launches of hand-written kernels:

    B1 ``ln_gemm``: LN1 folded into the QKV product (``csrc/ln_gemm.cu``)
    -> kernel A ``flash_attention`` (``csrc/flash_attention.cu``)
    -> B2 ``block_tail``: out-proj (+bo, +x, f32 x1) -> LN3 -> FF1 (+b1,
       GELU) -> FF2 (+b2, +x1) in one kernel on ``wgmma`` fed by TMA, the FF
       hidden split over a cluster where row tiles alone leave SMs idle
       (``csrc/block_tail.cu``)

rounding to the compute dtype (x's dtype) at the Pallas kernel's points;
x1 stays f32 and the FF hidden never reaches device memory.  The plans
(``_ln_gemm_plan``, ``_tail_plan``) are pure functions of shape and type.
For CPU tensors it runs the plain version, ``fused_transformer_block_ref``,
built from the plain versions of B1, A and B2; any other device raises.

The row LayerNorm and the GEMM with fused epilogue of the earlier
seven-launch chain stay here as kernels of their own (``layer_norm_rows``,
``gemm``); the block's path no longer launches them.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..ctx import EVAL, Ctx
from . import _cuda
from .flash_attention import HEAD_DIM, flash_attention, flash_attention_ref

# csrc/mma.cuh ``enum Act``: the GEMM epilogue takes every code, the block
# tail B2 the two GELUs
_GELU_CODE = {None: 0, "tanh": 1, "erf": 2}


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


K_SLICE = 64  # a split's K range is a multiple of this (csrc/fused_block.cu)
# the kernel's two tiles: eight warps on 128x128 (bf16) or 128x64 (f32, which
# holds its accumulators twice), four warps on 64x64
_GEMM_TILES = ((128, 128, 8), (64, 64, 4))
_GEMM_TILES_F32 = ((128, 64, 8), (64, 64, 4))
# warps a plan wants in flight on every SM before it stops splitting K: the
# f32 blocks wait longer for each K slice (three tensor-core passes and the
# operand splits) and gain from more, the bf16 blocks do not
_WARPS_PER_SM = {torch.float32: 12, torch.bfloat16: 8}


@functools.lru_cache(maxsize=None)
def _gemm_plan(M: int, N: int, K: int, dtype=torch.float32):
    """(block_m, block_n, split_k) of the GEMM kernel for an (M, K) x (N, K)
    product: the large tile if its grid has a block for every SM, else 64x64;
    then K split 2, 4 or 8 ways (a cluster sums the partial tiles) while the
    grid's warps are short of ``_WARPS_PER_SM`` an SM and every split keeps
    at least two ``K_SLICE`` multiples.  The rule follows the sweep of
    ``python -m cosy_tpu_torch.ops.plan_sweep`` on the card (PERF.md): deep-K
    products gain from a split at every M, K = 256 products only while the
    grid is small.  A pure function of shape and type: it is passed to the
    kernel, and is no caller's option."""
    big, small = _GEMM_TILES_F32 if dtype == torch.float32 else _GEMM_TILES
    cdiv = _cuda.cdiv
    bm, bn, warps = big if cdiv(M, big[0]) * cdiv(N, big[1]) >= _cuda.SMS else small
    blocks = cdiv(M, bm) * cdiv(N, bn)
    split = 1
    while (split < 8 and blocks * split * warps < _WARPS_PER_SM[dtype] * _cuda.SMS
           and K % (2 * split * K_SLICE) == 0 and K // (2 * split) >= 2 * K_SLICE):
        split *= 2
    return bm, bn, split


def gemm_ref(a, weights, bias=None, residual=None, out_dtype=None,
             gelu: Optional[str] = None, split_k: int = 1) -> torch.Tensor:
    """Plain version: ``act(a . W^T + bias) + residual`` in f32, where W is
    the row-wise concatenation of ``weights``; cast to ``out_dtype``.  With
    ``split_k`` > 1 the product is the f32 sum, in order, of the partial
    products over the kernel's K ranges (whole ``K_SLICE`` multiples)."""
    w = torch.cat([t.float() for t in weights]) if len(weights) > 1 else weights[0].float()
    if split_k == 1:
        y = a.float() @ w.t()
    else:
        K = a.shape[1]
        per = _cuda.cdiv(_cuda.cdiv(K, K_SLICE), split_k) * K_SLICE
        y = torch.zeros((a.shape[0], w.shape[0]), dtype=torch.float32, device=a.device)
        for k0 in range(0, K, per):
            y = y + a[:, k0:k0 + per].float() @ w[:, k0:k0 + per].t()
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
    dtype; ``gelu`` is None, "tanh" or "erf" (exact GELU).  The kernel copies 16 bytes at a time: K must
    be a multiple of 8, a segment's rows a multiple of 4, and every tensor
    contiguous from a 16-byte-aligned start."""
    out_dtype = out_dtype or a.dtype
    _cuda.refuse_grad("gemm", a, *weights, bias, residual)
    if a.device.type == "cpu":
        return gemm_ref(a, weights, bias, residual, out_dtype, gelu)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on cuda or cpu tensors, got {a.device}")
    plan = check_gemm_args(a, weights, bias, residual, out_dtype, gelu)
    M, K = a.shape
    y = torch.empty((M, weights[0].shape[0] * len(weights)), dtype=out_dtype, device=a.device)
    w = list(weights) + [None] * (3 - len(weights))
    codes = _cuda.DTYPE_CODE
    fn = _cuda.function("cosy_gemm")
    _cuda.check(fn(codes[a.dtype], codes[residual.dtype] if residual is not None else -1,
                   codes[out_dtype], a.data_ptr(), *(_cuda.ptr(t) for t in w),
                   weights[0].shape[0], _cuda.ptr(bias), _cuda.ptr(residual), y.data_ptr(),
                   M, y.shape[1], K, _GELU_CODE[gelu], *plan, _cuda.stream_ptr(a)), "gemm")
    gemm.launches += 1
    return y


def check_gemm_args(a, weights, bias, residual, out_dtype, gelu):
    """Raise on anything the GEMM kernel does not take; returns its plan."""
    codes = _cuda.DTYPE_CODE
    if a.dtype not in codes or out_dtype not in codes:
        raise TypeError("gemm takes f32 or bf16")
    if not 1 <= len(weights) <= 3 or gelu not in _GELU_CODE:
        raise ValueError("gemm takes 1-3 weight segments and gelu None, 'tanh' or 'erf'")
    if a.ndim != 2 or weights[0].ndim != 2:
        raise ValueError("gemm takes a (M, K) and weight segments (seg, K)")
    M, K = a.shape
    seg = weights[0].shape[0]
    N = seg * len(weights)
    tensors = list(weights) + [t for t in (bias, residual) if t is not None]
    if any(w.shape != (seg, K) or w.dtype != a.dtype for w in weights):
        raise ValueError("weight segments must be (seg, K) of a's dtype")
    if K % 8 or seg % 4:
        raise ValueError(f"gemm takes K a multiple of 8 and segments of a multiple of 4 "
                         f"rows (16-byte copies), got K = {K}, seg = {seg}")
    if bias is not None and (bias.shape != (N,) or bias.dtype != a.dtype):
        raise ValueError("bias must be (N,) of a's dtype")
    if residual is not None and (residual.shape != (M, N)
                                 or residual.dtype not in (torch.float32, a.dtype)):
        raise ValueError("residual must be (M, N), f32 or a's dtype")
    if not all(t.is_contiguous() for t in [a] + tensors):
        raise ValueError("gemm takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in [a] + tensors):
        raise ValueError("gemm takes tensors that start on a 16-byte boundary")
    if any(t.device != a.device for t in tensors):
        raise ValueError("gemm tensors must be on one device")
    return _gemm_plan(M, N, K, a.dtype)


gemm.launches = 0


# ---------------------------------------------------------------------------
# Kernel B1: LayerNorm folded into the QKV product
# ---------------------------------------------------------------------------


LN_MAX_K = 256  # the whole x tile stays in shared memory (csrc/ln_gemm.cu kLnMaxK)
SMEM_LIMIT = 232_448  # bytes of shared memory a block may have on an H100
# (block_m, block_n) instantiations of csrc/ln_gemm.cu: 64 rows, one
# consumer warpgroup, the whole N tile; f32 holds a slice's partial sums
# beside its running sums (3xTF32, kPromote) and its W stages twice (hi, lo)
_LN_GEMM_TILES = {dtype: ((64, 64), (64, 128)) for dtype in (torch.float32, torch.bfloat16)}
_LN_STAGES = 4  # the W ring (csrc/ln_gemm.cu kStages)
_LN_SLICE = 128  # bytes of a row in a K slice: the TMA box and swizzle width
_LN_BARRIERS = LN_MAX_K * 4 // _LN_SLICE + 2 * _LN_STAGES  # x slices', the ring's


def _ln_gemm_smem_bytes(block_m: int, block_n: int, K: int, dtype, x_dtype=None) -> int:
    """Shared memory of kernel B1 (``csrc/ln_gemm.cu`` ``LnGemmSmem``):
    1024 bytes of alignment slack, the ring of W slices (f32: a hi and a lo
    slice a stage), the whole x tile in x's dtype (the weights' by
    default), the affine w and b in f32 and the barriers."""
    es = torch.finfo(dtype).bits // 8
    xs = torch.finfo(x_dtype or dtype).bits // 8
    ring = _LN_STAGES * block_n * _LN_SLICE * (2 if es == 4 else 1)
    return 1024 + ring + block_m * K * xs + 2 * K * 4 + _LN_BARRIERS * 8


@functools.lru_cache(maxsize=None)
def _ln_gemm_plan(M: int, N: int, K: int, dtype=torch.float32):
    """(block_m, block_n) of kernel B1: 64x64 tiles while their grid fits
    the SMs in one wave, else 64x128.  K is never split.  The rule follows
    the sweep of ``python -m cosy_tpu_torch.ops.plan_sweep`` (PERF.md).  A
    pure function of shape and type: it is passed to the kernel, and is no
    caller's option."""
    del K, dtype  # one rule for every depth and both types
    return (64, 64) if _cuda.cdiv(M, 64) * _cuda.cdiv(N, 64) <= _cuda.SMS else (64, 128)


def ln_gemm_ref(x, w, b, weights, out_dtype=None, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of B1: ``h = LayerNorm(x) * w + b`` with f32
    statistics, rounded to the weights' dtype, then ``h . W^T`` in f32,
    cast to ``out_dtype`` (default: the weights' dtype)."""
    cd = weights[0].dtype
    h = layer_norm_rows_ref(x, w, b, cd, eps)
    return gemm_ref(h, weights, out_dtype=out_dtype or cd)


def ln_gemm(x, w, b, weights, out_dtype=None, eps: float = 1e-5) -> torch.Tensor:
    """``Y (M, N) = LayerNorm(x (M, K)) . W^T`` in one launch: a block
    holds its x rows whole (K <= 256, a multiple of 64), takes their
    statistics and builds the product's normalised operand in registers
    while the weight slices stream in.  ``x`` is f32 or of the weights'
    dtype; ``w``, ``b`` and the one to three weight segments are of one
    dtype, the compute dtype h is rounded to."""
    out_dtype = out_dtype or weights[0].dtype
    _cuda.refuse_grad("ln_gemm", x, w, b, *weights)
    if x.device.type == "cpu":
        return ln_gemm_ref(x, w, b, weights, out_dtype, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_gemm runs on cuda or cpu tensors, got {x.device}")
    plan = check_ln_gemm_args(x, w, b, weights, out_dtype)
    M, K = x.shape
    y = torch.empty((M, weights[0].shape[0] * len(weights)), dtype=out_dtype, device=x.device)
    ws = list(weights) + [None] * (3 - len(weights))
    codes = _cuda.DTYPE_CODE
    fn = _cuda.function("cosy_ln_gemm")
    _cuda.check(fn(codes[weights[0].dtype], codes[x.dtype], codes[out_dtype], x.data_ptr(),
                   w.data_ptr(), b.data_ptr(), *(_cuda.ptr(t) for t in ws),
                   weights[0].shape[0], y.data_ptr(), M, y.shape[1], K, float(eps), *plan,
                   _cuda.stream_ptr(x)), "ln_gemm")
    ln_gemm.launches += 1
    return y


def check_ln_gemm_args(x, w, b, weights, out_dtype):
    """Raise on anything kernel B1 does not take; returns its plan."""
    codes = _cuda.DTYPE_CODE
    if not weights or weights[0].dtype not in codes or out_dtype not in codes:
        raise TypeError("ln_gemm takes f32 or bf16")
    cd = weights[0].dtype
    if x.dtype not in (torch.float32, cd) or w.dtype != cd or b.dtype != cd:
        raise TypeError("x must be f32 or of the weights' dtype, w and b of the weights' dtype")
    if x.ndim != 2 or w.shape != (x.shape[1],) or b.shape != w.shape:
        raise ValueError("ln_gemm takes x (M, K) with w, b (K,)")
    K = x.shape[1]
    if K % 64 or K > LN_MAX_K:
        raise ValueError(f"ln_gemm holds whole rows: K must be a multiple of 64 and at most "
                         f"{LN_MAX_K}, got {K}")
    if not 1 <= len(weights) <= 3 or any(t.shape != (weights[0].shape[0], K) or t.dtype != cd
                                         for t in weights):
        raise ValueError("ln_gemm takes 1-3 weight segments (seg, K) of one dtype")
    if weights[0].shape[0] % 4:
        raise ValueError("ln_gemm takes segments of a multiple of 4 rows")
    tensors = [x, w, b] + list(weights)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ln_gemm takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("ln_gemm takes tensors that start on a 16-byte boundary")
    if any(t.device != x.device for t in tensors):
        raise ValueError("ln_gemm tensors must be on one device")
    return _ln_gemm_plan(x.shape[0], weights[0].shape[0] * len(weights), K, cd)


ln_gemm.launches = 0


# ---------------------------------------------------------------------------
# Kernel B2: the block tail
# ---------------------------------------------------------------------------


TAIL_C = 256  # the block width the tail kernel is instantiated for
# (block_m, cluster, hidden sub-tile) instantiations of csrc/block_tail.cu:
# 64-row tiles (one wgmma tile), R ranks of a cluster along the FF hidden
# (R = 1: no cluster; R = 16: a non-portable cluster whose ranks pair up on
# 8 chunks of x1 columns), sub-tiles of 128 hidden columns (64 at R = 16)
_TAIL_PLANS = ((64, 1, 128), (64, 2, 128), (64, 4, 128), (64, 8, 128), (64, 16, 64))
# row tiles for which R = 16 stays fastest: 7 clusters of 16 run at once on
# an H100, an 8th waits for a second wave (plan_sweep: 440 rows 0.0305 ms,
# 500 rows 0.0598 at R = 16 against 0.0453 at R = 8, f32)
_TAIL_MAX_CLUSTERS_16 = 7
# the ring's stages (csrc/block_tail.cu TailSmem): 64 W rows (or a's 64
# rows) of a 128-byte K slice, f32 with their 3xTF32 lo beside them
_TAIL_STAGES = {torch.float32: 6, torch.bfloat16: 12}
_TAIL_W_ROWS = 64


def _tail_smem_bytes(block_m: int, dtype, C: int = TAIL_C) -> int:
    """Shared memory of one tail plan (``csrc/block_tail.cu`` ``TailSmem``):
    1024 bytes of alignment slack, the ring (a stage holds 64 rows of a
    128-byte K slice, twice in f32: hi and lo), the f32 x1 tile of block_m
    rows and the f32 FF2 sum of its shape (x's columns land there first),
    and the barriers (three a stage: landed, split, released; five for x
    and the exchanges).  The same for every cluster and sub-tile: the
    exchanges reuse the x1 tile and the FF2 sum."""
    stage = _TAIL_W_ROWS * _LN_SLICE * (2 if dtype == torch.float32 else 1)
    stages = _TAIL_STAGES[dtype]
    return 1024 + stages * stage + 2 * block_m * C * 4 + (3 * stages + 5) * 8


@functools.lru_cache(maxsize=None)
def _tail_plan(M: int, C: int, inner: int, F: int, dtype=torch.float32):
    """(block_m, cluster, sub-tile) of kernel B2: 64-row tiles, the FF
    hidden split over R ranks: 16 while the clusters of 16 run at once (up
    to 7 row tiles), 8 while row tiles x 8 blocks (one an SM) fit the SMs
    in one wave.  Past that f32, whose 3xTF32 products gain from more
    blocks, keeps 8 up to 2.5 waves, then 4; bf16 takes 2 in one wave, then
    R = 1 (no cluster, no exchange).  The rule follows the sweep of ``python -m
    cosy_tpu_torch.ops.plan_sweep`` on the card (PERF.md).  A pure function
    of shape and type: it is passed to the kernel, and is no caller's
    option."""
    del C, inner, F  # one rule for the instantiated widths
    tiles, sms = _cuda.cdiv(M, 64), _cuda.SMS
    if tiles <= _TAIL_MAX_CLUSTERS_16:
        return 64, 16, 64
    if tiles * 8 <= sms or (dtype == torch.float32 and tiles * 8 <= 2.5 * sms):
        return 64, 8, 128
    if dtype == torch.float32:
        return 64, 4, 128
    return (64, 2, 128) if tiles * 2 <= sms else (64, 1, 128)


def block_tail_ref(a, x, wo, bo, n3w, n3b, w1, b1, w2, b2, eps: float = 1e-5,
                   gelu: Optional[str] = "tanh", ranks: int = 1) -> torch.Tensor:
    """Plain version of B2, with the kernel's rounding points and splits:
    ``x1 = x + (a Wo^T + bo)`` in f32 (a rank owns whole x1 columns over all
    of K, or at 16 ranks a pair owns them over two halves of K, summed in
    order: within f32 roundings of the unsplit product); ``h2 = LN3(x1)`` rounded to the compute
    dtype (x's); the FF hidden columns cut into ``ranks`` equal chunks, each
    ``f_r = gelu(h2 W1_r^T + b1_r)`` rounded to the compute dtype and its
    partial ``f_r W2[:, r]^T`` in f32; the partials summed in rank order,
    then ``y = x1 + (sum + b2)`` cast to x's dtype."""
    cd = x.dtype
    F_ = w1.shape[0]
    if F_ % ranks:
        raise ValueError(f"block_tail_ref: {ranks} ranks do not divide the FF width {F_}")
    x1 = x.float() + (a.float() @ wo.float().t() + bo.float())
    h2 = layer_norm_rows_ref(x1, n3w, n3b, cd, eps)
    per = F_ // ranks
    ff = torch.zeros(x1.shape, dtype=torch.float32, device=x.device)
    for r in range(ranks):
        cols = slice(r * per, (r + 1) * per)
        f = gemm_ref(h2, (w1[cols],), b1[cols], out_dtype=cd, gelu=gelu)
        ff = ff + f.float() @ w2[:, cols].float().t()
    return (x1 + (ff + b2.float())).to(cd)


def block_tail(a, x, wo, bo, n3w, n3b, w1, b1, w2, b2, eps: float = 1e-5,
               gelu: str = "tanh") -> torch.Tensor:
    """``y (M, C)`` = the block after attention (out-projection with its
    residual, LN3, FF1 with GELU, FF2 with its residual) in one launch:
    64-row tiles, each split over the ranks of ``_tail_plan``'s cluster.
    ``gelu`` is "tanh" (the approximation) or "erf" (exact).  ``a``
    (M, inner) and ``x`` (M, C) and every weight share one dtype, the
    compute dtype; C = 256.  CPU tensors run ``block_tail_ref``."""
    _cuda.refuse_grad("block_tail", a, x, wo, bo, n3w, n3b, w1, b1, w2, b2)
    if gelu not in ("tanh", "erf"):
        raise ValueError(f"block_tail computes gelu 'tanh' or 'erf', got {gelu!r}")
    if x.device.type == "cpu":
        return block_tail_ref(a, x, wo, bo, n3w, n3b, w1, b1, w2, b2, eps, gelu)
    if x.device.type != "cuda":
        raise ValueError(f"block_tail runs on cuda or cpu tensors, got {x.device}")
    plan = check_tail_args(a, x, wo, bo, n3w, n3b, w1, b1, w2, b2)
    M, C = x.shape
    y = torch.empty_like(x)
    fn = _cuda.function("cosy_block_tail")
    _cuda.check(fn(_cuda.DTYPE_CODE[x.dtype], *(t.data_ptr() for t in
                                                  (a, x, wo, bo, n3w, n3b, w1, b1, w2, b2, y)),
                   M, C, a.shape[1], w1.shape[0], float(eps), _GELU_CODE[gelu], *plan,
                   _cuda.stream_ptr(x)),
                "block_tail")
    block_tail.launches += 1
    return y


def check_tail_args(a, x, wo, bo, n3w, n3b, w1, b1, w2, b2):
    """Raise on anything kernel B2 does not take; returns its plan."""
    tensors = (a, x, wo, bo, n3w, n3b, w1, b1, w2, b2)
    if x.dtype not in _cuda.DTYPE_CODE:
        raise TypeError(f"block_tail takes f32 or bf16, got {x.dtype}")
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError("block_tail takes every tensor in x's dtype")
    if x.ndim != 2 or a.ndim != 2 or a.shape[0] != x.shape[0]:
        raise ValueError("block_tail takes a (M, inner) and x (M, C)")
    (M, C), inner, F_ = x.shape, a.shape[1], w1.shape[0]
    if C != TAIL_C:
        raise ValueError(f"the block tail kernel is built for C = {TAIL_C}, got {C}")
    shapes = {"wo": (wo, (C, inner)), "bo": (bo, (C,)), "n3w": (n3w, (C,)), "n3b": (n3b, (C,)),
              "w1": (w1, (F_, C)), "b1": (b1, (F_,)), "w2": (w2, (C, F_)), "b2": (b2, (C,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"block_tail: {name} must be {shape}, got {tuple(t.shape)}")
    plan = _tail_plan(M, C, inner, F_, x.dtype)
    if inner % 128:
        raise ValueError(f"block_tail: inner {inner} is not a multiple of 128 (two halves of "
                         "the kernel's 128-byte K slices of a and Wo in either type)")
    if F_ % (plan[1] * plan[2]):
        raise ValueError(f"block_tail: the FF width {F_} is not a multiple of "
                         f"{plan[1]} ranks x {plan[2]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("block_tail takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("block_tail takes tensors that start on a 16-byte boundary")
    if any(t.device != x.device for t in tensors):
        raise ValueError("block_tail tensors must be on one device")
    return plan


block_tail.launches = 0


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def _block(x, bias, n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2,
           heads, scale, ln_mm, attend, tail):
    """The block's math over (rows, C) views; ``ln_mm``/``attend``/``tail``
    are kernels B1, A, B2 or their plain versions."""
    B, T, C = x.shape
    inner = wq.shape[0]
    d = inner // heads
    x2 = x.reshape(B * T, C)
    qkv = ln_mm(x2, n1w, n1b, (wq, wk, wv)).view(B, T, 3, heads, d)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # (B, H, T, d)
    a = attend(q, k, v, bias, scale).reshape(B * T, inner)
    return tail(a, x2, wo, bo, n3w, n3b, w1, b1, w2, b2).view(B, T, C)


def fused_transformer_block_ref(x, bias, n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b,
                                w1, b1, w2, b2, heads: int, scale: float,
                                gelu_approximate: bool = True) -> torch.Tensor:
    """Plain version of the block, with the kernels' rounding points."""
    def attend(q, k, v, bias, scale):
        return flash_attention_ref(q, k, v, bias, scale).permute(0, 2, 1, 3)

    def tail(*args):
        return block_tail_ref(*args, gelu="tanh" if gelu_approximate else "erf")

    return _block(x, bias, n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2,
                  heads, scale, ln_gemm_ref, attend, tail)


def fused_transformer_block(
    x: torch.Tensor,  # (B, T, C)
    bias: Optional[torch.Tensor],  # (B, T, T) additive or None
    n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2,
    heads: int,
    scale: float,
    gelu_approximate: bool = True,
) -> torch.Tensor:
    """One inference diffusers block: three launches (B1, A, B2) on CUDA
    tensors, the plain version on CPU tensors.  B2's GELU is the tanh
    approximation, or exact erf GELU when ``gelu_approximate`` is False."""
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
    def attend(q, k, v, bias, scale):
        B, H, T, d = q.shape
        out = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
        # (B, H, T, d) view of the (B*T, inner) rows
        flash_attention(q, k, v, bias, scale, out=out.permute(0, 2, 1, 3))
        return out

    def tail(*args):
        return block_tail(*args, gelu="tanh" if gelu_approximate else "erf")

    y = _block(x, bias, n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2,
               heads, scale, ln_gemm, attend, tail)
    fused_transformer_block.launches += 1
    return y


fused_transformer_block.launches = 0


def use_fused_block(x: torch.Tensor, act_fn: str, bias_ndim: Optional[int],
                    window: Optional[int], ctx: Ctx = EVAL) -> bool:
    """Route basic_transformer_block through the kernel chain: CUDA tensors
    at inference without LoRA (the chain has no backward and reads the base
    weights only), a GELU activation, a bias that is None or (B, T, T), no
    attention window.  True at every T."""
    return (x.device.type == "cuda" and not ctx.train and ctx.lora is None
            and act_fn in ("gelu", "gelu-approximate")
            and bias_ndim in (None, 3) and window is None)


KERNEL_HEADS = 8  # the estimator's heads at HEAD_DIM: the inner width 512 B1 and B2 take
KERNEL_WIDTHS = (f"channels {TAIL_C} at every level, {KERNEL_HEADS} heads x {HEAD_DIM}, "
                 f"FF 4 x {TAIL_C}")


def require_kernel_widths(est_cfg, device) -> None:
    """Refuse, before any weight is built or kernel runs, an estimator whose
    widths the CUDA kernels are not built for when ``device`` is CUDA: one
    message that names the widths (``KERNEL_WIDTHS``).  Other devices run
    the plain versions at any width.  ``device`` is only named, never
    resolved, so the check needs no card."""
    if torch.device(device).type != "cuda":
        return
    if (all(c == TAIL_C for c in est_cfg.channels) and est_cfg.num_heads == KERNEL_HEADS
            and est_cfg.attention_head_dim == HEAD_DIM):
        return
    raise ValueError(
        f"the CUDA kernels are built for the estimator widths {KERNEL_WIDTHS}; this "
        f"estimator has channels {tuple(est_cfg.channels)}, {est_cfg.num_heads} heads x "
        f"{est_cfg.attention_head_dim}: run it with device='cpu'")
