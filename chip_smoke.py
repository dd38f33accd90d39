#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (cosy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught and passed over):
  1. the card: name, power limit;
  2. build of the CUDA kernels from cosy_tpu_torch/csrc (nvcc, sm_90a) into
     build/cosy_tpu_torch/;
  3. every kernel against its plain PyTorch version on the card, on the same
     inputs, within a stated tolerance, with its time, the plain version's
     time and one library call's time as a yardstick (TF32 off for matmul
     and cuDNN in every comparison; CUDA-event means of back-to-back calls,
     and beside them the kernels' own time on the card from torch.profiler
     (ops/plan_sweep.py device_ms), which leaves out the waits for the host);
     the block's kernels B1 (ln_gemm) and B2 (block_tail) at 312, 624 and
     5116 rows in f32 and bf16, the block beside the seven-launch chain of
     the kept LayerNorm and GEMM kernels; A, the block, B1 and B2 at the
     streaming path's shapes (206 / 103 frames without a bias, the final
     bucket's 220 / 110 with one; 412, 206, 440 and 220 rows) with the
     plans they pick; the plans that split return the same bits on two
     calls;
  4. one full-width estimator call on the card (kernels) against the same
     call on the CPU (plain versions);
  5. full-width prompt-free CosyVoice-300M synthesis on random seeded
     weights through TTSPipeline.synthesize, with the launch counters reset
     just before and read just after: every kernel of the path must have
     run, the fused block, B1 and B2 exactly 64 x NFE times (three launches
     a block) and the LayerNorm and GEMM kernels not at all;
  6. where the time goes: one estimator call at the main path's shape under
     torch.profiler (device busy share, device time by kernel);
  7. the windowed long-utterance configuration: full-width synthesis of 1485
     seeded speech tokens (2558 mel frames, NFE 20) through
     TTSPipeline.token2wav with attn_window = 256, counters reset before and
     read after: banded attention (kernel C) exactly 64 x NFE times and no
     fused block; then the same tokens with full attention, both flow times
     and the relative difference of the two mels;
  8. the joint LoRA training step at full width: JointTrainer in joint mode,
     bf16 compute, 3 steps on one seeded super-batch (accumulation 2 x batch
     8, 250 mel frames): finite losses, a gradient, a falling loss, base
     weights bit-identical, no kernel launched, and merged weights that
     synthesize;
  9. streaming synthesis at full width: 20 seeded text ids decode exactly
     400 tokens (EOS held off, cap 400) through
     TTSPipeline.synthesize(stream=True): three 120-token windows and a
     bucketed final of 100, chunk lengths as stream_plan says, every chunk
     finite, counters reset before and read after: 64 x NFE 40 fused
     blocks of three launches, no LayerNorm or GEMM launch; the streamed
     tokens equal generate_tokens'; time to the first chunk and seconds per
     chunk;
 10. batched serving: 4 requests of 6-12 ids (120-240 tokens) through
     synthesize_batch, batched tokens against the 4 solo decodes (equal,
     or at the first diverging step a teacher-forced logit gap within
     1e-4 * max(1, max|logit|)), decode tokens/s at B = 4 against B = 1;
     then 6 requests through ContinuousBatchEngine(slots=4): all finish, one
     at least admitted mid-flight, each stream its solo decode's, every
     chunk finite and as planned, 64 x the chunks' NFE fused blocks.
It prints a JSON "kernels" line (its times are the on-card ones of phase 3),
the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing any result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from cosy_tpu_torch import ops  # noqa: E402
from cosy_tpu_torch.config import InferenceConfig, ModelConfig, TrainConfig  # noqa: E402
from cosy_tpu_torch.infer.engine import ContinuousBatchEngine  # noqa: E402
from cosy_tpu_torch.infer.pipeline import (StreamState, TTSPipeline,  # noqa: E402
                                           _batch_prefixes, stream_seed)
from cosy_tpu_torch.layers.unet import conditional_decoder  # noqa: E402
from cosy_tpu_torch.models.flow import Flow, flow_inference, init_flow_params  # noqa: E402
from cosy_tpu_torch.models.hift import init_hift_params  # noqa: E402
from cosy_tpu_torch.models.llm import (TransformerLM, init_llm_params,  # noqa: E402
                                       llm_teacher_forced_logits)
from cosy_tpu_torch.ops import _cuda  # noqa: E402
from cosy_tpu_torch.ops.flash_attention import (_attention_plan,  # noqa: E402
                                                banded_attention, banded_attention_ref,
                                                flash_attention, flash_attention_ref)
from cosy_tpu_torch.ops.fused_block import (_gemm_plan, _ln_gemm_plan,  # noqa: E402
                                            _tail_plan, block_tail, block_tail_ref,
                                            fused_transformer_block,
                                            fused_transformer_block_ref, gemm, gemm_ref,
                                            layer_norm_rows, layer_norm_rows_ref, ln_gemm,
                                            ln_gemm_ref)
from cosy_tpu_torch.ops.plan_sweep import device_ms  # noqa: E402
from cosy_tpu_torch.params import P, load_torch_checkpoint  # noqa: E402
from cosy_tpu_torch.train.trainer import JointTrainer  # noqa: E402

DEV = torch.device("cuda")
# H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# (atol, rtol) of each kernel against its plain version: f32 sums taken in
# another order; bf16 intermediates that round to a neighbouring value
TOL = {
    ("attention", torch.float32): (1e-5, 1e-5),
    ("attention", torch.bfloat16): (1e-2, 2e-2),
    ("block", torch.float32): (1e-4, 1e-4),
    ("block", torch.bfloat16): (5e-2, 2e-2),
    ("layer_norm", torch.float32): (1e-5, 1e-5),
    ("gemm", torch.float32): (1e-4, 1e-4),
    # both round one f32 sum to bf16; sums taken in another order can land on
    # the neighbouring bf16 value, one ulp (2^-8 relative) away
    ("gemm", torch.bfloat16): (1e-2, 1e-2),
    ("ln_gemm", torch.float32): (1e-4, 1e-4),
    ("ln_gemm", torch.bfloat16): (1e-2, 1e-2),
    ("block_tail", torch.float32): (1e-4, 1e-4),
    ("block_tail", torch.bfloat16): (1e-2, 1e-2),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype):
    """Least time (ms) the card could take: operations over the peak of the
    type, or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(kind, got, want, dtype):
    atol, rtol = TOL[(kind, dtype)]
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got.float(), want.float(),
                                                            atol=atol, rtol=rtol)
    tol = f"tol atol={atol:g} rtol={rtol:g}"
    if dtype == torch.bfloat16:
        # the error in bf16 ulps at the output's scale, 2^(e - 7) for
        # max|want| in [2^e, 2^(e+1))
        ulp = 2.0 ** (np.floor(np.log2(max(want.float().abs().max().item(), 2 ** -126))) - 7)
        tol += f"; {err / ulp:.2f} ulp of max|y|"
    return err, ok, tol


# ---------------------------------------------------------------------------
# kernel A: flash attention
# ---------------------------------------------------------------------------


def attention_case(g, B, H, T, S, dtype, masked=True, iters=20, pad_from=None):
    """``masked``: a padding bias, a fully masked row and a short k_valid;
    else ``pad_from``: the estimator's bias of a masked mel (keys from
    ``pad_from`` on at -1e10 in every row), or no bias at all."""
    q = torch.randn(B, H, T, 64, device=DEV, generator=g).to(dtype)
    k = torch.randn(B, H, S, 64, device=DEV, generator=g).to(dtype)
    v = torch.randn(B, H, S, 64, device=DEV, generator=g).to(dtype)
    bias = torch.zeros(B, T, S, device=DEV)
    kv = None
    if masked:
        bias[-1, :, S - S // 10:] = -1e10  # right padding
        bias[0, min(3, T - 1), :] = -1e10  # one fully masked row
        kv = torch.tensor([S] * (B - 1) + [S - 17], dtype=torch.int32, device=DEV)
    elif pad_from is not None:
        bias[:, :, pad_from:] = -1e10
    else:
        bias = None
    bias = None if bias is None else bias.to(dtype)
    scale = 64 ** -0.5
    got = flash_attention(q, k, v, bias, scale, kv)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, bias, scale, kv)
    err, ok, tol = compare("attention", got, want, dtype)
    mask = bias  # the library call gets the k_valid cut folded into its mask
    if kv is not None:
        mask = bias.masked_fill(torch.arange(S, device=DEV)[None, None, :]
                                >= kv[:, None, None], -1e10)
    mask = None if mask is None else mask[:, None]
    ms = cuda_ms(lambda: flash_attention(q, k, v, bias, scale, kv), iters)
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, bias, scale, kv), max(2, iters // 4))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale),
                  iters)
    bms, by = bound(4 * B * H * T * S * 64, nbytes(q, k, v, got, bias, kv), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by,
                dev_ms=device_ms(lambda: flash_attention(q, k, v, bias, scale, kv)),
                plain_dev_ms=device_ms(lambda: flash_attention_ref(q, k, v, bias, scale, kv), 3),
                lib_dev_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale)))


# ---------------------------------------------------------------------------
# kernel C: banded attention
# ---------------------------------------------------------------------------


def banded_case(g, B, H, T, window, dtype, kv=None, iters=10):
    """Kernel C against its plain version on the rows t < k_valid[b] (the
    others have no defined value), with the plain version, SDPA under the
    band as a boolean mask, and kernel A under the band as a bias timed on
    the same inputs.  The bound counts the admitted (t, s) pairs of this
    call's band and k_valid."""
    q, k, v = (torch.randn(B, H, T, 64, device=DEV, generator=g).to(dtype) for _ in range(3))
    k_valid = None if kv is None else torch.tensor(kv, dtype=torch.int32, device=DEV)
    scale = 64 ** -0.5
    got = banded_attention(q, k, v, scale, window, k_valid)
    torch.cuda.synchronize()
    want = banded_attention_ref(q, k, v, scale, window, k_valid)
    pos = torch.arange(T, device=DEV)
    ok = ((pos[:, None] - pos[None, :]).abs() <= window)[None].expand(B, T, T)
    if k_valid is not None:
        rows = (pos[None, :] < k_valid[:, None])[:, None, :, None]
        got_c, want_c = got * rows, want * rows
        ok = ok & (pos[None, None, :] < k_valid[:, None, None])
    else:
        got_c, want_c = got, want
    err, good, tol = compare("attention", got_c, want_c, dtype)
    good = good and bool(torch.isfinite(got).all())
    pairs = int(ok.sum().item())
    bias = torch.where(ok, 0.0, -1e10).to(dtype).contiguous()
    ms = cuda_ms(lambda: banded_attention(q, k, v, scale, window, k_valid), iters)
    plain = cuda_ms(lambda: banded_attention_ref(q, k, v, scale, window, k_valid),
                    max(2, iters // 4))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=ok[:, None],
                                                         scale=scale), iters)
    a_ms = cuda_ms(lambda: flash_attention(q, k, v, bias, scale), iters)
    bms, by = bound(4 * H * pairs * 64, nbytes(q, k, v, got, k_valid), dtype)
    return dict(err=err, ok=good, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                kernel_a_ms=a_ms, bound_ms=bms, bound_by=by,
                dev_ms=device_ms(lambda: banded_attention(q, k, v, scale, window, k_valid)),
                plain_dev_ms=device_ms(
                    lambda: banded_attention_ref(q, k, v, scale, window, k_valid), 3),
                lib_dev_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=ok[:, None], scale=scale)))


# ---------------------------------------------------------------------------
# kernel B: the transformer block chain (and its LayerNorm and GEMM kernels)
# ---------------------------------------------------------------------------


def block_weights(g, dtype, C=256, inner=512, ff=1024):
    def mk(*s, scale=0.05, one=False):
        w = torch.randn(*s, device=DEV, generator=g) * scale
        return (w + 1.0 if one else w).to(dtype)

    return [mk(C, one=True), mk(C), mk(inner, C), mk(inner, C), mk(inner, C), mk(C, inner),
            mk(C), mk(C, one=True), mk(C), mk(ff, C), mk(ff), mk(C, ff), mk(C)]


def library_block(x, bias, W, heads):
    """The block as a sequence of PyTorch library calls (layer_norm, linear,
    scaled_dot_product_attention, gelu): a yardstick only.  No single
    PyTorch call computes it (nn.TransformerEncoderLayer needs the attention
    width to equal the model width; here it is 512 against 256), so the
    kernels line reports library_ms null for the block."""
    B, T, C = x.shape
    n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2 = W
    wqkv = torch.cat([wq, wk, wv])
    d = wq.shape[0] // heads
    mask = None if bias is None else bias[:, None]

    def run():
        h = F.layer_norm(x, (C,), n1w, n1b, 1e-5)
        q, k, v = F.linear(h, wqkv).view(B, T, 3, heads, d).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        x1 = x + F.linear(a.transpose(1, 2).reshape(B, T, heads * d), wo, bo)
        f = F.gelu(F.linear(F.layer_norm(x1, (C,), n3w, n3b, 1e-5), w1, b1), approximate="tanh")
        return x1 + F.linear(f, w2, b2)

    return run


def seven_launch_block(x, bias, W, heads, scale):
    """The block as the seven-launch chain of the port's kept LayerNorm and
    GEMM kernels with kernel A between them (the block's path before B1 and
    B2 existed): a yardstick of the same arithmetic in more launches."""
    B, T, C = x.shape
    n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2 = W
    inner, cd = wq.shape[0], x.dtype
    d = inner // heads

    def run():
        x2 = x.reshape(B * T, C)
        qkv = gemm(layer_norm_rows(x2, n1w, n1b, cd), (wq, wk, wv)).view(B, T, 3, heads, d)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        a = torch.empty((B, T, heads, d), dtype=cd, device=x.device)
        flash_attention(q, k, v, bias, scale, out=a.permute(0, 2, 1, 3))
        x1 = gemm(a.reshape(B * T, inner), (wo,), bias=bo, residual=x2, out_dtype=torch.float32)
        f = gemm(layer_norm_rows(x1, n3w, n3b, cd), (w1,), bias=b1, gelu="tanh")
        return gemm(f, (w2,), bias=b2, residual=x1, out_dtype=cd).view(B, T, C)

    return run


def block_case(g, B, T, dtype, with_bias, iters=20, heads=8, pad_from=None):
    W = block_weights(g, dtype)
    C, inner, ff = 256, 512, 1024
    x = torch.randn(B, T, C, device=DEV, generator=g).to(dtype)
    bias = None
    if with_bias:
        bias = torch.zeros(B, T, T, device=DEV)
        if pad_from is None:
            bias[-1, :, T - T // 10:] = -1e10
        else:
            bias[:, :, pad_from:] = -1e10
        bias = bias.to(dtype)
    scale = (inner // heads) ** -0.5
    got = fused_transformer_block(x, bias, *W, heads=heads, scale=scale)
    torch.cuda.synchronize()
    want = fused_transformer_block_ref(x, bias, *W, heads=heads, scale=scale)
    err, ok, tol = compare("block", got, want, dtype)
    ms = cuda_ms(lambda: fused_transformer_block(x, bias, *W, heads=heads, scale=scale), iters)
    plain = cuda_ms(lambda: fused_transformer_block_ref(x, bias, *W, heads=heads, scale=scale),
                    max(2, iters // 4))
    unfused = cuda_ms(library_block(x, bias, W, heads), iters)
    chain7 = seven_launch_block(x, bias, W, heads, scale)
    err7 = (chain7().float() - want.float()).abs().max().item()
    flops = 2 * B * T * (3 * C * inner + inner * C + 2 * C * ff) + 4 * B * heads * T * T * (inner // heads)
    bms, by = bound(flops, nbytes(x, got, bias, *W), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=None,
                unfused_ms=unfused, bound_ms=bms, bound_by=by,
                chain7_ms=cuda_ms(chain7, iters), chain7_dev_ms=device_ms(chain7),
                chain7_err=err7,
                dev_ms=device_ms(lambda: fused_transformer_block(x, bias, *W, heads=heads,
                                                                 scale=scale)),
                plain_dev_ms=device_ms(lambda: fused_transformer_block_ref(
                    x, bias, *W, heads=heads, scale=scale), 3),
                lib_dev_ms=device_ms(library_block(x, bias, W, heads)))


def layer_norm_case(g, rows, C=256, iters=50):
    dtype = torch.float32
    x = torch.randn(rows, C, device=DEV, generator=g)
    w, b = torch.randn(C, device=DEV, generator=g), torch.randn(C, device=DEV, generator=g)
    got = layer_norm_rows(x, w, b, dtype)
    torch.cuda.synchronize()
    err, ok, tol = compare("layer_norm", got, layer_norm_rows_ref(x, w, b, dtype), dtype)
    ms = cuda_ms(lambda: layer_norm_rows(x, w, b, dtype), iters)
    plain = cuda_ms(lambda: layer_norm_rows_ref(x, w, b, dtype), iters)
    lib = cuda_ms(lambda: F.layer_norm(x, (C,), w, b, 1e-5), iters)
    bms, by = bound(8 * rows * C, nbytes(x, w, b, got), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by,
                dev_ms=device_ms(lambda: layer_norm_rows(x, w, b, dtype)),
                plain_dev_ms=device_ms(lambda: layer_norm_rows_ref(x, w, b, dtype), 3),
                lib_dev_ms=device_ms(lambda: F.layer_norm(x, (C,), w, b, 1e-5)))


def gemm_case(g, M, K, seg, nseg=1, bias=False, gelu=None, residual=False, iters=50,
              dtype=torch.float32):
    """One of the block's products with its epilogue: ``nseg`` (seg, K)
    weight segments read in place (3 for the QKV product), optional bias,
    tanh GELU and f32 residual, as the block's four launches use them."""
    N = nseg * seg
    a = torch.randn(M, K, device=DEV, generator=g).to(dtype)
    ws = [(torch.randn(seg, K, device=DEV, generator=g) * 0.05).to(dtype) for _ in range(nseg)]
    w_cat = torch.cat(ws)
    b = (torch.randn(N, device=DEV, generator=g) * 0.05).to(dtype) if bias else None
    r = torch.randn(M, N, device=DEV, generator=g) if residual else None

    def run():
        return gemm(a, ws, b, r, gelu=gelu)

    def run_ref():
        return gemm_ref(a, ws, b, r, gelu=gelu)

    def run_lib():
        y = F.linear(a, w_cat, b)
        y = F.gelu(y, approximate="tanh") if gelu else y
        return (y + r).to(dtype) if residual else y

    got = run()
    torch.cuda.synchronize()
    err, ok, tol = compare("gemm", got, run_ref(), dtype)
    ms = cuda_ms(run, iters)
    plain = cuda_ms(run_ref, iters)
    lib = cuda_ms(run_lib, iters)
    bms, by = bound(2 * M * N * K, nbytes(a, w_cat, b, r, got), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, plan=_gemm_plan(M, N, K, dtype),
                dev_ms=device_ms(run), plain_dev_ms=device_ms(run_ref, 3),
                lib_dev_ms=device_ms(run_lib))


def ln_gemm_case(g, M, dtype, iters=20, C=256, inner=512):
    """Kernel B1 on the block's QKV product: LN1 of x (M, C) and the three
    (inner, C) segments read in place, against ln_gemm_ref; the library
    yardstick is F.layer_norm then one F.linear (two calls: no single
    PyTorch call computes it)."""
    x = torch.randn(M, C, device=DEV, generator=g).to(dtype)
    w = (torch.randn(C, device=DEV, generator=g) * 0.05 + 1.0).to(dtype)
    b = (torch.randn(C, device=DEV, generator=g) * 0.05).to(dtype)
    ws = [(torch.randn(inner, C, device=DEV, generator=g) * 0.05).to(dtype) for _ in range(3)]
    w_cat = torch.cat(ws)
    plan = _ln_gemm_plan(M, 3 * inner, C, dtype)

    def run():
        return ln_gemm(x, w, b, ws)

    def run_ref():
        return ln_gemm_ref(x, w, b, ws)

    def run_lib():
        return F.linear(F.layer_norm(x, (C,), w, b, 1e-5), w_cat)

    got = run()
    torch.cuda.synchronize()
    err, ok, tol = compare("ln_gemm", got, run_ref(), dtype)
    bms, by = bound(2 * M * 3 * inner * C + 8 * M * C, nbytes(x, w, b, w_cat, got), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=cuda_ms(run, iters), plain_ms=cuda_ms(run_ref, iters),
                library_ms=None, unfused_ms=cuda_ms(run_lib, iters), bound_ms=bms, bound_by=by,
                plan=plan, dev_ms=device_ms(run), plain_dev_ms=device_ms(run_ref, 3),
                lib_dev_ms=device_ms(run_lib), same=torch.equal(run(), run()))


def tail_case(g, M, dtype, iters=20, C=256, inner=512, ff=1024):
    """Kernel B2 on the block's shapes against block_tail_ref with the
    plan's ranks; the library yardstick is the unfused sequence F.linear,
    add, F.layer_norm, F.linear, F.gelu, F.linear, add."""
    def mk(*shape, scale=0.05, one=False):
        t = torch.randn(*shape, device=DEV, generator=g) * scale
        return (t + 1.0 if one else t).to(dtype)

    a, x = mk(M, inner, scale=1.0), mk(M, C, scale=1.0)
    W = (mk(C, inner), mk(C), mk(C, one=True), mk(C), mk(ff, C), mk(ff), mk(C, ff), mk(C))
    wo, bo, n3w, n3b, w1, b1, w2, b2 = W
    plan = _tail_plan(M, C, inner, ff, dtype)

    def run():
        return block_tail(a, x, *W)

    def run_ref():
        return block_tail_ref(a, x, *W, ranks=plan[1])

    def run_lib():
        x1 = x.float() + F.linear(a, wo, bo)
        f = F.gelu(F.linear(F.layer_norm(x1.to(dtype), (C,), n3w, n3b, 1e-5), w1, b1),
                   approximate="tanh")
        return (x1 + F.linear(f, w2, b2)).to(dtype)

    got = run()
    torch.cuda.synchronize()
    err, ok, tol = compare("block_tail", got, run_ref(), dtype)
    bms, by = bound(2 * M * (C * inner + 2 * C * ff), nbytes(a, x, *W, got), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=cuda_ms(run, iters), plain_ms=cuda_ms(run_ref, iters),
                library_ms=None, unfused_ms=cuda_ms(run_lib, iters), bound_ms=bms, bound_by=by,
                plan=plan, dev_ms=device_ms(run), plain_dev_ms=device_ms(run_ref, 3),
                lib_dev_ms=device_ms(run_lib), same=torch.equal(run(), run()))


def same_twice(g):
    """The plans that split (K of a product over a cluster, the keys of an
    attention call over a cluster) sum in a fixed order: two calls on the
    same inputs must return the same bits."""
    a = torch.randn(312, 1024, device=DEV, generator=g)
    w = [torch.randn(256, 1024, device=DEV, generator=g) * 0.05]
    r = torch.randn(312, 256, device=DEV, generator=g)
    q = torch.randn(2, 8, 128, 64, device=DEV, generator=g)
    k, v = (torch.randn(2, 8, 8320, 64, device=DEV, generator=g) for _ in range(2))
    gp, ap = _gemm_plan(312, 256, 1024, torch.float32), _attention_plan(16, 128, 8320)
    if gp[2] < 2 or ap[1] < 2:
        raise SystemExit(f"chip_smoke: the plans {gp}, {ap} do not split where they should")
    same_g = torch.equal(gemm(a, w, None, r), gemm(a, w, None, r))
    same_a = torch.equal(flash_attention(q, k, v, None, 0.125), flash_attention(q, k, v, None, 0.125))
    log(f"  two calls, same bits: gemm (312,1024)x(256,1024) plan {gp} {same_g}; "
        f"flash_attention (2,8,128,64) S=8320 plan {ap} {same_a}")
    if not (same_g and same_a):
        raise SystemExit("chip_smoke: a split plan's result changed from one call to the next")


def profile_device(fn):
    """Run ``fn`` once under torch.profiler.  Returns (wall ms on the host
    clock around the call and a synchronize, device busy ms as the union of
    the kernels' time ranges, {kernel name: (launches, device ms)}); busy is
    None when the profiler recorded no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return wall_ms, None, {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3  # us -> ms
    by_name = {}
    for e in kernels:
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + (e.time_range.end - e.time_range.start) / 1e3)
    return wall_ms, busy, by_name


def log_profile(wall_ms, plain_wall_ms, busy, by_name, top=10):
    if busy is None:
        log(f"  wall {wall_ms:.3f} ms; the profiler recorded no device events")
        return
    log(f"  wall {wall_ms:.3f} ms profiled ({plain_wall_ms:.3f} ms without the profiler), "
        f"device busy {busy:.3f} ms, idle share {1 - busy / plain_wall_ms:.3f} of the "
        f"unprofiled wall, {sum(n for n, _ in by_name.values())} kernel launches")
    for n, (cnt, tot) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  {tot:9.3f} ms {100 * tot / busy:5.1f}% x{cnt:<5d} {n[:90]}")


def estimator_args(T, masked, seed=7):
    """Inputs of one estimator call at CFG batch 2; ``masked`` marks the
    last frame as padding (mask and (B, T, T) bias, as an odd mel length)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x, mu, cond = (torch.randn(2, 80, T, device=DEV, generator=gen) for _ in range(3))
    mask = None
    if masked:
        mask = torch.ones(2, 1, T, device=DEV)
        mask[:, :, T - 1:] = 0.0
    return (x, mask, mu, torch.rand(2, device=DEV, generator=gen),
            torch.randn(2, 80, device=DEV, generator=gen), cond)


def where_time_goes(est, ecfg, T, masked=True):
    """Device busy share and device time by kernel for one estimator call
    (B=2, T frames), from torch.profiler's CUDA events; wall time on the
    host clock around the call."""
    args = estimator_args(T, masked)
    with torch.inference_mode():
        conditional_decoder(est, ecfg, *args)
        wall_ms, busy, by_name = profile_device(lambda: conditional_decoder(est, ecfg, *args))
        plain_wall = cuda_ms(lambda: conditional_decoder(est, ecfg, *args), 3)
    log_profile(wall_ms, plain_wall, busy, by_name)


def windowed_synthesis(cfg, llm, flow, hift, n_tokens=1485, window=256):
    """Phase 7.  Returns the launch counts of the windowed run."""
    log(f"[7] windowed long-utterance synthesis: {n_tokens} seeded speech tokens through "
        f"TTSPipeline.token2wav, attn_window = {window} against full attention")
    T_mel = int(n_tokens / cfg.flow.input_frame_rate * 22050 / 256)
    nfe = 20
    if T_mel % 2 or T_mel <= 500:
        raise SystemExit(f"chip_smoke: {T_mel} mel frames would pad (mask, no window) or cut NFE")
    est_w = dataclasses.replace(cfg.flow.estimator, attn_window=window)
    cfg_w = dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, estimator=est_w))
    tokens = np.random.default_rng(8).integers(0, cfg.flow.vocab_size, (1, n_tokens))
    spk = np.random.default_rng(9).standard_normal((1, cfg.flow.spk_embed_dim)).astype(np.float32)
    out = {}
    for name, c in (("windowed", cfg_w), ("full", cfg)):
        pipe = TTSPipeline(c, llm, flow, hift, finetuned_norm=True)
        ops.reset_launch_counts()
        with torch.inference_mode():
            wav = pipe.token2wav(tokens, spk, generator=torch.Generator(device=DEV).manual_seed(10))
        out[name] = (ops.launch_counts(), dict(pipe.stage_seconds), wav)
        log(f"  {name}: stages (s) " + ", ".join(f"{k} {v:.3f}" for k, v in pipe.stage_seconds.items())
            + f"; waveform {wav.shape}, finite {bool(np.isfinite(wav).all())}; "
            f"launches {out[name][0]}")
        if wav.shape != (1, 256 * T_mel) or not np.isfinite(wav).all():
            raise SystemExit(f"chip_smoke: {name} synthesis output has the wrong shape or is not finite")
    cw, cf = out["windowed"][0], out["full"][0]
    if cw["banded_attention"] != 64 * nfe or cw["fused_transformer_block"] != 0 \
            or cw["flash_attention"] != 0 or cw["ln_gemm"] != 0 or cw["block_tail"] != 0:
        raise SystemExit(f"chip_smoke: windowed launch counts {cw} off 64 x NFE {nfe} of kernel C")
    if cf["fused_transformer_block"] != 64 * nfe or cf["ln_gemm"] != 64 * nfe \
            or cf["block_tail"] != 64 * nfe or cf["banded_attention"] != 0:
        raise SystemExit(f"chip_smoke: full-attention launch counts {cf} off 64 x NFE {nfe}")
    # the two mels from one initial noise
    z = torch.randn((1, 80, T_mel), device=DEV, generator=torch.Generator(device=DEV).manual_seed(10))
    tok = torch.as_tensor(tokens, dtype=torch.long, device=DEV)
    none_tok = torch.zeros((1, 0), dtype=torch.long, device=DEV)
    none_feat = torch.zeros((1, 0, 80), device=DEV)
    with torch.inference_mode():
        mels = [flow_inference(P(dict(flow.named_parameters())), c.flow, tok, none_tok, none_feat,
                               torch.as_tensor(spk, device=DEV), n_timesteps=nfe,
                               finetuned_norm=True, z=z) for c in (cfg_w, cfg)]
    rel = ((mels[0] - mels[1]).norm() / mels[1].norm()).item()
    fw, ff = out["windowed"][1]["flow"], out["full"][1]["flow"]
    log(f"  flow stage: windowed {fw:.3f} s, full {ff:.3f} s ({ff / fw:.2f}x); relative mel "
        f"difference ||windowed - full|| / ||full|| = {rel:.4f} ({T_mel} frames, NFE {nfe}, "
        f"random seeded weights)")
    if not (np.isfinite(rel) and 0.0 < rel < 1.0):
        raise SystemExit("chip_smoke: the windowed mel equals the full one or is far from it")
    est = P(dict(flow.named_parameters())).sub("decoder.estimator")
    log(f"  one estimator call (B=2, no mask), window {window} against full attention: wall ms "
        "(CUDA events, 3 calls) and device busy ms (torch.profiler, 1 call)")
    with torch.inference_mode():
        for T in (512, 768, 1024, 1280, 1536, 2048, 2558):
            args = estimator_args(T, masked=False)
            row = []
            for ecfg in (est_w, cfg.flow.estimator):
                call = lambda: conditional_decoder(est, ecfg, *args)  # noqa: E731
                row += [cuda_ms(call, 3), profile_device(call)[1]]
            log(f"    T={T:<5d} windowed {row[0]:7.2f} wall {row[1]:7.2f} busy | full "
                f"{row[2]:7.2f} wall {row[3]:7.2f} busy | full / windowed {row[2] / row[0]:.2f}x "
                f"wall {row[3] / row[1]:.2f}x busy")
    log(f"  where the windowed call's time goes (B=2, T={T_mel}, window {window}), torch.profiler")
    where_time_goes(est, est_w, T_mel, masked=False)
    return cw


def training_steps(cfg, llm, flow, hift, steps=3):
    """Phase 8."""
    # the defaults but for the warm-up: with 50 warm-up steps the first
    # three learning rates are 0, 4e-6 and 8e-6, too small to show a falling
    # loss in 3 steps
    tcfg = TrainConfig(warmup_steps=0)
    accum, B, T = tcfg.accumulate_grad_batches, tcfg.batch_size, tcfg.max_feat_len
    n_tok, n_text = tcfg.max_token_len, 30
    log(f"[8] joint LoRA training, full width, bf16 {tcfg.bf16}: {steps} steps on one seeded "
        f"super-batch (accumulation {accum} x batch {B}, {T} mel frames, {n_tok} speech "
        f"tokens, {n_text} text tokens), lr {tcfg.learning_rate:g} without warm-up")
    rng = np.random.default_rng(12)
    sb = {
        "text_token": rng.integers(0, cfg.llm.text_token_size, (accum, B, n_text)).astype(np.int32),
        "text_token_len": np.full((accum, B), n_text, np.int32),
        "speech_token": rng.integers(0, cfg.llm.speech_token_size, (accum, B, n_tok)).astype(np.int32),
        "speech_token_len": np.full((accum, B), n_tok, np.int32),
        "speech_feat": (rng.standard_normal((accum, B, T, 80)) * 2 - 6).astype(np.float32),
        "speech_feat_len": np.full((accum, B), T, np.int32),
        "embedding": rng.standard_normal((accum, B, 192)).astype(np.float32),
    }
    base = {n: {k: v.clone() for k, v in m.state_dict().items()}
            for n, m in (("llm", llm), ("flow", flow))}
    counts0 = ops.launch_counts()

    def run(mode, n):
        with tempfile.TemporaryDirectory() as tmp:
            tr = JointTrainer(cfg, dataclasses.replace(tcfg, training_mode=mode), llm, flow,
                              out_dir=tmp, total_steps=1000)
            state = tr.init_state(torch.Generator(device=DEV).manual_seed(13))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            hist, secs = [], []
            for _ in range(n):
                t0 = time.perf_counter()
                m = tr.step(state, sb, torch.Generator(device=DEV).manual_seed(14))
                hist.append({k: float(v) for k, v in m.items()})  # waits for the device
                secs.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            merged = None
            if mode == "joint":
                tr.export_merged(state, save=True)
                merged = {n: load_torch_checkpoint(os.path.join(tmp, f"{n}_merged_joint.pt"))
                          for n in ("llm", "flow")}
                with open(os.path.join(tmp, "flow_merged_joint.pt.meta.json")) as f:
                    if json.load(f)["mel_space"] != "normalized":
                        raise SystemExit("chip_smoke: merged flow weights lack their mel-space note")
        return hist, secs, peak, merged, sum(v.numel() for d in state.loras.values() for v in d.values())

    hist, secs, peak, merged, n_lora = run("joint", steps)
    for i, m in enumerate(hist):
        log(f"  step {i + 1}: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items()))
            + f" ({secs[i]:.3f} s)")
    log(f"  {n_lora / 1e6:.2f} M adapter params; seconds per step after the first: "
        f"{np.mean(secs[1:]):.3f}; peak device memory {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    if not all(np.isfinite(v) for m in hist for v in m.values()):
        raise SystemExit("chip_smoke: a training metric is not finite")
    if not hist[0]["grad_norm"] > 0:
        raise SystemExit("chip_smoke: no gradient reached the adapters")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise SystemExit(f"chip_smoke: the loss did not fall on the repeated batch: "
                         f"{[m['loss'] for m in hist]}")
    for n, m in (("llm", llm), ("flow", flow)):
        if not all(torch.equal(v, base[n][k]) for k, v in m.state_dict().items()):
            raise SystemExit(f"chip_smoke: training changed the {n} base weights")
    if ops.launch_counts() != counts0:
        raise SystemExit(f"chip_smoke: training launched a kernel: {counts0} -> {ops.launch_counts()}")
    log(f"  base weights bit-identical; kernel launch counts unchanged: {counts0}")
    del base

    llm2, flow2 = TransformerLM(cfg.llm, DEV), Flow(cfg.flow, DEV)
    llm2.load_state_dict(merged["llm"], strict=True)
    flow2.load_state_dict(merged["flow"], strict=True)
    moved = sum(int(not torch.equal(v, flow.state_dict()[k])) for k, v in flow2.state_dict().items())
    pipe = TTSPipeline(cfg, llm2, flow2, hift, InferenceConfig(min_token_text_ratio=4.0),
                       finetuned_norm=True)
    ids = np.random.default_rng(15).integers(0, 256, (1, 8)).astype(np.int64)
    wav = next(pipe.synthesize(ids, max_len_cap=40, seed=16))["tts_speech"]
    log(f"  merged weights ({moved} flow tensors changed by the merge) load into TTSPipeline: "
        f"waveform {wav.shape}, finite {bool(np.isfinite(wav).all())}")
    if moved == 0 or wav.shape[1] == 0 or not np.isfinite(wav).all():
        raise SystemExit("chip_smoke: the merged weights did not change or did not synthesize")
    del llm2, flow2, pipe, merged
    torch.cuda.empty_cache()

    counts0 = ops.launch_counts()  # the merged-weights synthesis launched kernels
    for mode in ("llm_only", "flow_only"):
        h, sec, pk, _, _ = run(mode, 2)
        log(f"  {mode}: loss {h[0]['loss']:.5f} -> {h[1]['loss']:.5f}, second step {sec[1]:.3f} s, "
            f"peak {pk:.2f} GiB")
        if not all(np.isfinite(v) for m in h for v in m.values()):
            raise SystemExit(f"chip_smoke: a {mode} metric is not finite")
    if ops.launch_counts() != counts0:
        raise SystemExit("chip_smoke: training launched a kernel")
    log("  where a joint step's time goes (one more step, torch.profiler)")
    with tempfile.TemporaryDirectory() as tmp:
        tr = JointTrainer(cfg, tcfg, llm, flow, out_dir=tmp, total_steps=1000)
        state = tr.init_state(torch.Generator(device=DEV).manual_seed(13))

        def one():
            float(tr.step(state, sb, torch.Generator(device=DEV).manual_seed(14))["loss"])

        one()
        wall_ms, busy, by_name = profile_device(one)
        t0 = time.perf_counter()
        one()
        log_profile(wall_ms, (time.perf_counter() - t0) * 1e3, busy, by_name, top=8)


def expect_blocks(counts, nfe, what):
    """Fail unless ``counts`` show 64 x ``nfe`` fused blocks of three
    launches and no LayerNorm, GEMM or banded launch."""
    blocks = 64 * nfe
    if counts["fused_transformer_block"] != blocks or counts["ln_gemm"] != blocks \
            or counts["block_tail"] != blocks or counts["flash_attention"] != blocks \
            or counts["gemm"] != 0 or counts["layer_norm_rows"] != 0 \
            or counts["banded_attention"] != 0:
        raise SystemExit(f"chip_smoke: {what} launch counts {counts} off 64 x NFE {nfe} blocks "
                         "of three launches")


def check_same_tokens(pipe, what, got, want, prefix_rows):
    """The rule for batched against solo tokens on the card: identical, or
    at the first diverging step j the teacher-forced logits of the row in a
    left-padded batch (``prefix_rows``: the batch's prefixes, this row
    first) and of the solo decode agree within 1e-4 * max(1, max|logit|),
    so the flip is a sampling boundary crossed by a rounding difference."""
    got, want = list(got), list(want)
    if got == want:
        return
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    p, cfg = pipe.llm_p, pipe.cfg.llm
    prefix, valid, _, _ = _batch_prefixes(prefix_rows)
    n = min(len(want), j)
    rows = [want[:n]] + [[0] * n for _ in prefix_rows[1:]]
    with torch.inference_mode():
        batched = llm_teacher_forced_logits(p, cfg, prefix, valid, rows)[0, n].float()
        solo = llm_teacher_forced_logits(p, cfg, prefix_rows[0][0], [prefix_rows[0][0].shape[1]],
                                         [want[:n]])[0, n].float()
    gap = (batched - solo).abs().max().item()
    tol = 1e-4 * max(1.0, solo.abs().max().item())
    log(f"  {what}: tokens diverge from the solo decode at step {j} of {len(want)}; "
        f"teacher-forced logit gap there {gap:.3e} (tol {tol:.3e})")
    if not gap <= tol:
        raise SystemExit(f"chip_smoke: {what} diverges from its solo decode beyond rounding")


def streaming_synthesis(cfg, llm, flow, hift, n_ids=20, cap=400, seed=18):
    """Phase 9."""
    icfg = InferenceConfig(min_token_text_ratio=20.0)
    pipe = TTSPipeline(cfg, llm, flow, hift, icfg, finetuned_norm=True)
    plan = pipe.stream_plan(cap)
    nfe = sum(pipe._select_nfe(pipe._mel_len(b - a)) for a, b, _ in plan)
    log(f"[9] streaming synthesis, full width: {n_ids} seeded text ids, EOS held off to {cap} "
        f"tokens and the decode capped there; windows {[(a, b) for a, b, _ in plan]} "
        f"(the last bucketed to {pipe._final_tok_bucket} tokens), NFE {nfe} in all")
    if [b - a for a, b, _ in plan] != [120, 120, 120, 100] or nfe != 40:
        raise SystemExit(f"chip_smoke: the streaming plan {plan} is not 3 x 120 + 100 tokens")
    ids = np.random.default_rng(17).integers(0, 256, (1, n_ids)).astype(np.int64)
    spk = np.zeros((1, cfg.llm.spk_embed_dim), np.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    chunks, at = [], []
    for out in pipe.synthesize(ids, max_len_cap=cap, seed=seed, stream=True):
        chunks.append(out["tts_speech"])
        at.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    audio_s = sum(c.shape[1] for c in chunks) / cfg.sample_rate
    log(f"  time to the first chunk {at[0]:.3f} s ({chunks[0].shape[1] / cfg.sample_rate:.3f} s "
        f"of audio); chunks at {', '.join(f'{x:.3f}' for x in at)} s; seconds per later chunk "
        f"{', '.join(f'{b - a:.3f}' for a, b in zip(at, at[1:]))}; {audio_s:.2f} s of audio "
        f"in {at[-1]:.3f} s (RTF {at[-1] / audio_s:.3f})")
    log(f"  launches: {counts}")
    if [c.shape[1] for c in chunks] != [s for _, _, s in plan] \
            or not all(np.isfinite(c).all() for c in chunks):
        raise SystemExit(f"chip_smoke: streamed chunks {[c.shape for c in chunks]} off the plan "
                         f"{plan} or not finite")
    expect_blocks(counts, nfe, "streaming")
    with torch.inference_mode():
        whole = pipe.generate_tokens(ids, spk, cap, torch.Generator().manual_seed(
            stream_seed(seed, 0, 0)))[0]
        segs = list(pipe.generate_tokens_stream(ids, spk, cap, torch.Generator().manual_seed(
            stream_seed(seed, 0, 0))))
    log(f"  decode segments of {[s.shape[1] for s, _ in segs]} tokens; streamed tokens equal "
        f"generate_tokens: {np.array_equal(segs[-1][0][0], whole)}")
    if len(whole) != cap or not np.array_equal(segs[-1][0][0], whole):
        raise SystemExit("chip_smoke: the streamed tokens differ from generate_tokens")
    log("  where a window's time goes: token2wav of the first 120-token window (fresh carries), "
        "torch.profiler")

    def window():
        pipe.token2wav(whole[None, :120], spk, stream_state=StreamState(), finalize=False,
                       generator=torch.Generator(device=DEV).manual_seed(seed))

    with torch.inference_mode():
        window()
        wall_ms, busy, by_name = profile_device(window)
        plain_wall = cuda_ms(window, 3)
    log_profile(wall_ms, plain_wall, busy, by_name, top=6)


def batched_serving(cfg, llm, flow, hift, seed=21):
    """Phase 10."""
    icfg = InferenceConfig(min_token_text_ratio=20.0)
    pipe = TTSPipeline(cfg, llm, flow, hift, icfg, finetuned_norm=True)
    spk = np.zeros((1, cfg.llm.spk_embed_dim), np.float32)
    lens = (6, 8, 10, 12, 7, 9)
    texts = [np.random.default_rng(30 + i).integers(0, 256, (1, n)).astype(np.int64)
             for i, n in enumerate(lens)]
    log(f"[10] batched decode and the continuous-batching engine, full width: requests of "
        f"{list(lens)} text ids, EOS held off to 20 tokens an id")
    with torch.inference_mode():
        built = [pipe._build_prefix(x, spk, 2048) for x in texts]
        solo = []
        for n_req in (4, 6):  # the first four, one by one, are the B = 1 yardstick
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solo += [pipe.generate_tokens(texts[b], spk, 2048, torch.Generator().manual_seed(
                stream_seed(seed, b, 0)))[0] for b in range(len(solo), n_req)]
            if n_req == 4:
                t_solo = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = pipe._decode_batch(texts[:4], [spk] * 4, 2048, seed).run()
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
    n4 = sum(len(s) for s in solo[:4])
    log(f"  decode tokens/s (host clock, prefills included): B=4 {n4 / t_batch:.1f} ({n4} "
        f"tokens in {t_batch:.3f} s, {max(len(s) for s in solo[:4])} steps) against B=1 "
        f"{n4 / t_solo:.1f} (the same four one by one, {t_solo:.3f} s): "
        f"{t_solo / t_batch:.2f}x")
    for b in range(4):
        check_same_tokens(pipe, f"batch row {b}", state.tokens[b], solo[b],
                          [built[b]] + [built[i] for i in range(4) if i != b])
    for B in (1, 4):
        log(f"  where a decode step's time goes, B={B}: 20 steps, torch.profiler")
        with torch.inference_mode():
            st = pipe._decode_batch(texts[:B], [spk] * B, 2048, seed)
            st.run(st.i + 5)
            wall_ms, busy, by_name = profile_device(lambda: st.run(st.i + 20))
            t0 = time.perf_counter()
            st.run(st.i + 20)
            torch.cuda.synchronize()
        log_profile(wall_ms, (time.perf_counter() - t0) * 1e3, busy, by_name, top=4)
    if [len(s) for s in solo] != [20 * n for n in lens]:
        raise SystemExit(f"chip_smoke: solo decodes of {[len(s) for s in solo]} tokens, "
                         f"not {[20 * n for n in lens]}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    wavs = pipe.synthesize_batch(texts[:4], max_len_cap=2048, seed=seed)
    t_sb = time.perf_counter() - t0
    counts = ops.launch_counts()
    nfe = sum(pipe._select_nfe(pipe._mel_len(20 * n)) for n in lens[:4])
    log(f"  synthesize_batch: {t_sb:.3f} s for {sum(w.shape[1] for w in wavs) / 22050:.2f} s "
        f"of audio; launches {counts}")
    if [w.shape[1] for w in wavs] != [256 * pipe._mel_len(20 * n) for n in lens[:4]] \
            or not all(np.isfinite(w).all() for w in wavs):
        raise SystemExit("chip_smoke: synthesize_batch output has the wrong shape or is not finite")
    expect_blocks(counts, nfe, "synthesize_batch")

    eng = ContinuousBatchEngine(pipe, slots=4)
    plans = [pipe.stream_plan(20 * n) for n in lens]
    nfe = sum(pipe._select_nfe(pipe._mel_len(b - a)) for pl in plans for a, b, _ in pl)
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        reqs = [eng.submit(x, seed=stream_seed(seed, b, 0)) for b, x in enumerate(texts)]
        outs = [list(r.chunks(timeout=600)) for r in reqs]
        t_eng = time.perf_counter() - t0
    finally:
        eng.stop()
    counts = ops.launch_counts()
    log(f"  engine, 4 slots: {len(reqs)} requests in {t_eng:.3f} s wall, "
        f"{eng.segments_run} segments; admitted at segments "
        f"{[r.admitted_segment for r in reqs]}; chunks {[len(o) for o in outs]}; "
        f"launches {counts}")
    for b, (r, o) in enumerate(zip(reqs, outs)):
        if [c.shape[1] for c in o] != [s for _, _, s in plans[b]] \
                or not all(np.isfinite(c).all() for c in o):
            raise SystemExit(f"chip_smoke: engine request {b} chunks off its plan or not finite")
        check_same_tokens(pipe, f"engine request {b}", r.tokens, solo[b], [built[b]])
    if not any(r.admitted_segment for r in reqs):
        raise SystemExit("chip_smoke: no request was admitted mid-flight")
    expect_blocks(counts, nfe, "engine")


def report(name, r):
    def dev(key):
        return "" if r.get(key) is None else f" ({r[key]:.4f} on the card)"

    log(f"  {name:<44} max_abs_err {r['err']:.3e} ({r['tol']}) {'ok' if r['ok'] else 'FAIL'}"
        f" | kernel {r['ms']:.4f} ms{dev('dev_ms')}, plain {r['plain_ms']:.4f} ms"
        f"{dev('plain_dev_ms')}, "
        + (f"library {r['library_ms']:.4f} ms" if r["library_ms"] is not None
           else f"library none (unfused library calls {r['unfused_ms']:.4f} ms")
        + dev("lib_dev_ms") + ("" if r["library_ms"] is not None else ")")
        + (f", kernel A with a band bias {r['kernel_a_ms']:.4f} ms"
           if "kernel_a_ms" in r else "")
        + (f", seven-launch chain {r['chain7_ms']:.4f} ms{dev('chain7_dev_ms')} "
           f"(err {r['chain7_err']:.2e})" if "chain7_ms" in r else "")
        + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    if not r["ok"]:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
    if not r.get("same", True):
        raise SystemExit(f"chip_smoke: {name} changed its result from one call to the next")


def main():
    t_start = time.time()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[1] device: {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t = time.time()
    libs = _cuda.build()
    log(f"[2] kernels built in {time.time() - t:.1f} s: {[os.path.basename(p) for p in libs]}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[3] kernels vs plain versions (TF32 off for matmul and cuDNN)")
    g = torch.Generator(device=DEV).manual_seed(0)
    for bad, what in ((torch.float16, "fp16"), (None, "head dim 32")):
        shape = (1, 1, 8, 32 if bad is None else 64)
        q = torch.zeros(shape, device=DEV, dtype=bad or torch.float32)
        n0 = flash_attention.launches
        try:
            flash_attention(q, q, q, None, 1.0)
        except (TypeError, ValueError) as e:
            if flash_attention.launches != n0:
                raise SystemExit(f"chip_smoke: kernel A launched on {what}")
            log(f"  refused {what} on CUDA: {e}")
        else:
            raise SystemExit(f"chip_smoke: kernel A accepted {what}")
    q = torch.zeros((1, 1, 8, 64), device=DEV)
    n0 = banded_attention.launches
    for what, call, exc in (
            ("fp16", lambda: banded_attention(q.half(), q.half(), q.half(), 1.0, 2), TypeError),
            ("head dim 32", lambda: banded_attention(q[..., :32], q[..., :32], q[..., :32], 1.0, 2),
             ValueError),
            ("S != T", lambda: banded_attention(q, q[:, :, :4], q[:, :, :4], 1.0, 2), ValueError),
            ("an input that requires a gradient",
             lambda: banded_attention(q.clone().requires_grad_(True), q, q, 1.0, 2), RuntimeError)):
        try:
            call()
        except exc as e:
            log(f"  kernel C refused {what} on CUDA: {e}")
        else:
            raise SystemExit(f"chip_smoke: kernel C accepted {what}")
    if banded_attention.launches != n0:
        raise SystemExit("chip_smoke: kernel C launched on a refused input")
    # what the 16-byte copies of the redesigned kernels do not take
    n0 = (flash_attention.launches, gemm.launches)
    q65 = torch.zeros((1, 1, 8, 65), device=DEV)[..., :64]
    a = torch.zeros((64, 64), device=DEV)
    for what, call in (
            ("rows off a 16-byte boundary", lambda: flash_attention(q65, q65, q65, None, 1.0)),
            ("a GEMM with K = 60", lambda: gemm(a[:, :60].contiguous(), [a[:, :60].contiguous()])),
            ("a GEMM operand off a 16-byte boundary",
             lambda: gemm(torch.zeros(64 * 64 + 1, device=DEV)[1:].view(64, 64), [a])),
            ("a non-contiguous GEMM operand", lambda: gemm(a.t(), [a]))):
        try:
            call()
        except ValueError as e:
            log(f"  refused {what} on CUDA: {e}")
        else:
            raise SystemExit(f"chip_smoke: a kernel accepted {what}")
    if (flash_attention.launches, gemm.launches) != n0:
        raise SystemExit("chip_smoke: a kernel launched on a refused input")
    # what kernels B1 and B2 do not take
    n0 = (ln_gemm.launches, block_tail.launches)
    v = torch.zeros(256, device=DEV)
    w96 = torch.zeros(64, 96, device=DEV)
    tail_w = [torch.zeros(s, device=DEV) for s in ((256, 512), (256,), (256,), (256,), (1024, 256),
                                                   (1024,), (256, 1024), (256,))]
    for what, call, exc in (
            ("an LN prologue over K = 96", lambda: ln_gemm(torch.zeros(8, 96, device=DEV), v[:96],
                                                          v[:96], [w96]), ValueError),
            ("an LN prologue over K = 512", lambda: ln_gemm(
                torch.zeros(8, 512, device=DEV), torch.zeros(512, device=DEV),
                torch.zeros(512, device=DEV), [torch.zeros(64, 512, device=DEV)]), ValueError),
            ("a block tail of width 128", lambda: block_tail(
                torch.zeros(8, 512, device=DEV), torch.zeros(8, 128, device=DEV),
                *[torch.zeros(t.shape[0] // 2 if t.shape[0] == 256 else t.shape[0],
                              *t.shape[1:], device=DEV) for t in tail_w]), ValueError),
            ("a bf16 block tail with f32 weights", lambda: block_tail(
                torch.zeros(8, 512, device=DEV, dtype=torch.bfloat16),
                torch.zeros(8, 256, device=DEV, dtype=torch.bfloat16), *tail_w), TypeError),
            ("a block tail input that requires a gradient", lambda: block_tail(
                torch.zeros(8, 512, device=DEV, requires_grad=True),
                torch.zeros(8, 256, device=DEV), *tail_w), RuntimeError)):
        try:
            call()
        except exc as e:
            log(f"  refused {what} on CUDA: {e}")
        else:
            raise SystemExit(f"chip_smoke: a block kernel accepted {what}")
    if (ln_gemm.launches, block_tail.launches) != n0:
        raise SystemExit("chip_smoke: a block kernel launched on a refused input")
    for dtype in (torch.float32, torch.bfloat16):
        # the windowed path's shapes, the aligned shapes beside them, a
        # ragged T with a short k_valid, a window covering T, and a narrow
        # window whose k_valid leaves whole query tiles without a key
        dn = str(dtype)[6:]
        # phase 7's own shapes first: 1485 tokens give 2558 mel frames, so
        # the path launches C at T = 2558 (window 256) and, most often, at
        # T/2 = 1279 (window 128); both end in a ragged query and key tile
        report(f"C main path (2,8,2558,64) window 256 {dn}",
               banded_case(g, 2, 8, 2558, 256, dtype))
        r = banded_case(g, 2, 8, 1279, 128, dtype)
        report(f"C main path (2,8,1279,64) window 128 {dn}", r)
        if dtype == torch.float32:
            main_c = r
        report(f"C (2,8,2560,64) window 256 {dn}", banded_case(g, 2, 8, 2560, 256, dtype))
        report(f"C (2,8,1280,64) window 128 {dn}", banded_case(g, 2, 8, 1280, 128, dtype))
        report(f"C (2,8,2307,64) window 256 k_valid [2307,1811] {dn}",
               banded_case(g, 2, 8, 2307, 256, dtype, kv=[2307, 1811]))
        report(f"C (2,8,200,64) window 4096 >= T {dn}", banded_case(g, 2, 8, 200, 4096, dtype))
        report(f"C (2,8,150,64) window 3 k_valid [150,9] {dn}",
               banded_case(g, 2, 8, 150, 3, dtype, kv=[150, 9]))
        for T in (207, 414, 1024, 2580):
            report(f"A (2,8,{T},64) {str(dtype)[6:]} bias+k_valid+masked row",
                   attention_case(g, 2, 8, T, T, dtype, iters=20 if T < 2000 else 5))
        report(f"A (2,8,128,64) S=8320 {str(dtype)[6:]} bias+k_valid",
               attention_case(g, 2, 8, 128, 8320, dtype, iters=5))
        for T in (208, 414):
            for with_bias in (False, True):
                report(f"B (2,{T},256) {str(dtype)[6:]} {'bias' if with_bias else 'no bias'}",
                       block_case(g, 2, T, dtype, with_bias))
    # the main path's shapes: mel length 311 -> padded 312; 8 blocks run at
    # T = 312 and 56 at the T/2 level, 156 (B = 2, so 624 and 312 rows).
    # The kernels line reports the T/2 level, where most launches run.
    report("A main path (2,8,312,64) f32 bias", attention_case(g, 2, 8, 312, 312, torch.float32))
    main_a = attention_case(g, 2, 8, 156, 156, torch.float32)
    report("A main path (2,8,156,64) f32 bias", main_a)
    for T in (312, 156):
        report(f"A main path (2,8,{T},64) bf16 bias", attention_case(g, 2, 8, T, T, torch.bfloat16))
    report("B main path (2,312,256) f32 bias", block_case(g, 2, 312, torch.float32, True))
    main_b = block_case(g, 2, 156, torch.float32, True)
    report("B main path (2,156,256) f32 bias", main_b)
    report("B main path (2,156,256) bf16 bias", block_case(g, 2, 156, torch.bfloat16, True))
    report("LayerNorm main path (624,256) f32", layer_norm_case(g, 2 * 312))
    main_ln = layer_norm_case(g, 2 * 156)
    report("LayerNorm main path (312,256) f32", main_ln)
    # the four products at the long utterance's rows (2 x 2558) and at the
    # short synthesis's two levels, f32 and bf16.  The kernels line reports
    # FF2 at 312 rows in f32, the case furthest behind the library
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (2 * 2558, 2 * 312, 2 * 156):
            it = 10 if rows > 1000 else 50
            level = {}
            level["QKV"] = gemm_case(g, rows, 256, 512, 3, iters=it, dtype=dtype)
            level["out-proj"] = gemm_case(g, rows, 512, 256, bias=True, residual=True,
                                          iters=it, dtype=dtype)
            level["FF1"] = gemm_case(g, rows, 256, 1024, bias=True, gelu="tanh", iters=it,
                                     dtype=dtype)
            level["FF2"] = gemm_case(g, rows, 1024, 256, bias=True, residual=True, iters=it,
                                     dtype=dtype)
            for what, r in level.items():
                report(f"GEMM main path {what} M={rows} {str(dtype)[6:]} plan {r['plan']}", r)
        if dtype == torch.float32:
            main_gemm = level["FF2"]
    # kernels B1 and B2 at the short synthesis's two levels and the long
    # utterance's rows; the kernels line reports 312 rows in f32 (the T/2
    # level, where 56 of the 64 blocks run)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (2 * 156, 2 * 312, 2 * 2558):
            it = 10 if rows > 1000 else 20
            r1, r2 = ln_gemm_case(g, rows, dtype, iters=it), tail_case(g, rows, dtype, iters=it)
            report(f"B1 ln_gemm M={rows} {str(dtype)[6:]} plan {r1['plan']} same bits twice "
                   f"{r1['same']}", r1)
            report(f"B2 block_tail M={rows} {str(dtype)[6:]} plan {r2['plan']} same bits twice "
                   f"{r2['same']}", r2)
            if rows == 2 * 156 and dtype == torch.float32:
                main_b1, main_b2 = r1, r2
    # the streaming path's shapes (phase 9): a 120-token window is 206 mel
    # frames (even: no mask, no bias) and 103 at the T/2 level; the bucketed
    # final chunk is 220 frames with its true 172 valid (a (B,T,T) bias),
    # 110 with 86 valid at T/2.  B1 and B2 run at 412, 206, 440 and 220 rows
    log("  streaming and final-bucket shapes (phase 9's), plans (block_q, kv_splits) of A, "
        "(block_m, block_n, cluster) of B1, (block_m, cluster, sub-tile) of B2")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for T, valid in ((206, None), (103, None), (220, 172), (110, 86)):
            what = "no bias" if valid is None else f"bias from key {valid}"
            report(f"A stream (2,8,{T},64) {dn} {what} plan "
                   f"{_attention_plan(16, T, T, None, dtype)}",
                   attention_case(g, 2, 8, T, T, dtype, masked=False, pad_from=valid))
            report(f"B stream (2,{T},256) {dn} {what}",
                   block_case(g, 2, T, dtype, valid is not None, pad_from=valid))
        for rows in (412, 206, 440, 220):
            r1, r2 = ln_gemm_case(g, rows, dtype), tail_case(g, rows, dtype)
            report(f"B1 stream M={rows} {dn} plan {r1['plan']} same bits twice {r1['same']}", r1)
            report(f"B2 stream M={rows} {dn} plan {r2['plan']} same bits twice {r2['same']}", r2)
    same_twice(g)

    cfg = ModelConfig()
    log("[4] full-width estimator call, B=2, T=208 (valid 207: mask + bias)")
    flow = init_flow_params(cfg.flow, DEV, seed=1)
    est = P(dict(flow.named_parameters())).sub("decoder.estimator")
    gen = torch.Generator(device=DEV).manual_seed(2)
    x, mu, cond = (torch.randn(2, 80, 208, device=DEV, generator=gen) for _ in range(3))
    spks = torch.randn(2, 80, device=DEV, generator=gen)
    tt = torch.rand(2, device=DEV, generator=gen)
    mask = torch.ones(2, 1, 208, device=DEV)
    mask[:, :, 207:] = 0.0
    args = (x, mask, mu, tt, spks, cond)
    with torch.inference_mode():
        y = conditional_decoder(est, cfg.flow.estimator, *args)
        est_ms = cuda_ms(lambda: conditional_decoder(est, cfg.flow.estimator, *args), 5)
        est_cpu = P({k: v.cpu() for k, v in est.d.items()}).sub("decoder.estimator")
        t = time.time()
        y_cpu = conditional_decoder(est_cpu, cfg.flow.estimator, *(a.cpu() for a in args))
        cpu_s = time.time() - t
    err = (y.cpu() - y_cpu).abs().max().item()
    scale = y_cpu.abs().max().item()
    log(f"  card {est_ms:.3f} ms/call, cpu (plain versions) {cpu_s:.2f} s; max_abs_err "
        f"{err:.3e} vs max|y| {scale:.3e} (tol 1e-4 * max(1, max|y|))")
    if not (torch.isfinite(y).all() and err <= 1e-4 * max(1.0, scale)):
        raise SystemExit("chip_smoke: full-width estimator disagrees with the CPU plain path")

    log("[5] full-width prompt-free synthesis (random seeded weights)")
    t = time.time()
    llm = init_llm_params(cfg.llm, DEV, seed=3)
    hift = init_hift_params(cfg.hift, DEV, seed=4)
    torch.cuda.synchronize()
    log(f"  weights on the card in {time.time() - t:.1f} s: llm "
        f"{sum(p.numel() for p in llm.parameters()) / 1e6:.1f} M, flow "
        f"{sum(p.numel() for p in flow.parameters()) / 1e6:.1f} M, hift "
        f"{sum(p.numel() for p in hift.parameters()) / 1e6:.1f} M params")
    # 16 text ids; EOS held off (min ratio 12) and the decode capped at 181
    # tokens -> 311 mel frames: odd (padded, masked, (B,T,T) bias) and > 300
    # (NFE 15)
    icfg = InferenceConfig(min_token_text_ratio=12.0)
    pipe = TTSPipeline(cfg, llm, flow, hift, icfg, finetuned_norm=True)
    ids = np.random.default_rng(5).integers(0, 256, (1, 16)).astype(np.int64)
    ops.reset_launch_counts()
    t = time.time()
    wav = next(pipe.synthesize(ids, max_len_cap=181, seed=6))["tts_speech"]
    total_s = time.time() - t
    counts = ops.launch_counts()
    T_mel, nfe = 311, 15
    log(f"  stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in pipe.stage_seconds.items())
        + f"; total {total_s:.3f} s")
    log(f"  waveform {wav.shape}, finite {bool(np.isfinite(wav).all())}, "
        f"{wav.shape[1] / cfg.sample_rate:.2f} s of audio")
    log(f"  launches: {counts}")
    blocks = 64 * nfe
    if wav.shape != (1, 256 * T_mel) or not np.isfinite(wav).all():
        raise SystemExit("chip_smoke: synthesis output has the wrong shape or is not finite")
    if counts["fused_transformer_block"] != blocks or counts["ln_gemm"] != blocks \
            or counts["block_tail"] != blocks or counts["flash_attention"] < blocks \
            or counts["gemm"] != 0 or counts["layer_norm_rows"] != 0:
        raise SystemExit(f"chip_smoke: launch counts {counts} off the path's 64 x NFE {nfe} "
                         "blocks of three launches")

    log("[6] where the time goes: one estimator call at the main path's shape "
        "(B=2, T=312, valid 311), torch.profiler")
    where_time_goes(est, cfg.flow.estimator, 312)

    counts_w = windowed_synthesis(cfg, llm, flow, hift)
    training_steps(cfg, llm, flow, hift)
    streaming_synthesis(cfg, llm, flow, hift)
    batched_serving(cfg, llm, flow, hift)

    def entry(name, source, replaces, r, launches=None):
        # times on the card (torch.profiler) where the profiler gave them,
        # else the CUDA-event means: on a slow host the event mean of a small
        # kernel is the host's launch rate, not the kernel
        def on_card(key, event_key):
            return r[event_key] if r.get(key) is None else r[key]

        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[name] if launches is None else launches,
                "max_abs_err": r["err"], "ms": on_card("dev_ms", "ms"),
                "plain_ms": on_card("plain_dev_ms", "plain_ms"), "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": None if r["library_ms"] is None
                else on_card("lib_dev_ms", "library_ms")}

    kernels = [
        entry("flash_attention", "cosy_tpu_torch/csrc/flash_attention.cu",
              "cosy_tpu/ops/flash_attention.py:76", main_a),
        entry("fused_transformer_block", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:34", main_b),
        entry("layer_norm_rows", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:49", main_ln),
        entry("gemm", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:51", main_gemm),
        entry("ln_gemm", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:49", main_b1),
        entry("block_tail", "cosy_tpu_torch/csrc/block_tail.cu",
              "cosy_tpu/ops/fused_block.py:74", main_b2),
        # launches on the windowed path (phase 7); times at its T/2 level
        entry("banded_attention", "cosy_tpu_torch/csrc/flash_attention.cu",
              "cosy_tpu/ops/flash_attention.py:275", main_c,
              launches=counts_w["banded_attention"]),
    ]
    log(f"  run took {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
