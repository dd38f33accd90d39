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
     and cuDNN in every comparison);
  4. one full-width estimator call on the card (kernels) against the same
     call on the CPU (plain versions);
  5. full-width prompt-free CosyVoice-300M synthesis on random seeded
     weights through TTSPipeline.synthesize, with the launch counters reset
     just before and read just after: every kernel of the path must have
     run, and the fused block exactly 64 x NFE times;
  6. where the time goes: one estimator call at the main path's shape under
     torch.profiler (device busy share, device time by kernel).
It prints a JSON "kernels" line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from cosy_tpu_torch import ops  # noqa: E402
from cosy_tpu_torch.config import InferenceConfig, ModelConfig  # noqa: E402
from cosy_tpu_torch.infer.pipeline import TTSPipeline  # noqa: E402
from cosy_tpu_torch.layers.unet import conditional_decoder  # noqa: E402
from cosy_tpu_torch.models.flow import init_flow_params  # noqa: E402
from cosy_tpu_torch.models.hift import init_hift_params  # noqa: E402
from cosy_tpu_torch.models.llm import init_llm_params  # noqa: E402
from cosy_tpu_torch.ops import _cuda  # noqa: E402
from cosy_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from cosy_tpu_torch.ops.fused_block import (fused_transformer_block,  # noqa: E402
                                            fused_transformer_block_ref, gemm, gemm_ref,
                                            layer_norm_rows, layer_norm_rows_ref)
from cosy_tpu_torch.params import P  # noqa: E402

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
    return err, ok, f"tol atol={atol:g} rtol={rtol:g}"


# ---------------------------------------------------------------------------
# kernel A: flash attention
# ---------------------------------------------------------------------------


def attention_case(g, B, H, T, S, dtype, masked=True, iters=20):
    q = torch.randn(B, H, T, 64, device=DEV, generator=g).to(dtype)
    k = torch.randn(B, H, S, 64, device=DEV, generator=g).to(dtype)
    v = torch.randn(B, H, S, 64, device=DEV, generator=g).to(dtype)
    bias = torch.zeros(B, T, S, device=DEV)
    kv = None
    if masked:
        bias[-1, :, S - S // 10:] = -1e10  # right padding
        bias[0, min(3, T - 1), :] = -1e10  # one fully masked row
        kv = torch.tensor([S] * (B - 1) + [S - 17], dtype=torch.int32, device=DEV)
    bias = bias.to(dtype)
    scale = 64 ** -0.5
    got = flash_attention(q, k, v, bias, scale, kv)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, bias, scale, kv)
    err, ok, tol = compare("attention", got, want, dtype)
    mask = bias  # the library call gets the k_valid cut folded into its mask
    if kv is not None:
        mask = bias.masked_fill(torch.arange(S, device=DEV)[None, None, :]
                                >= kv[:, None, None], -1e10)
    mask = mask[:, None]
    ms = cuda_ms(lambda: flash_attention(q, k, v, bias, scale, kv), iters)
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, bias, scale, kv), max(2, iters // 4))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale),
                  iters)
    bms, by = bound(4 * B * H * T * S * 64, nbytes(q, k, v, got, bias, kv), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by)


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


def block_case(g, B, T, dtype, with_bias, iters=20, heads=8):
    W = block_weights(g, dtype)
    C, inner, ff = 256, 512, 1024
    x = torch.randn(B, T, C, device=DEV, generator=g).to(dtype)
    bias = None
    if with_bias:
        bias = torch.zeros(B, T, T, device=DEV)
        bias[-1, :, T - T // 10:] = -1e10
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
    flops = 2 * B * T * (3 * C * inner + inner * C + 2 * C * ff) + 4 * B * heads * T * T * (inner // heads)
    bms, by = bound(flops, nbytes(x, got, bias, *W), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=None,
                unfused_ms=unfused, bound_ms=bms, bound_by=by)


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
                bound_ms=bms, bound_by=by)


def gemm_case(g, M, K, seg, nseg=1, bias=False, gelu=None, residual=False, iters=50):
    """One of the block's products with its epilogue: ``nseg`` (seg, K)
    weight segments read in place (3 for the QKV product), optional bias,
    tanh GELU and f32 residual, as the block's four launches use them."""
    dtype = torch.float32
    N = nseg * seg
    a = torch.randn(M, K, device=DEV, generator=g)
    ws = [torch.randn(seg, K, device=DEV, generator=g) * 0.05 for _ in range(nseg)]
    w_cat = torch.cat(ws)
    b = torch.randn(N, device=DEV, generator=g) * 0.05 if bias else None
    r = torch.randn(M, N, device=DEV, generator=g) if residual else None

    def run():
        return gemm(a, ws, b, r, gelu=gelu)

    def run_ref():
        return gemm_ref(a, ws, b, r, gelu=gelu)

    def run_lib():
        y = F.linear(a, w_cat, b)
        y = F.gelu(y, approximate="tanh") if gelu else y
        return y + r if residual else y

    got = run()
    torch.cuda.synchronize()
    err, ok, tol = compare("gemm", got, run_ref(), dtype)
    ms = cuda_ms(run, iters)
    plain = cuda_ms(run_ref, iters)
    lib = cuda_ms(run_lib, iters)
    bms, by = bound(2 * M * N * K, nbytes(a, w_cat, b, r, got), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by)


def where_time_goes(est, ecfg, T):
    """Device busy share and device time by kernel for one estimator call
    (B=2, T frames, the last one padding), from torch.profiler's CUDA
    events; wall time on the host clock around the call."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEV).manual_seed(7)
    x, mu, cond = (torch.randn(2, 80, T, device=DEV, generator=gen) for _ in range(3))
    mask = torch.ones(2, 1, T, device=DEV)
    mask[:, :, T - 1:] = 0.0
    args = (x, mask, mu, torch.rand(2, device=DEV, generator=gen),
            torch.randn(2, 80, device=DEV, generator=gen), cond)
    with torch.inference_mode():
        conditional_decoder(est, ecfg, *args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            conditional_decoder(est, ecfg, *args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"  wall {wall_ms:.3f} ms; the profiler recorded no device events")
        return
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
    with torch.inference_mode():
        plain_wall = cuda_ms(lambda: conditional_decoder(est, ecfg, *args), 3)
    log(f"  wall {wall_ms:.3f} ms profiled ({plain_wall:.3f} ms without the profiler), "
        f"device busy {busy:.3f} ms, idle share {1 - busy / plain_wall:.3f} of the "
        f"unprofiled wall, {len(kernels)} kernel launches")
    for n, (cnt, tot) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"  {tot:9.3f} ms {100 * tot / busy:5.1f}% x{cnt:<5d} {n[:90]}")


def report(name, r):
    log(f"  {name:<44} max_abs_err {r['err']:.3e} ({r['tol']}) {'ok' if r['ok'] else 'FAIL'}"
        f" | kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        + (f"library {r['library_ms']:.4f} ms" if r["library_ms"] is not None
           else f"library none (unfused library calls {r['unfused_ms']:.4f} ms)")
        + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    if not r["ok"]:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")


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
    for dtype in (torch.float32, torch.bfloat16):
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
    report("B main path (2,312,256) f32 bias", block_case(g, 2, 312, torch.float32, True))
    main_b = block_case(g, 2, 156, torch.float32, True)
    report("B main path (2,156,256) f32 bias", main_b)
    report("B main path (2,156,256) bf16 bias", block_case(g, 2, 156, torch.bfloat16, True))
    report("LayerNorm main path (624,256) f32", layer_norm_case(g, 2 * 312))
    main_ln = layer_norm_case(g, 2 * 156)
    report("LayerNorm main path (312,256) f32", main_ln)
    for rows in (2 * 312, 2 * 156):
        level = {}
        level["QKV"] = gemm_case(g, rows, 256, 512, 3)
        level["out-proj"] = gemm_case(g, rows, 512, 256, bias=True, residual=True)
        level["FF1"] = gemm_case(g, rows, 256, 1024, bias=True, gelu="tanh")
        level["FF2"] = gemm_case(g, rows, 1024, 256, bias=True, residual=True)
        for what, r in level.items():
            report(f"GEMM main path {what} M={rows} f32", r)
    main_gemm = level["QKV"]

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
    if counts["fused_transformer_block"] != blocks or counts["flash_attention"] < blocks \
            or counts["gemm"] != 4 * blocks or counts["layer_norm_rows"] != 2 * blocks:
        raise SystemExit(f"chip_smoke: launch counts {counts} off the path's 64 x NFE {nfe}")

    log("[6] where the time goes: one estimator call at the main path's shape "
        "(B=2, T=312, valid 311), torch.profiler")
    where_time_goes(est, cfg.flow.estimator, 312)

    def entry(name, source, replaces, r):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[name], "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    kernels = [
        entry("flash_attention", "cosy_tpu_torch/csrc/flash_attention.cu",
              "cosy_tpu/ops/flash_attention.py:76", main_a),
        entry("fused_transformer_block", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:34", main_b),
        entry("layer_norm_rows", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:49", main_ln),
        entry("gemm", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:51", main_gemm),
    ]
    log(f"  run took {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
