"""Sweep the tiles and splits of the block's and attention's kernels on the card.

    python -m cosy_tpu_torch.ops.plan_sweep

At the main path's row counts, in f32 and bf16, every plan the kernels take
is launched directly through the C entry points and timed (device time of
the kernel by torch.profiler, mean of 10 launches): kernel B1 (the QKV
product with its LayerNorm prologue, every tile and N-cluster), kernel B2 (the
block tail, every (block_m, cluster, sub-tile)), the GEMM's four products
and kernel A at the path's attention shapes.  Each line names the choice of
``_ln_gemm_plan`` / ``_tail_plan`` / ``_gemm_plan`` / ``_attention_plan``
with its time and then the four fastest choices, as ``(plan; blocks): ms``.
The plans' rules were fitted to this output (PERF.md); rerun it after a
change to a kernel.  Needs a CUDA device; prints the card's name and power
limit first.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from . import _cuda
from .flash_attention import BLOCK_Q, KV_TILE, _SPLITS, _attention_plan
from .fused_block import (_GEMM_TILES, _GEMM_TILES_F32, _TAIL_PLANS, K_SLICE, _gemm_plan,
                          _ln_gemm_plan, _tail_plan)

PRODUCTS = {"QKV": (1536, 256), "out-proj": (256, 512), "FF1": (1024, 256),
            "FF2": (256, 1024)}
ROWS = (312, 624, 2558, 5116)
ATTENTION = ((156, 156), (312, 312), (1279, 1279), (2580, 2580), (128, 8320))


def device_ms(fn, iters: int = 10):
    """Mean time on the card of the kernels ``fn`` launches, in ms, from
    torch.profiler's CUDA events (after one warm-up call): it leaves out the
    gaps in which the card waits for the host, which are most of a
    back-to-back loop of small launches.  None when the profiler recorded
    fewer device events than calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(5):  # a capture that lost events is taken again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(spans) >= iters:
            return sum(spans) / 1e3 / iters
    return None


def _line(what, plan, results):
    if any(r[0] is None for r in results):
        raise SystemExit("plan_sweep: the profiler recorded no device events")
    results.sort()
    mine = [r[0] for r in results if r[1] == plan]
    best = " ".join(f"({', '.join(map(str, r[1]))}; {r[2]}): {r[0]:.4f}" for r in results[:4])
    print(f"{what}: plan {plan} {mine[0] if mine else float('nan'):.4f} ms | fastest {best}",
          flush=True)


def sweep_gemm(dev, gen):
    fn = _cuda.function("cosy_gemm")
    codes = _cuda.DTYPE_CODE
    for dtype in (torch.float32, torch.bfloat16):
        tiles = _GEMM_TILES_F32 if dtype == torch.float32 else _GEMM_TILES
        for M in ROWS:
            for name, (N, K) in PRODUCTS.items():
                a = torch.randn(M, K, device=dev, generator=gen).to(dtype)
                w = (torch.randn(N, K, device=dev, generator=gen) * 0.05).to(dtype)
                y = torch.empty(M, N, device=dev, dtype=dtype)
                results = []
                for bm, bn, _ in tiles:
                    for split in (1, 2, 4, 8):
                        if K % (split * K_SLICE) or (split > 1 and K // split < 2 * K_SLICE):
                            continue

                        def run():
                            _cuda.check(fn(codes[dtype], -1, codes[dtype], a.data_ptr(),
                                           w.data_ptr(), None, None, N, None, None,
                                           y.data_ptr(), M, N, K, 0, bm, bn, split,
                                           _cuda.stream_ptr(a)), "gemm")

                        blocks = _cuda.cdiv(M, bm) * _cuda.cdiv(N, bn) * split
                        results.append((device_ms(run), (bm, bn, split), blocks))
                _line(f"gemm {str(dtype)[6:]} M={M} {name}", _gemm_plan(M, N, K, dtype), results)


def sweep_ln_gemm(dev, gen):
    """Kernel B1 on the QKV product (N = 1536, K = 256): every tile, and
    every cluster along N that divides its N tiles."""
    fn = _cuda.function("cosy_ln_gemm")
    codes = _cuda.DTYPE_CODE
    N, K = PRODUCTS["QKV"]
    for dtype in (torch.float32, torch.bfloat16):
        tiles = _GEMM_TILES_F32 if dtype == torch.float32 else _GEMM_TILES
        for M in ROWS:
            x = torch.randn(M, K, device=dev, generator=gen).to(dtype)
            lw, lb = (torch.randn(K, device=dev, generator=gen).to(dtype) for _ in range(2))
            w = (torch.randn(N, K, device=dev, generator=gen) * 0.05).to(dtype)
            y = torch.empty(M, N, device=dev, dtype=dtype)
            results = []
            for bm, bn, _ in tiles:
                for cluster in (1, 2, 4, 8):
                    if _cuda.cdiv(N, bn) % cluster:
                        continue

                    def run():
                        _cuda.check(fn(codes[dtype], codes[dtype], codes[dtype], x.data_ptr(),
                                       lw.data_ptr(), lb.data_ptr(), w.data_ptr(), None, None,
                                       N, y.data_ptr(), M, N, K, 1e-5, bm, bn, cluster,
                                       _cuda.stream_ptr(x)), "ln_gemm")

                    blocks = _cuda.cdiv(M, bm) * _cuda.cdiv(N, bn)
                    results.append((device_ms(run), (bm, bn, cluster), blocks))
            _line(f"ln_gemm {str(dtype)[6:]} M={M} LN1+QKV", _ln_gemm_plan(M, N, K, dtype),
                  results)


def sweep_tail(dev, gen):
    """Kernel B2 at C = 256, inner 512, FF 1024."""
    fn = _cuda.function("cosy_block_tail")
    codes = _cuda.DTYPE_CODE
    C, inner, F = 256, 512, 1024
    for dtype in (torch.float32, torch.bfloat16):
        for M in ROWS:
            def mk(*shape):
                return (torch.randn(*shape, device=dev, generator=gen) * 0.05).to(dtype)

            a, x = mk(M, inner), mk(M, C)
            ts = (a, x, mk(C, inner), mk(C), mk(C), mk(C), mk(F, C), mk(F), mk(C, F), mk(C),
                  torch.empty(M, C, device=dev, dtype=dtype))
            results = []
            for bm, cluster, sub in _TAIL_PLANS:
                def run():
                    _cuda.check(fn(codes[dtype], *(t.data_ptr() for t in ts), M, C, inner, F,
                                   1e-5, 1, bm, cluster, sub, _cuda.stream_ptr(x)),
                                "block_tail")

                results.append((device_ms(run), (bm, cluster, sub),
                                _cuda.cdiv(M, bm) * cluster))
            _line(f"block_tail {str(dtype)[6:]} M={M}", _tail_plan(M, C, inner, F, dtype),
                  results)


def sweep_attention(dev, gen):
    fn = _cuda.function("cosy_flash_attention")
    codes = _cuda.DTYPE_CODE
    for dtype in (torch.float32, torch.bfloat16):
        for T, S in ATTENTION:
            q = torch.randn(2, 8, T, 64, device=dev, generator=gen).to(dtype)
            k, v = (torch.randn(2, 8, S, 64, device=dev, generator=gen).to(dtype)
                    for _ in range(2))
            bias = torch.zeros(2, T, S, device=dev, dtype=dtype)
            out = torch.empty_like(q)
            strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                               *v.stride()[:3], *out.stride()[:3])
            results = []
            for splits in _SPLITS:
                if splits > _cuda.cdiv(S, KV_TILE):
                    continue

                def run():
                    _cuda.check(fn(codes[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   bias.data_ptr(), None, out.data_ptr(), 2, 8, T, S, 64,
                                   strides, 0.125, BLOCK_Q, splits, _cuda.stream_ptr(q)),
                                "flash_attention")

                blocks = _cuda.cdiv(T, BLOCK_Q) * 16 * splits
                results.append((device_ms(run), (BLOCK_Q, splits), blocks))
            _line(f"attention {str(dtype)[6:]} (2,8,{T},64) S={S} + bias",
                  _attention_plan(16, T, S, None, dtype), results)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("plan_sweep: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    _cuda.build()
    gen = torch.Generator(device=dev).manual_seed(0)
    sweep_ln_gemm(dev, gen)
    sweep_tail(dev, gen)
    sweep_gemm(dev, gen)
    sweep_attention(dev, gen)


if __name__ == "__main__":
    main()
