"""Where the time goes inside kernels B1, B2, A and C: a phase trace on the card.

    python -m cosy_tpu_torch.ops.phase_trace

Builds ``csrc/ln_gemm.cu``, ``csrc/block_tail.cu`` and
``csrc/flash_attention.cu`` once more with ``-DCOSY_TRACE`` into
``build/cosy_tpu_torch/trace/`` (the library build has no trace), launches
B1 on the QKV product and B2 on the block tail at the main path's row
counts in f32 and bf16 with their plans, A with a (B, T, S) bias at
(2,8,156,64) and (2,8,2580,64) and C at (2,8,1279,64), window 128, in f32
and bf16 with their plans, and prints, for block 0, the microseconds from
the kernel's first phase to each later one (``%globaltimer``, read back
through ``cosy_trace``):

    B1: 10 start, 17 x landed and the row statistics taken, 11 first W
        stage landed, 14 slice 2's products issued, 15 slice 3 landed, split
        and its fragments built, 16 slice 2's products done, 12 mainloop
        done, 13 end (y stored)
    B2: 0 start, 1 first stage landed (a and Wo of the out-projection's
        first slice, its fragments built), 2 out-projection done, 3 x1
        gathered (at R = 16 the pair's halves of K summed; the rank's
        columns written and pushed, every peer's landed), 4 FF1 of the
        first sub-tile done, 5 FF2 done (the last sub-tile; its chunks
        pushed quarter by quarter), 6 FF2 partials received (every peer's
        landed), 7 end (y stored, the cluster's last barrier)
    A, C: 0 start, 1 Q landed, 2 first K/V stage ready (landed; f32: and
        split), 3 first S done, 8 its softmax done, 4 first P V done, 5 last
        tile done, 6 combine done (a split plan only), 7 end (the output
        stored; under a split, the cluster's last barrier)

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ..utils import aot
from . import _cuda
from .flash_attention import _attention_plan
from .fused_block import _ln_gemm_plan, _tail_plan

ROWS = (312, 624, 5116)
B1_PHASES = (10, 17, 11, 14, 15, 16, 12, 13)
B2_PHASES = tuple(range(8))
A_PHASES = (0, 1, 2, 3, 8, 4, 5, 7)
SPLIT_PHASES = (0, 1, 2, 3, 8, 4, 5, 6, 7)
SOURCES = ("ln_gemm.cu", "block_tail.cu", "flash_attention.cu")
ENTRY = {"cosy_ln_gemm": "ln_gemm.cu", "cosy_block_tail": "block_tail.cu",
         "cosy_flash_attention": "flash_attention.cu",
         "cosy_banded_attention": "flash_attention.cu"}


def _trace_libraries():
    out = aot.library_dir() / "trace"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda._nvcc()
    jobs = {src: subprocess.Popen([nvcc, *_cuda.NVCC_FLAGS, "-DCOSY_TRACE", "-o",
                                   str(out / f"{src[:-3]}.so"), str(_cuda.CSRC / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in SOURCES}
    libs = {}
    for src, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"trace build of {src} failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"{src[:-3]}.so"))
        lib.cosy_trace.argtypes = [ctypes.c_void_p]
        lib.cosy_trace.restype = ctypes.c_int
        libs[src] = lib
    for name, src in ENTRY.items():
        fn = getattr(libs[src], name)
        fn.argtypes = _cuda.SIGNATURES[name][1]
        fn.restype = ctypes.c_int
    return libs


def _phases(lib, launch, marks, runs: int = 5):
    """us from the first mark to each mark, block 0, of the last of ``runs``
    launches (the earlier ones warm the caches)."""
    buf = (ctypes.c_longlong * 32)()
    for _ in range(runs):
        launch()
        torch.cuda.synchronize()
    _cuda.check(lib.cosy_trace(buf), "cosy_trace")
    return " ".join(f"{m}:{(buf[m] - buf[marks[0]]) / 1e3:.2f}" for m in marks)


def trace_attention(lib, dev, gen):
    """A at (2,8,156,64) and (2,8,2580,64) with a (B, T, S) bias, C at
    (2,8,1279,64) with window 128; f32 and bf16; the wrapper's plans."""
    codes = _cuda.DTYPE_CODE
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for T in (156, 2580):
            q, k, v = (torch.randn(2, 8, T, 64, device=dev, generator=gen).to(dtype)
                       for _ in range(3))
            bias = torch.zeros(2, T, T, device=dev, dtype=dtype)
            out = torch.empty_like(q)
            st = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                          *out.stride()[:3])
            plan = _attention_plan(16, T, T, None, dtype)
            print(f"A {dn} (2,8,{T},64) + bias splits {plan} us: " + _phases(lib, lambda: _cuda.check(
                lib.cosy_flash_attention(codes[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         bias.data_ptr(), None, out.data_ptr(), 2, 8, T, T, 64,
                                         st, 0.125, plan, _cuda.stream_ptr(q)),
                "flash_attention"), SPLIT_PHASES if plan > 1 else A_PHASES), flush=True)
        T, window = 1279, 128
        q, k, v = (torch.randn(2, 8, T, 64, device=dev, generator=gen).to(dtype) for _ in range(3))
        out = torch.empty_like(q)
        st = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                      *out.stride()[:3])
        plan = _attention_plan(16, T, T, window, dtype)
        print(f"C {dn} (2,8,{T},64) window {window} splits {plan} us: " + _phases(
            lib, lambda: _cuda.check(lib.cosy_banded_attention(
                codes[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), 2,
                8, T, 64, st, 0.125, window, plan, _cuda.stream_ptr(q)), "banded_attention"),
            SPLIT_PHASES if plan > 1 else A_PHASES), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phase_trace: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    libs = _trace_libraries()
    b1, b2 = libs["ln_gemm.cu"], libs["block_tail.cu"]
    gen = torch.Generator(device=dev).manual_seed(0)
    trace_attention(libs["flash_attention.cu"], dev, gen)
    codes = _cuda.DTYPE_CODE
    C, inner, F = 256, 512, 1024
    for dtype in (torch.float32, torch.bfloat16):
        for M in ROWS:
            def mk(*shape, scale=0.05):
                return (torch.randn(*shape, device=dev, generator=gen) * scale).to(dtype)

            x, lw, lb = mk(M, C, scale=1.0), mk(C), mk(C)
            w = [mk(inner, C) for _ in range(3)]  # Wq, Wk, Wv: three segments
            y = torch.empty(M, 3 * inner, device=dev, dtype=dtype)
            plan = _ln_gemm_plan(M, 3 * inner, C, dtype)
            print(f"B1 {str(dtype)[6:]} M={M} plan {plan} us: " + _phases(b1, lambda: _cuda.check(
                b1.cosy_ln_gemm(codes[dtype], codes[dtype], codes[dtype], x.data_ptr(),
                                lw.data_ptr(), lb.data_ptr(), *(t.data_ptr() for t in w),
                                inner, y.data_ptr(), M, 3 * inner, C, 1e-5, *plan,
                                _cuda.stream_ptr(x)), "ln_gemm"), B1_PHASES), flush=True)
            ts = (mk(M, inner, scale=1.0), x, mk(C, inner), mk(C), mk(C), mk(C), mk(F, C), mk(F),
                  mk(C, F), mk(C), torch.empty(M, C, device=dev, dtype=dtype))
            plan = _tail_plan(M, C, inner, F, dtype)
            print(f"B2 {str(dtype)[6:]} M={M} plan {plan} us: " + _phases(
                b2, lambda: _cuda.check(b2.cosy_block_tail(
                    codes[dtype], *(t.data_ptr() for t in ts), M, C, inner, F, 1e-5, 1,
                    *plan, _cuda.stream_ptr(x)), "block_tail"), B2_PHASES), flush=True)


if __name__ == "__main__":
    main()
