"""Where the time goes inside kernels B1 and B2: a phase trace on the card.

    python -m cosy_tpu_torch.ops.phase_trace

Builds ``csrc/ln_gemm.cu`` and ``csrc/block_tail.cu`` once more with
``-DCOSY_TRACE`` into ``build/cosy_tpu_torch/trace/`` (the library build has
no trace), launches B1 on the QKV product and B2 on the block tail at the
main path's row counts in f32 and bf16 with their plans, and prints, for
block 0, the microseconds from the kernel's first phase to each later one
(``%globaltimer``, read back through ``cosy_trace``):

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

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ..utils import aot
from . import _cuda
from .fused_block import _ln_gemm_plan, _tail_plan

ROWS = (312, 624, 5116)
B1_PHASES = (10, 17, 11, 14, 15, 16, 12, 13)
B2_PHASES = tuple(range(8))


def _trace_libraries():
    out = aot.library_dir() / "trace"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda._nvcc()
    jobs = {src: subprocess.Popen([nvcc, *_cuda.NVCC_FLAGS, "-DCOSY_TRACE", "-o",
                                   str(out / f"{src[:-3]}.so"), str(_cuda.CSRC / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in ("ln_gemm.cu", "block_tail.cu")}
    libs = {}
    for src, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"trace build of {src} failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"{src[:-3]}.so"))
        lib.cosy_trace.argtypes = [ctypes.c_void_p]
        lib.cosy_trace.restype = ctypes.c_int
        libs[src] = lib
    for name, src in (("cosy_ln_gemm", "ln_gemm.cu"), ("cosy_block_tail", "block_tail.cu")):
        fn = getattr(libs[src], name)
        fn.argtypes = _cuda.SIGNATURES[name][1]
        fn.restype = ctypes.c_int
    return libs["ln_gemm.cu"], libs["block_tail.cu"]


def _phases(lib, launch, marks, runs: int = 5):
    """us from the first mark to each mark, block 0, of the last of ``runs``
    launches (the earlier ones warm the caches)."""
    buf = (ctypes.c_longlong * 32)()
    for _ in range(runs):
        launch()
        torch.cuda.synchronize()
    _cuda.check(lib.cosy_trace(buf), "cosy_trace")
    return " ".join(f"{m}:{(buf[m] - buf[marks[0]]) / 1e3:.2f}" for m in marks)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phase_trace: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    b1, b2 = _trace_libraries()
    gen = torch.Generator(device=dev).manual_seed(0)
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
