"""Build and load the hand-written Hopper kernels.

The CUDA C++ sources under ``cosy_tpu_torch/csrc/`` are compiled at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into one shared library
per source (all ``nvcc`` processes started together) and loaded with
``ctypes``: a plain C interface builds in seconds, where a PyTorch extension
takes minutes.  The libraries go to ``utils.aot.cache_dir()`` (the
git-ignored ``build/cosy_tpu_torch/`` beside the package unless ``serve
--aot-cache DIR`` set another), named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is loaded without nvcc.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from ..utils import aot

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_attention.cu", "fused_block.cu", "block_tail.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SMS = 132  # streaming multiprocessors of an H100: what the kernels' plans fill

# codes of csrc/common.cuh ``enum DType``; fp16 is refused (the -1e10
# attention bias overflows it)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
# argtypes of every C entry point (pointers and the stream as c_void_p so
# ctypes never truncates them to 32 bits)
SIGNATURES = {
    "cosy_flash_attention": ("flash_attention.cu", [
        _i, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
        ctypes.POINTER(ctypes.c_longlong), _f, _i, _i, _vp]),
    "cosy_banded_attention": ("flash_attention.cu", [
        _i, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
        ctypes.POINTER(ctypes.c_longlong), _f, _i, _i, _i, _vp]),
    "cosy_layer_norm": ("fused_block.cu", [
        _i, _i, _i, _vp, _vp, _vp, _vp, _i, _i, _f, _vp]),
    "cosy_gemm": ("fused_block.cu", [
        _i, _i, _i, _vp, _vp, _vp, _vp, _i, _vp, _vp, _vp, _i, _i, _i, _i,
        _i, _i, _i, _vp]),
    "cosy_ln_gemm": ("fused_block.cu", [
        _i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _i, _vp, _i, _i, _i, _f,
        _i, _i, _i, _vp]),
    "cosy_block_tail": ("block_tail.cu", [
        _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
        _f, _i, _i, _i, _i, _vp]),
}

_lock = threading.Lock()
# (library directory, entry point) -> the ctypes function
_functions: Dict[Tuple[str, str], object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the GPU, from cosy_tpu_torch/csrc")
    return path


def _library_path(source: str, directory: Path) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return directory / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build() -> List[Path]:
    """Compile every source whose library is missing from the cache
    directory, one ``nvcc`` per source, all started together (each counted
    in ``aot.AOT_STATS``).  Returns the library paths; raises with nvcc's
    output if a build fails."""
    directory = aot.library_dir()
    jobs = []
    for source in SOURCES:
        out = _library_path(source, directory)
        if out.exists():
            aot.record(out, built=False)
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        jobs.append((source, out, tmp,
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {source} (rc {proc.returncode})\n{log}")
            continue
        # ptxas -v: each kernel's registers, shared memory and spills
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        aot.record(out, built=True)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return [_library_path(s, directory) for s in SOURCES]


def function(name: str):
    """The ctypes function ``name`` with its argtypes set, building and
    loading its library from the cache directory on first use."""
    key = (str(aot.cache_dir()), name)
    fn = _functions.get(key)
    if fn is not None:
        return fn
    with _lock:
        if key not in _functions:
            source, argtypes = SIGNATURES[name]
            path = _library_path(source, aot.library_dir())
            if path.exists():
                aot.record(path, built=False)
            else:
                build()
            fn = getattr(ctypes.CDLL(str(path)), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[key] = fn
    return _functions[key]


def check(err: int, what: str):
    """Raise if a C entry point returned a non-zero cudaError_t (a refused
    launch never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def refuse_grad(what: str, *tensors):
    """Raise when autograd would record through a kernel wrapper: the
    kernels have no backward, so a tensor that requires a gradient must take
    the plain torch ops (the training path never enters a kernel)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: an input requires a gradient; training "
            "runs the plain torch ops (Ctx.train / the gates in layers)")


def cdiv(a: int, b: int) -> int:
    """ceil(a / b) for positive ints."""
    return -(-a // b)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
