"""Native (C++) host kernels of the port, built at first use.

``f0.cpp`` is the autocorrelation pitch tracker (the port's copy of the JAX
package's ``native/f0.cpp``; reference: pyworld, a C++ library, via
cosyvoice/dataset/processor.py compute_f0); ``mas.cpp`` is monotonic
alignment search (the copy of ``native/mas.cpp``; reference: the Cython
matcha/utils/monotonic_align).  Each is compiled with the system ``g++``
(OpenMP; f0 adds ``-march=native -ffast-math``: its hot loop is a dot
product that vectorizes only under reassociation, while MAS keeps exact
float arithmetic) into ``utils.aot.cache_dir()`` (the git-ignored
``build/cosy_tpu_torch/`` beside the package unless ``serve --aot-cache
DIR`` set another), named by a hash of the source and flags, and loaded
with ``ctypes`` through a plain C entry point.  A failed build raises: nothing
falls back to the numpy versions behind the caller's back.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from pathlib import Path

from ..utils import aot

SRC_DIR = Path(__file__).resolve().parent
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp")
EXTRA_FLAGS = {"f0": ("-march=native", "-ffast-math")}

_lock = threading.Lock()
_libs = {}  # library path -> the loaded CDLL


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless a library of the same source and flags
    is in the cache directory (each counted in ``aot.AOT_STATS``); returns
    its path.  Raises with g++'s output on failure."""
    src = SRC_DIR / f"{name}.cpp"
    flags = FLAGS + EXTRA_FLAGS.get(name, ())
    h = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out = aot.library_dir() / f"lib{name}_{h}.so"
    if out.exists():
        aot.record(out, built=False)
        return out
    tmp = out.with_suffix(f".{threading.get_ident()}.tmp")
    res = subprocess.run(["g++", *flags, str(src), "-o", str(tmp)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src}:\n{res.stdout}{res.stderr}")
    tmp.replace(out)
    aot.record(out, built=True)
    return out


def f0_library() -> ctypes.CDLL:
    """The loaded pitch tracker (built on first use)."""
    with _lock:
        path = build("f0")
        if path not in _libs:
            lib = ctypes.CDLL(str(path))
            lib.cosy_extract_f0.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_int64]
            lib.cosy_extract_f0.restype = None
            _libs[path] = lib
        return _libs[path]


def mas_library() -> ctypes.CDLL:
    """The loaded monotonic alignment search (built on first use)."""
    with _lock:
        path = build("mas")
        if path not in _libs:
            lib = ctypes.CDLL(str(path))
            lib.cosy_maximum_path.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.cosy_maximum_path.restype = None
            _libs[path] = lib
        return _libs[path]
