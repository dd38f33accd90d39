"""The build cache of the port's compiled libraries, and ``serve
--aot-cache DIR`` (the counterpart of the JAX package's ``utils/aot.py``).

JAX serializes XLA executables so that a server's second start loads what
its first one compiled.  PyTorch has no serialized executables; what the
port compiles at start are the nvcc libraries of the Hopper kernels
(``ops/_cuda.py``) and the g++ libraries of the host kernels
(``native/__init__.py``).  Both are named by a hash of their sources and
flags, so a library found on disk is loaded without running a compiler,
and an edited source misses.  ``set_cache_dir(DIR)`` makes ``DIR`` their
build-and-load directory in place of the checkout's git-ignored
``build/cosy_tpu_torch/``.

Loading a shared library runs its code, as unpickling a JAX blob does, so
a directory given here is created 0700 and must be owned by this user
(or root) and writable by no group or other user.  Where JAX recompiles
silently past an untrusted directory, the port raises and names it.

``AOT_STATS`` counts, once a library a process, ``hits`` (found on disk
and loaded) and ``misses`` (compiled).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Optional, Union

__all__ = ["AOT_STATS", "DEFAULT_DIR", "UntrustedCacheDir", "cache_dir", "library_dir",
           "record", "set_cache_dir"]

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "cosy_tpu_torch"

AOT_STATS = {"hits": 0, "misses": 0}

_lock = threading.Lock()
_cache_dir: Optional[Path] = None
_seen = set()


class UntrustedCacheDir(PermissionError):
    """A cache directory that another user could write a library into."""


def _check_trusted(path: Path) -> None:
    """Raise unless ``path`` is owned by this user (or root) and is not
    group- or world-writable (JAX's ``_dir_is_trusted``)."""
    st = os.stat(path)
    if hasattr(os, "getuid") and st.st_uid not in (os.getuid(), 0):
        raise UntrustedCacheDir(f"the library cache {path} is owned by uid {st.st_uid}, not "
                                "this user: loading a library from it would run its code")
    if st.st_mode & 0o022:
        raise UntrustedCacheDir(f"the library cache {path} is group- or world-writable "
                                f"(mode {st.st_mode & 0o777:o}): loading a library from it "
                                "would run code another user could have planted")


def set_cache_dir(path: Union[str, os.PathLike, None]) -> Optional[Path]:
    """Build and load the port's libraries in ``path`` (created 0700; raises
    :class:`UntrustedCacheDir` if another user could write to it); None
    returns to ``build/cosy_tpu_torch/``.  Returns the directory."""
    global _cache_dir
    if path is None:
        _cache_dir = None
        return None
    d = Path(path).resolve()
    d.mkdir(mode=0o700, parents=True, exist_ok=True)
    _check_trusted(d)
    _cache_dir = d
    return d


def cache_dir() -> Path:
    """The directory the libraries are built into and loaded from."""
    return DEFAULT_DIR if _cache_dir is None else _cache_dir


def library_dir() -> Path:
    """:func:`cache_dir`, created, and checked again for trust when it is a
    directory given to :func:`set_cache_dir` (its mode may have changed
    since)."""
    d = cache_dir()
    if _cache_dir is None:
        d.mkdir(parents=True, exist_ok=True)
    else:
        _check_trusted(d)
    return d


def record(library: Path, built: bool) -> None:
    """Count ``library`` once in this process: a miss if it was compiled,
    a hit if it was found on disk."""
    with _lock:
        if library in _seen:
            return
        _seen.add(library)
        AOT_STATS["misses" if built else "hits"] += 1
