"""ONNX wire-format writer: :class:`GraphBuilder` assembles a graph node by
node and serializes it as ModelProto bytes (the port's copy of the
``GraphBuilder`` and wire writers of the JAX package's
``compat/onnx_export.py``).  The port uses it to build the extractor
replicas (``compat/replicas.py``); the estimator exporter is not ported
yet.  The reader is ``compat/onnx.py``."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["GraphBuilder"]


# ---------------------------------------------------------------------------
# protobuf wire-format writer (the reader lives in compat/onnx.py)
# ---------------------------------------------------------------------------

_NP2ONNX = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
            np.dtype(np.int8): 3, np.dtype(np.int32): 6,
            np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
            np.dtype(np.float16): 10, np.dtype(np.float64): 11}


def _uv(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _f(fno: int, wt: int) -> bytes:
    return _uv((fno << 3) | wt)


def _ld(fno: int, payload: bytes) -> bytes:
    return _f(fno, 2) + _uv(len(payload)) + payload


def _tensor(arr: np.ndarray, name: str = "") -> bytes:
    shape = np.shape(arr)  # before ascontiguousarray: it promotes 0-d to (1,)
    arr = np.ascontiguousarray(arr)
    out = b"".join(_f(1, 0) + _uv(d) for d in shape)
    out += _f(2, 0) + _uv(_NP2ONNX[arr.dtype])
    if name:
        out += _ld(8, name.encode())
    out += _ld(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return out


def _attr(name: str, val) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(val, float):
        out += _f(2, 5) + struct.pack("<f", val) + _f(20, 0) + _uv(1)
    elif isinstance(val, bool) or isinstance(val, int):
        out += _f(3, 0) + _uv(int(val)) + _f(20, 0) + _uv(2)
    elif isinstance(val, str):
        out += _ld(4, val.encode()) + _f(20, 0) + _uv(3)
    elif isinstance(val, np.ndarray):
        out += _ld(5, _tensor(val)) + _f(20, 0) + _uv(4)
    elif isinstance(val, (list, tuple)) and val and isinstance(val[0], float):
        out += b"".join(_f(7, 5) + struct.pack("<f", v) for v in val)
        out += _f(20, 0) + _uv(6)
    elif isinstance(val, (list, tuple)):
        out += b"".join(_f(8, 0) + _uv(int(v)) for v in val)
        out += _f(20, 0) + _uv(7)
    else:
        raise TypeError(type(val))
    return out


def _vinfo(name: str, dtype, shape: Sequence[int]) -> bytes:
    dims = b"".join(_ld(1, _f(1, 0) + _uv(int(d))) for d in shape)
    ttype = _f(1, 0) + _uv(_NP2ONNX[np.dtype(dtype)]) + _ld(2, dims)
    return _ld(1, name.encode()) + _ld(2, _ld(1, ttype))


class GraphBuilder:
    """Incremental ONNX graph assembly with auto-named values."""

    def __init__(self):
        self._nodes: List[bytes] = []
        self._inits: Dict[str, np.ndarray] = {}
        self._n = 0

    def name(self, hint: str = "v") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, arr, hint: str = "c") -> str:
        arr = np.asarray(arr)
        name = self.name(hint)
        self._inits[name] = arr
        return name

    def weight(self, name: str, arr: np.ndarray) -> str:
        """Register a model weight under its checkpoint name (provenance)."""
        self._inits[name] = np.asarray(arr, np.float32)
        return name

    def add(self, op: str, inputs: Sequence[str], n_out: int = 1,
            out_names: Optional[Sequence[str]] = None, **attrs) -> str:
        outs = list(out_names) if out_names else \
            [self.name(op.lower()) for _ in range(n_out)]
        node = b"".join(_ld(1, i.encode()) for i in inputs)
        node += b"".join(_ld(2, o.encode()) for o in outs)
        node += _ld(4, op.encode())
        node += b"".join(_ld(5, _attr(k, v)) for k, v in attrs.items())
        self._nodes.append(node)
        return outs[0] if n_out == 1 else tuple(outs)

    def finish(self, inputs: Sequence[Tuple[str, object, Sequence[int]]],
               outputs: Sequence[Tuple[str, object, Sequence[int]]],
               opset: int = 17) -> bytes:
        g = b"".join(_ld(1, n) for n in self._nodes)
        g += b"".join(_ld(5, _tensor(a, n)) for n, a in self._inits.items())
        g += _ld(2, b"cosy_tpu_estimator")
        g += b"".join(_ld(11, _vinfo(n, dt, sh)) for n, dt, sh in inputs)
        g += b"".join(_ld(12, _vinfo(n, dt, sh)) for n, dt, sh in outputs)
        m = _f(1, 0) + _uv(8)  # ir_version
        m += _ld(2, b"cosy_tpu")  # producer_name
        m += _ld(7, g)
        m += _ld(8, _ld(1, b"") + _f(2, 0) + _uv(opset))
        return m
