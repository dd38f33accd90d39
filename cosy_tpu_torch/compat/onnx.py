"""Native ONNX ingestion: parse an ``.onnx`` file and run its graph with
torch ops on one device (the port of the JAX package's ``compat/onnx.py``).

The reference's data prep runs two frozen models from the pretrained model
dir through onnxruntime, the campplus speaker encoder and the S3 speech
tokenizer (reference: cosyvoice/cli/frontend.py:54-63, 131-152;
prepare_joint_data.py:106-158).  Here the graph runs on the port's device
with no extra runtime: the card has no onnxruntime, and a package of
finished kernels is not a dependency of the port.

Two layers:

- A minimal protobuf **wire-format** reader for the ONNX message subset
  (ModelProto/GraphProto/NodeProto/AttributeProto/TensorProto/ValueInfoProto),
  the JAX package's reader as it is.
- A graph **executor** mapping ONNX ops onto torch.  Float initializers are
  data and move to the device once; the graph's inputs move there on every
  run.  Integer and boolean initializers, ``Shape`` outputs and everything
  computed from them alone stay host numpy: the shape machinery torch
  exporters emit for every view op (Shape/Gather/Concat/Range/
  ConstantOfShape/Reshape targets) then runs on the host, with no device
  synchronization and no int64 tensor on the card, as the JAX executor
  folds it at trace time (its ``_is_static`` / ``_xp`` rule).  A value
  reaches the device only when it meets a device tensor; the executor never
  moves device data back to the host.

Supported ops cover standard torch CNN/transformer exports (conv/pool/norm/
attention/reductions/VQ-style argmin+gather).  Unsupported ops raise with
the op name so coverage gaps are loud, not silent.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..params import resolve_device

__all__ = ["OnnxModel", "parse_model", "supported_ops"]


@functools.lru_cache(maxsize=1)
def supported_ops() -> frozenset:
    """Every ONNX op type the graph executor dispatches, derived from this
    module's own source (the ``_exec`` if-chain plus the ``simple`` /
    ``binops`` tables), so the set cannot drift from the dispatcher."""
    import inspect
    import re
    import sys

    src = inspect.getsource(sys.modules[__name__])
    ops = set(re.findall(r'op == "(\w+)"', src))
    for group in re.findall(r"op in \(([^)]*)\)", src):
        ops.update(re.findall(r'"(\w+)"', group))
    for table in re.findall(r"(?:simple|binops) = \{(.*?)\n        \}", src, re.S):
        ops.update(re.findall(r'"(\w+)":', table))
    return frozenset(ops)


# ---------------------------------------------------------------------------
# protobuf wire-format primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    val, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _signed(val: int) -> int:
    """proto int64 fields encode negatives as 64-bit two's complement."""
    return val - (1 << 64) if val >= (1 << 63) else val


def _fields(buf: bytes):
    """Yield (field_number, wire_type, payload) for every field in ``buf``.

    payload: int for varint (0), bytes for length-delimited (2),
    4/8-byte little-endian bytes for fixed32 (5) / fixed64 (1).
    """
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
            yield fno, wt, val
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            yield fno, wt, buf[i : i + ln]
            i += ln
        elif wt == 5:
            yield fno, wt, buf[i : i + 4]
            i += 4
        elif wt == 1:
            yield fno, wt, buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _packed_varints(payload, wt) -> List[int]:
    """Repeated int field: packed (wt 2) or a single scalar (wt 0)."""
    if wt == 0:
        return [_signed(payload)]
    out, i = [], 0
    while i < len(payload):
        v, i = _read_varint(payload, i)
        out.append(_signed(v))
    return out


def _packed_floats(payload, wt) -> List[float]:
    if wt == 5:
        return [struct.unpack("<f", payload)[0]]
    return list(np.frombuffer(payload, "<f4"))


# ---------------------------------------------------------------------------
# ONNX message subset
# ---------------------------------------------------------------------------

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = 1
    raw = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    uint64_data: List[int] = []
    name = ""
    for fno, wt, val in _fields(buf):
        if fno == 1:
            dims += _packed_varints(val, wt)
        elif fno == 2:
            data_type = val
        elif fno == 4:
            float_data += _packed_floats(val, wt)
        elif fno == 5:
            int32_data += _packed_varints(val, wt)
        elif fno == 7:
            int64_data += _packed_varints(val, wt)
        elif fno == 8:
            name = val.decode()
        elif fno == 9:
            raw = val
        elif fno == 10:
            double_data += (list(np.frombuffer(val, "<f8")) if wt == 2
                            else [struct.unpack("<d", val)[0]])
        elif fno == 11:
            uint64_data += _packed_varints(val, wt)
        elif fno == 13:
            raise NotImplementedError("external_data tensors not supported")
    dt = _DTYPES.get(data_type)
    if dt is None:
        raise NotImplementedError(f"tensor dtype {data_type} ({name})")
    if raw is not None:
        arr = np.frombuffer(raw, np.dtype(dt).newbyteorder("<")).astype(dt)
    elif float_data:
        arr = np.asarray(float_data, np.float32).astype(dt)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64).astype(dt)
    elif uint64_data:
        arr = np.asarray(uint64_data, np.uint64).astype(dt)
    elif double_data:
        arr = np.asarray(double_data, np.float64).astype(dt)
    elif int32_data:
        if dt == np.float16:  # spec: fp16 bits ride in int32_data
            arr = np.asarray(int32_data, np.uint16).view(np.float16)
        else:
            arr = np.asarray(int32_data, np.int64).astype(dt)
    else:
        arr = np.zeros(0, dt)
    # no dims field means rank 0: a size-1 buffer reshapes to (); any other
    # size with empty dims is malformed and reshape raises
    return name, arr.reshape(dims)


@dataclasses.dataclass
class _Attr:
    name: str
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[np.ndarray] = None
    floats: List[float] = dataclasses.field(default_factory=list)
    ints: List[int] = dataclasses.field(default_factory=list)
    strings: List[bytes] = dataclasses.field(default_factory=list)

    @property
    def value(self):
        if self.t is not None:
            return self.t
        if self.i is not None:
            return self.i
        if self.f is not None:
            return self.f
        if self.s is not None:
            return self.s.decode()
        if self.ints:
            return list(self.ints)
        if self.floats:
            return list(self.floats)
        if self.strings:
            return [s.decode() for s in self.strings]
        return None


def _parse_attr(buf: bytes) -> _Attr:
    a = _Attr(name="")
    for fno, wt, val in _fields(buf):
        if fno == 1:
            a.name = val.decode()
        elif fno == 2:
            a.f = struct.unpack("<f", val)[0]
        elif fno == 3:
            a.i = _signed(val)
        elif fno == 4:
            a.s = val
        elif fno == 5:
            a.t = _parse_tensor(val)[1]
        elif fno == 7:
            a.floats += _packed_floats(val, wt)
        elif fno == 8:
            a.ints += _packed_varints(val, wt)
        elif fno == 9:
            a.strings.append(val)
        # 6/10/11 (graph attrs) unsupported: control-flow ops raise in exec
    return a


@dataclasses.dataclass
class _Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str
    attrs: Dict[str, _Attr]

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value


def _parse_node(buf: bytes) -> _Node:
    inputs: List[str] = []
    outputs: List[str] = []
    name = op_type = ""
    attrs: Dict[str, _Attr] = {}
    for fno, wt, val in _fields(buf):
        if fno == 1:
            inputs.append(val.decode())
        elif fno == 2:
            outputs.append(val.decode())
        elif fno == 3:
            name = val.decode()
        elif fno == 4:
            op_type = val.decode()
        elif fno == 5:
            a = _parse_attr(val)
            attrs[a.name] = a
    return _Node(op_type, inputs, outputs, name, attrs)


def _parse_value_info(buf: bytes) -> Tuple[str, Optional[List[Optional[int]]]]:
    """(name, shape) — dims are ints or None for symbolic dims."""
    name, shape = "", None
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            name = val.decode()
        elif fno == 2:  # TypeProto
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _fields(v2):
                        if f3 == 2:  # shape
                            shape = []
                            for f4, _w4, v4 in _fields(v3):
                                if f4 == 1:  # dim
                                    dv = None
                                    for f5, _w5, v5 in _fields(v4):
                                        if f5 == 1:
                                            dv = _signed(v5)
                                    shape.append(dv)
    return name, shape


@dataclasses.dataclass
class _Graph:
    nodes: List[_Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]  # graph inputs EXCLUDING initializers
    outputs: List[str]
    input_shapes: Dict[str, Optional[List[Optional[int]]]]


def _parse_graph(buf: bytes) -> _Graph:
    nodes, inits, raw_inputs, outputs, shapes = [], {}, [], [], {}
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            nodes.append(_parse_node(val))
        elif fno == 5:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif fno == 11:
            n, s = _parse_value_info(val)
            raw_inputs.append(n)
            shapes[n] = s
        elif fno == 12:
            n, _ = _parse_value_info(val)
            outputs.append(n)
    inputs = [n for n in raw_inputs if n not in inits]
    return _Graph(nodes, inits, inputs, outputs, shapes)


def parse_model(data: bytes) -> Tuple[_Graph, int]:
    """Parse ModelProto bytes -> (graph, opset_version)."""
    graph, opset = None, 0
    for fno, _wt, val in _fields(data):
        if fno == 7:
            graph = _parse_graph(val)
        elif fno == 8:  # opset_import
            dom, ver = "", 0
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:
                    dom = v2.decode()
                elif f2 == 2:
                    ver = v2
            if dom in ("", "ai.onnx"):
                opset = max(opset, ver)
    if graph is None:
        raise ValueError("no graph in ONNX model")
    return graph, opset


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


def _is_static(*vals) -> bool:
    """True when every value is host data (numpy / python): such subgraphs
    (shape machinery) are computed in numpy on the host."""
    return all(
        v is None or isinstance(v, (np.ndarray, np.generic, int, float, list, tuple))
        for v in vals
    )


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


# numpy names of the elementwise ops the executor uses -> their torch ops
_ELEMENTWISE = {
    "maximum": torch.maximum, "minimum": torch.minimum, "exp": torch.exp,
    "tanh": torch.tanh, "sqrt": torch.sqrt, "log": torch.log, "abs": torch.abs,
    "floor": torch.floor, "ceil": torch.ceil, "sin": torch.sin, "cos": torch.cos,
    "round": torch.round, "sign": torch.sign, "logaddexp": torch.logaddexp,
    "logical_not": torch.logical_not, "add": torch.add, "subtract": torch.sub,
    "multiply": torch.mul, "divide": torch.true_divide, "power": torch.pow,
    "equal": torch.eq, "greater": torch.gt, "less": torch.lt, "greater_equal": torch.ge,
    "less_equal": torch.le, "logical_and": torch.logical_and,
    "logical_or": torch.logical_or, "mod": torch.remainder, "fmod": torch.fmod,
    "matmul": torch.matmul,
}


class _Torch:
    """The numpy names the executor uses, over torch tensors on one device.
    A host value (numpy or python) becomes a tensor there when it meets a
    device tensor: float64 as float32, the JAX executor's 32-bit default."""

    def __init__(self, device: torch.device):
        self.device = device

    def t(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v
        arr = np.asarray(v)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.as_tensor(arr, device=self.device)

    def __getattr__(self, name):
        if name not in _ELEMENTWISE:
            raise AttributeError(name)
        fn = _ELEMENTWISE[name]
        return lambda *xs: fn(*(self.t(x) for x in xs))

    @staticmethod
    def _dims(x, axis):
        return tuple(range(x.ndim)) if axis is None else axis

    def where(self, c, x, y):
        return torch.where(self.t(c).bool(), self.t(x), self.t(y))

    def clip(self, x, lo, hi):
        return torch.clamp(self.t(x), lo, hi)

    def ones_like(self, x, dtype):
        return torch.ones_like(self.t(x), dtype=_torch_dtype(dtype))

    def mean(self, x, axis=None, keepdims=False):
        x = self.t(x)
        return torch.mean(x if x.is_floating_point() else x.float(), dim=self._dims(x, axis),
                          keepdim=keepdims)

    def var(self, x, axis=None, keepdims=False):
        x = self.t(x)
        return torch.var(x, dim=self._dims(x, axis), keepdim=keepdims, correction=0)

    def sum(self, x, axis=None, keepdims=False):
        x = self.t(x)
        return torch.sum(x, dim=self._dims(x, axis), keepdim=keepdims)

    def max(self, x, axis=None, keepdims=False):
        x = self.t(x)
        return torch.amax(x, dim=self._dims(x, axis), keepdim=keepdims)

    def min(self, x, axis=None, keepdims=False):
        x = self.t(x)
        return torch.amin(x, dim=self._dims(x, axis), keepdim=keepdims)

    def prod(self, x, axis=None, keepdims=False):
        x = self.t(x)
        for d in sorted((a % x.ndim for a in self._dims(x, axis)), reverse=True):
            x = torch.prod(x, dim=d, keepdim=keepdims)
        return x

    def argmax(self, x, axis):
        return torch.argmax(self.t(x), dim=axis)

    def argmin(self, x, axis):
        return torch.argmin(self.t(x), dim=axis)

    def expand_dims(self, x, axis):
        return torch.unsqueeze(self.t(x), axis)

    def squeeze(self, x, axis):
        return torch.squeeze(self.t(x), axis)

    def cumsum(self, x, axis):
        return torch.cumsum(self.t(x), dim=axis)

    def swapaxes(self, x, a, b):
        return torch.swapaxes(self.t(x), a, b)

    def einsum(self, eq, *xs):
        return torch.einsum(eq, *(self.t(x) for x in xs))

    def reshape(self, x, shape):
        return torch.reshape(self.t(x), tuple(int(d) for d in shape))

    def transpose(self, x, perm=None):
        x = self.t(x)
        return x.permute(*(range(x.ndim - 1, -1, -1) if perm is None else perm))

    def concatenate(self, vals, axis):
        return torch.cat([self.t(v) for v in vals], dim=axis)

    def split(self, x, idx, axis):
        x = self.t(x)
        edges = [0] + [int(i) for i in idx] + [x.shape[axis]]
        return torch.split(x, [b - a for a, b in zip(edges, edges[1:])], dim=axis)

    def take(self, x, idx, axis):
        x, idx = self.t(x), self.t(idx).long()
        idx = torch.where(idx < 0, idx + x.shape[axis], idx)
        out = torch.index_select(x, axis, idx.reshape(-1))
        return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])

    def take_along_axis(self, x, idx, axis):
        x, idx = self.t(x), self.t(idx).long()
        return torch.gather(x, axis, torch.where(idx < 0, idx + x.shape[axis], idx))

    def broadcast_to(self, x, shape):
        return torch.broadcast_to(self.t(x), tuple(shape))

    def tile(self, x, reps):
        return torch.tile(self.t(x), tuple(reps))

    def pad(self, x, pp, constant_values=0.0, mode="constant"):
        """np.pad over (lo, hi) pairs a dim: "constant", "reflect", "edge"
        or "wrap"."""
        x = self.t(x)
        if mode == "constant":
            return F.pad(x, [v for lo, hi in reversed(pp) for v in (lo, hi)],
                         value=constant_values)
        tmode = {"reflect": "reflect", "edge": "replicate", "wrap": "circular"}[mode]
        for d, (lo, hi) in enumerate(pp):
            if lo or hi:  # one dim at a time, as the last dim of a (N, 1, L) view
                y = x.movedim(d, -1)
                shape = y.shape
                y = F.pad(y.reshape(-1, 1, shape[-1]), (lo, hi), mode=tmode)
                x = y.reshape(shape[:-1] + (y.shape[-1],)).movedim(-1, d)
        return x


def _cast(x, to: int):
    dt = _DTYPES[int(to)]
    if isinstance(x, torch.Tensor):
        return x.to(_torch_dtype(dt))
    return np.asarray(x).astype(dt)


def _slice(x, sl):
    """x[sl]; a tensor takes a negative step as an index list."""
    if not isinstance(x, torch.Tensor) or all(s.step is None or s.step > 0 for s in sl):
        return x[tuple(sl)]
    for d, s in enumerate(sl):
        if s.step is not None and s.step < 0:
            idx = torch.arange(*s.indices(x.shape[d]), device=x.device)
            x = torch.index_select(x, d, idx)
        elif s != slice(None):
            x = x[(slice(None),) * d + (s,)]
    return x


def _pair_pads(pads: Sequence[int]) -> List[Tuple[int, int]]:
    """ONNX pads [x1_lo, x2_lo, ..., x1_hi, x2_hi, ...] -> [(lo, hi), ...]."""
    k = len(pads) // 2
    return [(int(pads[i]), int(pads[i + k])) for i in range(k)]


def _flat_pads(pads: Sequence[Tuple[int, int]]) -> List[int]:
    """[(lo, hi), ...] per spatial dim -> F.pad's last-dim-first list."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _auto_pads(auto_pad: str, in_sp, k_sp, strides, dilations):
    out = []
    for x, k, s, d in zip(in_sp, k_sp, strides, dilations):
        eff = (k - 1) * d + 1
        o = -(-x // s)
        total = max(0, (o - 1) * s + eff - x)
        lo = total // 2 if auto_pad == "SAME_UPPER" else total - total // 2
        out.append((lo, total - lo))
    return out


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _conv(tch: _Torch, node: _Node, x, w, b):
    x, w = tch.t(x), tch.t(w)
    sp = x.ndim - 2
    strides = [int(v) for v in (node.attr("strides") or [1] * sp)]
    dil = [int(v) for v in (node.attr("dilations") or [1] * sp)]
    group = int(node.attr("group", 1))
    auto = node.attr("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        pads = _auto_pads(auto, x.shape[2:], w.shape[2:], strides, dil)
    else:
        pads = _pair_pads(node.attr("pads") or [0] * (2 * sp))
    padding = [lo for lo, _ in pads]
    if any(lo != hi for lo, hi in pads):  # asymmetric: pad first
        x, padding = F.pad(x, _flat_pads(pads)), 0
    return _CONV[sp](x, w, None if b is None else tch.t(b), stride=strides, padding=padding,
                     dilation=dil, groups=group)


def _conv_transpose(tch: _Torch, node: _Node, x, w, b):
    """ONNX W is (C_in, C_out/group, *k), torch's layout.  The full
    transposed convolution is cut to the declared pads and extended by
    ``output_padding`` zeros: the JAX executor's dilated-conv form with
    pads (eff - 1 - lo, eff - 1 - hi + opad)."""
    x, w = tch.t(x), tch.t(w)
    sp = x.ndim - 2
    strides = [int(v) for v in (node.attr("strides") or [1] * sp)]
    dil = [int(v) for v in (node.attr("dilations") or [1] * sp)]
    group = int(node.attr("group", 1))
    pads = _pair_pads(node.attr("pads") or [0] * (2 * sp))
    opad = [int(v) for v in (node.attr("output_padding") or [0] * sp)]
    if node.attr("output_shape") is not None:
        raise NotImplementedError("ConvTranspose output_shape attr")
    y = _CONV_T[sp](x, w, None, stride=strides, groups=group, dilation=dil)
    for i, ((lo, hi), op_) in enumerate(zip(pads, opad)):
        n = y.shape[2 + i]
        end = n - hi + op_
        if end > n:
            y = F.pad(y, [0, 0] * (sp - 1 - i) + [0, end - n])
        y = y.narrow(2 + i, lo, end - lo)
    if b is not None:
        y = y + tch.t(b).reshape((1, -1) + (1,) * sp)
    return y


def _pool(tch: _Torch, node: _Node, x, mode: str):
    """Max and average pools as window reductions over explicitly padded
    inputs, with the JAX executor's arithmetic: ceil_mode extends the upper
    pad by stride - 1, and an average divides by the window cells inside
    the (declared) pads."""
    x = tch.t(x)
    sp = x.ndim - 2
    k = [int(v) for v in node.attr("kernel_shape")]
    strides = [int(v) for v in (node.attr("strides") or [1] * sp)]
    auto = node.attr("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        pads = _auto_pads(auto, x.shape[2:], k, strides, [1] * sp)
    else:
        pads = _pair_pads(node.attr("pads") or [0] * (2 * sp))
    declared = list(pads)
    ceil = int(node.attr("ceil_mode", 0))
    if ceil:
        # extend the upper pad so the last partial window is included
        pads = [(lo, hi + s - 1) for (lo, hi), s in zip(pads, strides)]
    if mode == "max":
        if not x.is_floating_point():
            return _pool(tch, node, x.double(), mode).to(x.dtype)
        return _MAX_POOL[sp](F.pad(x, _flat_pads(pads), value=-math.inf), k, strides)
    avg = _AVG_POOL[sp](F.pad(x, _flat_pads(pads)), k, strides)
    if int(node.attr("count_include_pad", 0)) and not ceil:
        return avg
    n = float(np.prod(k))
    if int(node.attr("count_include_pad", 0)):
        # declared-pad cells count in the denominator, the ceil-mode
        # extension does not (ORT): count window cells over the declared
        # extent, with the extension as zero padding
        ones = torch.ones([1, 1] + [x.shape[2 + i] + lo + hi
                                    for i, (lo, hi) in enumerate(declared)],
                          dtype=x.dtype, device=x.device)
        ext = [(0, p[1] - d[1]) for p, d in zip(pads, declared)]
        cnt = _AVG_POOL[sp](F.pad(ones, _flat_pads(ext)), k, strides) * n
    else:
        ones = torch.ones([1, 1] + list(x.shape[2:]), dtype=x.dtype, device=x.device)
        cnt = _AVG_POOL[sp](F.pad(ones, _flat_pads(pads)), k, strides) * n
    return avg * n / cnt


def _axes_arg(node: _Node, env, idx: int, attr_name: str = "axes"):
    """axes as attr (opset<13) or optional input (opset>=13)."""
    if len(node.inputs) > idx and node.inputs[idx]:
        return [int(v) for v in np.asarray(env[node.inputs[idx]]).reshape(-1)]
    v = node.attr(attr_name)
    return None if v is None else [int(x) for x in v]


class OnnxModel:
    """An ONNX graph run with torch ops on ``device`` (CUDA unless the caller
    passes another).  ``run(feeds)`` and ``__call__(*args)`` (positional in
    ``input_names`` order) take numpy arrays or tensors and return the
    graph's outputs as tensors on the device (host numpy for an output
    computed from host values alone)."""

    def __init__(self, data: bytes, device=None):
        self.graph, self.opset = parse_model(data)
        self.device = resolve_device(device)
        self.input_names = list(self.graph.inputs)
        self.output_names = list(self.graph.outputs)
        self._torch = _Torch(self.device)
        # float initializers are the weights: on the device once; integer and
        # boolean ones are shape data and stay on the host
        self._inits = {k: self._torch.t(v) if v.dtype.kind == "f" else v
                       for k, v in self.graph.initializers.items()}

    @classmethod
    def load(cls, path: str, device=None) -> "OnnxModel":
        with open(path, "rb") as f:
            return cls(f.read(), device)

    def _xp(self, *vals):
        return np if _is_static(*vals) else self._torch

    # -- execution ------------------------------------------------------

    def run(self, feeds: Dict[str, object]) -> List:
        missing = [n for n in self.input_names if n not in feeds]
        if missing:
            raise KeyError(f"missing graph inputs {missing}")
        env: Dict[str, object] = dict(self._inits)
        env.update({k: v.to(self.device) if isinstance(v, torch.Tensor) else self._torch.t(v)
                    for k, v in feeds.items()})
        env[""] = None  # optional (absent) inputs
        for node in self.graph.nodes:
            args = [env[n] for n in node.inputs]
            outs = self._exec(node, args, env)
            if not isinstance(outs, tuple):
                outs = (outs,)
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
        return [env[n] for n in self.output_names]

    def __call__(self, *args):
        return self.run(dict(zip(self.input_names, args)))

    # -- single-node dispatch ------------------------------------------

    def _exec(self, node: _Node, a: List, env: Dict):
        op = node.op_type
        xp = self._xp(*a)

        # -- elementwise / unary
        simple = {
            "Relu": lambda x: xp.maximum(x, 0),
            "Sigmoid": lambda x: 1 / (1 + xp.exp(-x)),
            "Tanh": xp.tanh, "Sqrt": xp.sqrt, "Exp": xp.exp, "Log": xp.log,
            "Neg": lambda x: -x, "Abs": xp.abs, "Floor": xp.floor,
            "Ceil": xp.ceil, "Identity": lambda x: x,
            "Sin": xp.sin, "Cos": xp.cos,
            "Erf": None, "Round": xp.round, "Sign": xp.sign,
            "Softplus": lambda x: xp.logaddexp(x, 0.0),
            "Reciprocal": lambda x: 1 / x,
            "Not": xp.logical_not,
        }
        if op in simple:
            if op == "Erf":
                if xp is np:
                    from scipy.special import erf as _erf  # host fold

                    return _erf(a[0])
                return torch.erf(a[0])
            return simple[op](a[0])
        binops = {
            "Add": xp.add, "Sub": xp.subtract, "Mul": xp.multiply,
            "Div": xp.divide, "Pow": xp.power,
            "Min": xp.minimum, "Max": xp.maximum,
            "Equal": xp.equal, "Greater": xp.greater, "Less": xp.less,
            "GreaterOrEqual": xp.greater_equal, "LessOrEqual": xp.less_equal,
            "And": xp.logical_and, "Or": xp.logical_or,
            "Mod": xp.mod,
        }
        if op in binops:
            if op == "Div" and _is_static(*a) and all(
                    np.issubdtype(np.asarray(v).dtype, np.integer) for v in a):
                return np.asarray(a[0]) // np.asarray(a[1])  # proto int div
            if op == "Mod" and int(node.attr("fmod", 0)):
                return xp.fmod(a[0], a[1])  # C fmod (mandatory for floats)
            return binops[op](a[0], a[1])
        if op == "LeakyRelu":
            alpha = float(node.attr("alpha", 0.01))
            return xp.where(a[0] >= 0, a[0], alpha * a[0])
        if op == "PRelu":
            return xp.where(a[0] >= 0, a[0], xp.multiply(a[1], a[0]))
        if op == "Elu":
            alpha = float(node.attr("alpha", 1.0))
            return xp.where(a[0] >= 0, a[0], alpha * (xp.exp(a[0]) - 1))
        if op == "HardSigmoid":
            al, be = float(node.attr("alpha", 0.2)), float(node.attr("beta", 0.5))
            return xp.clip(al * a[0] + be, 0, 1)
        if op == "Gelu":
            x = self._torch.t(a[0])
            if node.attr("approximate", "none") == "tanh":
                return 0.5 * x * (1 + torch.tanh(
                    math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))
            return 0.5 * x * (1 + torch.erf(x / math.sqrt(2.0)))
        if op == "Clip":
            lo = a[1] if len(a) > 1 and a[1] is not None else node.attr("min")
            hi = a[2] if len(a) > 2 and a[2] is not None else node.attr("max")
            y = a[0]
            if lo is not None:
                y = xp.maximum(y, lo)
            if hi is not None:
                y = xp.minimum(y, hi)
            return y
        if op == "Where":
            return xp.where(a[0], a[1], a[2])
        if op == "Cast":
            return _cast(a[0], node.attr("to"))
        if op == "Dropout":  # inference: identity (+ optional all-true mask)
            outs = (a[0],)
            if len(node.outputs) > 1:
                outs += (xp.ones_like(a[0], dtype=bool),)
            return outs

        # -- reductions
        if op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
                  "ReduceProd", "ReduceL2"):
            axes = _axes_arg(node, env, 1)
            keep = bool(node.attr("keepdims", 1))
            ax = None if axes is None else tuple(axes)
            fn = {"ReduceMean": xp.mean, "ReduceSum": xp.sum,
                  "ReduceMax": xp.max, "ReduceMin": xp.min,
                  "ReduceProd": xp.prod,
                  "ReduceL2": lambda v, axis, keepdims: xp.sqrt(
                      xp.sum(v * v, axis=axis, keepdims=keepdims))}[op]
            return fn(a[0], axis=ax, keepdims=keep)
        if op in ("ArgMax", "ArgMin"):
            axis = int(node.attr("axis", 0))
            keep = bool(node.attr("keepdims", 1))
            if int(node.attr("select_last_index", 0)):
                raise NotImplementedError("ArgMax select_last_index")
            fn = xp.argmax if op == "ArgMax" else xp.argmin
            y = fn(a[0], axis=axis)
            if keep:
                y = xp.expand_dims(y, axis)
            return _cast(y, 7)
        if op == "CumSum":
            axis = int(np.asarray(a[1]).reshape(()))
            if int(node.attr("exclusive", 0)) or int(node.attr("reverse", 0)):
                raise NotImplementedError("CumSum exclusive/reverse")
            return xp.cumsum(a[0], axis=axis)
        if op == "TopK":
            k = int(np.asarray(a[1]).reshape(-1)[0])
            axis = int(node.attr("axis", -1))
            if not int(node.attr("largest", 1)):
                raise NotImplementedError("TopK largest=0")
            v, i = torch.topk(self._torch.t(a[0]), k, dim=axis)
            return v, i

        # -- linalg
        if op == "MatMul":
            return xp.matmul(a[0], a[1])
        if op == "Gemm":
            alpha = float(node.attr("alpha", 1.0))
            beta = float(node.attr("beta", 1.0))
            A = xp.swapaxes(a[0], -1, -2) if int(node.attr("transA", 0)) else a[0]
            B = xp.swapaxes(a[1], -1, -2) if int(node.attr("transB", 0)) else a[1]
            y = alpha * xp.matmul(A, B)
            if len(a) > 2 and a[2] is not None:
                y = xp.add(y, beta * a[2])
            return y
        if op == "Einsum":
            return xp.einsum(node.attr("equation"), *a)

        # -- shape machinery (host numpy while every input is host data)
        if op == "Shape":
            shp = np.asarray(np.shape(a[0]), np.int64)
            s, e = node.attr("start"), node.attr("end")
            if s is not None or e is not None:
                shp = shp[slice(s, e)]
            return shp
        if op == "Size":
            return np.asarray(int(np.prod(np.shape(a[0]))), np.int64)
        if op == "Constant":
            for key in ("value", "value_float", "value_int", "value_floats",
                        "value_ints"):
                v = node.attr(key)
                if v is not None:
                    return np.asarray(v)
            raise NotImplementedError("Constant without value")
        if op == "ConstantOfShape":
            v = node.attr("value")
            fill = v.reshape(-1)[0] if v is not None else np.float32(0)
            return np.full([int(d) for d in np.asarray(a[0]).reshape(-1)], fill)
        if op == "Reshape":
            shape = [int(v) for v in np.asarray(a[1]).reshape(-1)]
            if int(node.attr("allowzero", 0)) == 0:
                shape = [np.shape(a[0])[i] if v == 0 else v
                         for i, v in enumerate(shape)]
            return xp.reshape(a[0], shape)
        if op == "Transpose":
            perm = node.attr("perm")
            return xp.transpose(a[0], None if perm is None else [int(p) for p in perm])
        if op == "Squeeze":
            axes = _axes_arg(node, env, 1)
            if axes is None:
                axes = [i for i, d in enumerate(np.shape(a[0])) if d == 1]
            y = a[0]
            for ax in sorted([int(v) % np.ndim(a[0]) for v in axes], reverse=True):
                y = xp.squeeze(y, axis=ax)
            return y
        if op == "Unsqueeze":
            raw = _axes_arg(node, env, 1)
            out_nd = np.ndim(a[0]) + len(raw)
            axes = sorted(int(v) % out_nd for v in raw)
            y = a[0]
            for ax in axes:
                y = xp.expand_dims(y, ax)
            return y
        if op == "Concat":
            axis = int(node.attr("axis"))
            vals = [v for v in a if v is not None]
            return self._xp(*vals).concatenate(vals, axis=axis)
        if op == "Split":
            axis = int(node.attr("axis", 0))
            n_out = len(node.outputs)
            if len(a) > 1 and a[1] is not None:
                sizes = [int(v) for v in np.asarray(a[1]).reshape(-1)]
            elif node.attr("split") is not None:
                sizes = [int(v) for v in node.attr("split")]
            else:
                d = np.shape(a[0])[axis]
                q, r = divmod(d, n_out)
                sizes = [q + (1 if i < r else 0) for i in range(n_out)]
            idx = np.cumsum(sizes)[:-1]
            return tuple(xp.split(a[0], idx, axis=axis))
        if op == "Slice":
            if len(node.inputs) > 1:  # opset >= 10: dynamic operands
                starts = [int(v) for v in np.asarray(a[1]).reshape(-1)]
                ends = [int(v) for v in np.asarray(a[2]).reshape(-1)]
                axes = ([int(v) for v in np.asarray(a[3]).reshape(-1)]
                        if len(a) > 3 and a[3] is not None else list(range(len(starts))))
                steps = ([int(v) for v in np.asarray(a[4]).reshape(-1)]
                         if len(a) > 4 and a[4] is not None else [1] * len(starts))
            else:
                starts = [int(v) for v in node.attr("starts")]
                ends = [int(v) for v in node.attr("ends")]
                axes = [int(v) for v in (node.attr("axes") or range(len(starts)))]
                steps = [1] * len(starts)
            sl = [slice(None)] * np.ndim(a[0])
            for st, en, ax, sp in zip(starts, ends, axes, steps):
                big = 2**31
                sl[ax] = slice(None if st == -big else st,
                               None if en >= big or en <= -big else en,
                               sp)
            return _slice(a[0], sl)
        if op == "Gather":
            axis = int(node.attr("axis", 0))
            if xp is np:
                return np.take(a[0], np.asarray(a[1]).astype(np.int64), axis=axis)
            return xp.take(a[0], a[1], axis)
        if op == "GatherElements":
            axis = int(node.attr("axis", 0))
            if xp is np:
                return np.take_along_axis(a[0], np.asarray(a[1]).astype(np.int64), axis=axis)
            return xp.take_along_axis(a[0], a[1], axis)
        if op == "Expand":
            shape = [int(v) for v in np.asarray(a[1]).reshape(-1)]
            tgt = np.broadcast_shapes(tuple(np.shape(a[0])), tuple(shape))
            return xp.broadcast_to(a[0], tgt)
        if op == "Flatten":
            ax = int(node.attr("axis", 1))
            shp = np.shape(a[0])
            return xp.reshape(a[0], (int(np.prod(shp[:ax], initial=1)),
                                     int(np.prod(shp[ax:], initial=1))))
        if op == "Tile":
            reps = [int(v) for v in np.asarray(a[1]).reshape(-1)]
            return xp.tile(a[0], reps)
        if op == "Range":
            s, l, d = (np.asarray(v).reshape(()) for v in a)
            return np.arange(s, l, d)
        if op == "Pad":
            mode = node.attr("mode", "constant")
            if len(node.inputs) > 1 and node.inputs[1]:
                pads = [int(v) for v in np.asarray(a[1]).reshape(-1)]
                cval = (np.asarray(a[2]).reshape(()).item()
                        if len(a) > 2 and a[2] is not None else 0.0)
            else:
                pads = [int(v) for v in node.attr("pads")]
                cval = float(node.attr("value", 0.0))
            pp = _pair_pads(pads)
            if mode == "constant":
                return xp.pad(a[0], pp, constant_values=cval)
            return xp.pad(a[0], pp, mode={"reflect": "reflect", "edge": "edge",
                                          "wrap": "wrap"}[mode])

        # -- normalization / activation blocks
        if op == "BatchNormalization":  # inference mode: the running statistics
            x, sc, b, mean, var = a[:5]
            eps = float(node.attr("epsilon", 1e-5))
            if xp is np:
                shp = (1, -1) + (1,) * (np.ndim(x) - 2)
                scale = np.asarray(sc) / np.sqrt(np.asarray(var) + eps)
                return ((x - np.reshape(mean, shp)) * np.reshape(scale, shp)
                        + np.reshape(b, shp))
            t = self._torch.t
            return F.batch_norm(t(x), t(mean), t(var), t(sc), t(b), training=False, eps=eps)
        if op == "InstanceNormalization":
            x, sc, b = a[:3]
            eps = float(node.attr("epsilon", 1e-5))
            ax = tuple(range(2, np.ndim(x)))
            mu = xp.mean(x, axis=ax, keepdims=True)
            var = xp.var(x, axis=ax, keepdims=True)
            shp = (1, -1) + (1,) * (np.ndim(x) - 2)
            return xp.add(xp.multiply(xp.reshape(sc, shp), (x - mu) / xp.sqrt(var + eps)),
                          xp.reshape(b, shp))
        if op == "LayerNormalization":
            x, sc = a[0], a[1]
            b = a[2] if len(a) > 2 else None
            axis = int(node.attr("axis", -1))
            eps = float(node.attr("epsilon", 1e-5))
            ax = tuple(range(axis % np.ndim(x), np.ndim(x)))
            mu = xp.mean(x, axis=ax, keepdims=True)
            var = xp.var(x, axis=ax, keepdims=True)
            y = xp.multiply((x - mu) / xp.sqrt(var + eps), sc)
            if b is not None:
                y = xp.add(y, b)
            return y
        if op in ("Softmax", "LogSoftmax"):
            x = self._torch.t(a[0])
            fn = torch.softmax if op == "Softmax" else torch.log_softmax
            if self.opset < 13:
                # legacy semantics: default axis 1, coerce-to-2D — normalize
                # over ALL dims >= axis
                axis = int(node.attr("axis", 1)) % x.ndim
                return fn(x.reshape(x.shape[:axis] + (-1,)), dim=-1).reshape(x.shape)
            return fn(x, dim=int(node.attr("axis", -1)))

        # -- conv / pool
        if op == "Conv":
            return _conv(self._torch, node, a[0], a[1], a[2] if len(a) > 2 else None)
        if op == "ConvTranspose":
            return _conv_transpose(self._torch, node, a[0], a[1], a[2] if len(a) > 2 else None)
        if op == "MaxPool":
            if len(node.outputs) > 1:
                raise NotImplementedError("MaxPool indices output")
            return _pool(self._torch, node, a[0], "max")
        if op == "AveragePool":
            return _pool(self._torch, node, a[0], "avg")
        if op == "GlobalAveragePool":
            return self._xp(a[0]).mean(a[0], axis=tuple(range(2, np.ndim(a[0]))),
                                       keepdims=True)
        if op == "GlobalMaxPool":
            return self._xp(a[0]).max(a[0], axis=tuple(range(2, np.ndim(a[0]))),
                                      keepdims=True)

        raise NotImplementedError(
            f"ONNX op {op!r} (node {node.name!r}) is not supported by "
            "cosy_tpu_torch.compat.onnx — extend _exec")
