"""ONNX export of the flow estimator (ConditionalDecoder U-Net) on a
hand-built graph: the port's copy of the JAX package's
``compat/onnx_export.py``, host numpy only.

:class:`GraphBuilder` assembles a graph node by node and serializes it as
ModelProto bytes (the extractor replicas of ``compat/replicas.py`` use it
too); :func:`export_estimator_onnx` writes the estimator with the
reference's export contract (cosyvoice/bin/export_onnx.py:34-56: inputs x,
mask, mu, t, spks, cond in NCW), the checkpoint's weight names as
initializer names and torch layouts kept (Linear (out, in), Conv1d
(out, in, k), ConvTranspose1d (in, out, k)).  Shapes are static: one graph
per serving bucket.  Composite ops expand as torch's exporter would:
GroupNorm -> Reshape / InstanceNormalization / Reshape / Mul / Add, Mish ->
Softplus / Tanh / Mul, SiLU -> Sigmoid / Mul, GELU (tanh) -> its
polynomial, attention -> MatMul / Softmax / MatMul with head reshapes.
For the same weights the bytes equal the JAX package's.  The reader and
executor is ``compat/onnx.py``.

Not exported: the prompt-isolation bias (the reference's own export omits
it), the causal / streaming CosyVoice2 estimator and MeanFlow's second
time branch.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import EstimatorConfig

__all__ = ["GraphBuilder", "export_estimator_onnx"]


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


# ---------------------------------------------------------------------------
# layer expansions
# ---------------------------------------------------------------------------


def _gemm(g: GraphBuilder, w: Dict[str, np.ndarray], name: str, x: str) -> str:
    """nn.Linear on rank-2 input: Gemm with transB=1 (torch (out,in) weight)."""
    args = [x, g.weight(name + ".weight", w[name + ".weight"])]
    if name + ".bias" in w:
        args.append(g.weight(name + ".bias", w[name + ".bias"]))
    return g.add("Gemm", args, transB=1)


def _linear_ntc(g: GraphBuilder, w: Dict[str, np.ndarray], name: str, x: str) -> str:
    """nn.Linear on (B, T, C): MatMul with the transposed weight + Add."""
    wt = g.const(np.ascontiguousarray(
        np.asarray(w[name + ".weight"], np.float32).T), name + ".weight_T")
    y = g.add("MatMul", [x, wt])
    if name + ".bias" in w:
        y = g.add("Add", [y, g.weight(name + ".bias", w[name + ".bias"])])
    return y


def _conv(g: GraphBuilder, w: Dict[str, np.ndarray], name: str, x: str,
          stride: int = 1, pad: int = 0) -> str:
    weight = np.asarray(w[name + ".weight"], np.float32)
    args = [x, g.weight(name + ".weight", weight)]
    if name + ".bias" in w:
        args.append(g.weight(name + ".bias", w[name + ".bias"]))
    return g.add("Conv", args, kernel_shape=[weight.shape[-1]],
                 strides=[stride], pads=[pad, pad])


def _conv_transpose(g: GraphBuilder, w: Dict[str, np.ndarray], name: str,
                    x: str, stride: int, pad: int) -> str:
    weight = np.asarray(w[name + ".weight"], np.float32)  # (in, out, k)
    args = [x, g.weight(name + ".weight", weight)]
    if name + ".bias" in w:
        args.append(g.weight(name + ".bias", w[name + ".bias"]))
    return g.add("ConvTranspose", args, kernel_shape=[weight.shape[-1]],
                 strides=[stride], pads=[pad, pad])


def _mish(g: GraphBuilder, x: str) -> str:
    return g.add("Mul", [x, g.add("Tanh", [g.add("Softplus", [x])])])


def _silu(g: GraphBuilder, x: str) -> str:
    return g.add("Mul", [x, g.add("Sigmoid", [x])])


def _gelu(g: GraphBuilder, x: str, approximate: bool) -> str:
    if approximate:  # tanh polynomial (torch approximate='tanh')
        c0 = g.const(np.float32(0.044715))
        c1 = g.const(np.float32(math.sqrt(2.0 / math.pi)))
        x3 = g.add("Mul", [x, g.add("Mul", [x, x])])
        inner = g.add("Mul", [c1, g.add("Add", [x, g.add("Mul", [c0, x3])])])
        t = g.add("Add", [g.const(np.float32(1.0)), g.add("Tanh", [inner])])
        return g.add("Mul", [g.add("Mul", [g.const(np.float32(0.5)), x]), t])
    inv_sqrt2 = g.const(np.float32(1.0 / math.sqrt(2.0)))
    e = g.add("Erf", [g.add("Mul", [x, inv_sqrt2])])
    half = g.const(np.float32(0.5))
    return g.add("Mul", [g.add("Mul", [half, x]),
                         g.add("Add", [g.const(np.float32(1.0)), e])])


def _group_norm(g: GraphBuilder, w: Dict[str, np.ndarray], name: str, x: str,
                B: int, C: int, T: int, groups: int = 8,
                eps: float = 1e-5) -> str:
    """GroupNorm(8) on (B, C, T) — the torch-exporter decomposition:
    Reshape (B, G, C/G*T) -> InstanceNormalization(unit scale) -> Reshape
    -> affine."""
    r = g.add("Reshape", [x, g.const(np.asarray([B, groups, -1], np.int64))])
    inorm = g.add("InstanceNormalization",
                  [r, g.const(np.ones(groups, np.float32)),
                   g.const(np.zeros(groups, np.float32))], epsilon=eps)
    back = g.add("Reshape", [inorm, g.const(np.asarray([B, C, T], np.int64))])
    scale = g.weight(name + ".weight",
                     np.asarray(w[name + ".weight"], np.float32).reshape(1, C, 1))
    bias = g.weight(name + ".bias",
                    np.asarray(w[name + ".bias"], np.float32).reshape(1, C, 1))
    return g.add("Add", [g.add("Mul", [back, scale]), bias])


def _layer_norm(g: GraphBuilder, w: Dict[str, np.ndarray], name: str, x: str) -> str:
    return g.add("LayerNormalization",
                 [x, g.weight(name + ".weight", w[name + ".weight"]),
                  g.weight(name + ".bias", w[name + ".bias"])], axis=-1)


def _block1d(g: GraphBuilder, w: Dict[str, np.ndarray], name: str, x: str,
             mask: str, B: int, C_out: int, T: int) -> str:
    """Conv3/p1 + GroupNorm(8) + Mish, masked before and after
    (unet.py block1d, modules.py:60-73).  The conv output feeds GroupNorm
    UNmasked — torch/jax include pad-position conv outputs in the
    statistics (frames_valid=None path), and parity requires matching that."""
    h = _conv(g, w, name + ".block.0", g.add("Mul", [x, mask]), pad=1)
    h = _group_norm(g, w, name + ".block.1", h, B, C_out, T)
    return g.add("Mul", [_mish(g, h), mask])


def _resnet(g: GraphBuilder, w: Dict[str, np.ndarray], name: str, x: str,
            mask: str, temb: str, B: int, C_out: int, T: int) -> str:
    h = _block1d(g, w, name + ".block1", x, mask, B, C_out, T)
    tproj = _gemm(g, w, name + ".mlp.1", _mish(g, temb))
    h = g.add("Add", [h, g.add("Unsqueeze", [tproj, g.const(np.asarray([2], np.int64))])])
    h = _block1d(g, w, name + ".block2", h, mask, B, C_out, T)
    res = _conv(g, w, name + ".res_conv", g.add("Mul", [x, mask]))
    return g.add("Add", [h, res])


def _attention(g: GraphBuilder, w: Dict[str, np.ndarray], name: str, x: str,
               bias: Optional[str], B: int, T: int, heads: int,
               inner: int) -> str:
    """diffusers attention on (B, T, C): to_q/to_k/to_v (no bias) ->
    per-head softmax(QK^T * scale + bias) V -> to_out.0."""
    dh = inner // heads
    hshape = g.const(np.asarray([B, T, heads, dh], np.int64))

    def split_heads(proj):
        r = g.add("Reshape", [proj, hshape])
        return g.add("Transpose", [r], perm=[0, 2, 1, 3])  # (B, H, T, dh)

    q = split_heads(_linear_ntc(g, w, name + ".to_q", x))
    k = split_heads(_linear_ntc(g, w, name + ".to_k", x))
    v = split_heads(_linear_ntc(g, w, name + ".to_v", x))
    kT = g.add("Transpose", [k], perm=[0, 1, 3, 2])
    scores = g.add("Mul", [g.add("MatMul", [q, kT]),
                           g.const(np.float32(dh ** -0.5))])
    if bias is not None:
        scores = g.add("Add", [scores, bias])
    attn = g.add("Softmax", [scores], axis=-1)
    out = g.add("MatMul", [attn, v])  # (B, H, T, dh)
    out = g.add("Transpose", [out], perm=[0, 2, 1, 3])
    out = g.add("Reshape", [out, g.const(np.asarray([B, T, inner], np.int64))])
    return _linear_ntc(g, w, name + ".to_out.0", out)


def _tblock(g: GraphBuilder, w: Dict[str, np.ndarray], cfg: EstimatorConfig,
            name: str, x: str, bias: Optional[str], B: int, T: int, C: int) -> str:
    """BasicTransformerBlock on (B, T, C) (unet.py basic_transformer_block)."""
    inner = cfg.num_heads * cfg.attention_head_dim
    h = _layer_norm(g, w, name + ".norm1", x)
    x = g.add("Add", [x, _attention(g, w, name + ".attn1", h, bias, B, T,
                                    cfg.num_heads, inner)])
    h = _layer_norm(g, w, name + ".norm3", x)
    if cfg.act_fn not in ("gelu", "gelu-approximate"):
        raise NotImplementedError(
            f"ONNX export of act_fn {cfg.act_fn!r} (CosyVoice-300M is 'gelu')")
    ff = _linear_ntc(g, w, name + ".ff.net.0.proj", h)
    ff = _gelu(g, ff, cfg.gelu_approximate or cfg.act_fn == "gelu-approximate")
    ff = _linear_ntc(g, w, name + ".ff.net.2", ff)
    return g.add("Add", [x, ff])


# ---------------------------------------------------------------------------
# the estimator graph
# ---------------------------------------------------------------------------


def export_estimator_onnx(weights: Dict[str, np.ndarray], cfg: EstimatorConfig,
                          T: int, B: int = 2, mel_bins: Optional[int] = None) -> bytes:
    """Serialize the ConditionalDecoder as ONNX bytes.

    ``weights``: flat checkpoint-named param dict for the estimator subtree
    (e.g. ``flow_params`` filtered to the ``decoder.estimator.`` prefix with
    it stripped).  ``T`` must be a multiple of 2^(levels-1); inputs follow
    the reference export contract (x, mask, mu, t, spks, cond) in NCW.
    """
    n_levels = len(cfg.channels)
    if T % (2 ** (n_levels - 1)) != 0:
        raise ValueError(f"T={T} must be a multiple of {2 ** (n_levels - 1)}")
    w = {k: np.asarray(v, np.float32) for k, v in weights.items()}
    mel = mel_bins if mel_bins is not None else cfg.out_channels
    g = GraphBuilder()

    # timestep embedding (scale=1000, layers/posenc.py:101-114)
    half = cfg.in_channels // 2
    freqs = np.exp(np.arange(half, dtype=np.float32)
                   * -(math.log(10000.0) / (half - 1))) * 1000.0
    ang = g.add("Mul", [g.add("Unsqueeze", ["t", g.const(np.asarray([1], np.int64))]),
                        g.const(freqs[None, :], "t_freqs")])
    temb = g.add("Concat", [g.add("Sin", [ang]), g.add("Cos", [ang])], axis=1)
    temb = _gemm(g, w, "time_mlp.linear_1", temb)
    temb = _gemm(g, w, "time_mlp.linear_2", _silu(g, temb))

    # input pack (B, 4*mel, T): cat([x, mu, spks_bcast, cond]) on channels
    spks_b = g.add("Unsqueeze", ["spks", g.const(np.asarray([2], np.int64))])
    spks_b = g.add("Expand", [spks_b, g.const(np.asarray([B, mel, T], np.int64))])
    h = g.add("Concat", ["x", "mu", spks_b, "cond"], axis=1)

    # per-level masks (strided slice, like the [:, :, ::2] subsampling) and
    # additive padding biases (B, 1, 1, T_l) broadcast over heads and queries
    level_lens = [T]
    for _ in range(n_levels - 1):
        level_lens.append(-(-level_lens[-1] // 2))
    masks, biases = ["mask"], []
    for _ in range(n_levels - 1):
        masks.append(g.add(
            "Slice", [masks[-1], g.const(np.asarray([0], np.int64)),
                      g.const(np.asarray([1 << 40], np.int64)),
                      g.const(np.asarray([2], np.int64)),
                      g.const(np.asarray([2], np.int64))]))
    for m in masks:
        neg = g.add("Mul", [g.add("Sub", [g.const(np.float32(1.0)), m]),
                            g.const(np.float32(-1e10))])
        biases.append(g.add("Unsqueeze", [neg, g.const(np.asarray([1], np.int64))]))  # (B,1,1,T_l)

    def transformers(prefix, ht, lvl, C):
        Tl = level_lens[lvl]
        ht = g.add("Transpose", [ht], perm=[0, 2, 1])  # (B, T, C)
        for j in range(cfg.n_blocks):
            ht = _tblock(g, w, cfg, f"{prefix}.{j}", ht, biases[lvl], B, Tl, C)
        return g.add("Transpose", [ht], perm=[0, 2, 1])

    hiddens = []
    out_ch = cfg.in_channels
    for i in range(n_levels):
        lvl = min(i, n_levels - 1)
        in_ch, out_ch = out_ch, cfg.channels[i]
        h = _resnet(g, w, f"down_blocks.{i}.0", h, masks[lvl], temb,
                    B, out_ch, level_lens[lvl])
        h = transformers(f"down_blocks.{i}.1", h, lvl, out_ch)
        hiddens.append((h, masks[lvl], out_ch, level_lens[lvl]))
        hm = g.add("Mul", [h, masks[lvl]])
        if i < n_levels - 1:
            h = _conv(g, w, f"down_blocks.{i}.2.conv", hm, stride=2, pad=1)
        else:
            h = _conv(g, w, f"down_blocks.{i}.2", hm, pad=1)

    mid_lvl = n_levels - 1
    for i in range(cfg.num_mid_blocks):
        h = _resnet(g, w, f"mid_blocks.{i}.0", h, masks[mid_lvl], temb,
                    B, cfg.channels[-1], level_lens[mid_lvl])
        h = transformers(f"mid_blocks.{i}.1", h, mid_lvl, cfg.channels[-1])

    rev = tuple(reversed(cfg.channels)) + (cfg.channels[0],)
    for i in range(n_levels):
        lvl = n_levels - 1 - i
        skip, m, skip_ch, Tl = hiddens.pop()
        h = g.add("Concat", [h, skip], axis=1)
        h = _resnet(g, w, f"up_blocks.{i}.0", h, m, temb, B, rev[i + 1], Tl)
        h = transformers(f"up_blocks.{i}.1", h, lvl, rev[i + 1])
        hm = g.add("Mul", [h, m])
        if i < n_levels - 1:
            h = _conv_transpose(g, w, f"up_blocks.{i}.2.conv", hm, stride=2, pad=1)
        else:
            h = _conv(g, w, f"up_blocks.{i}.2", hm, pad=1)

    h = _block1d(g, w, "final_block", h, masks[0], B, rev[-1], T)
    out = _conv(g, w, "final_proj", g.add("Mul", [h, masks[0]]))
    out = g.add("Mul", [out, "mask"])

    g.add("Identity", [out], out_names=["estimator_out"])
    return g.finish(
        inputs=[("x", np.float32, (B, mel, T)),
                ("mask", np.float32, (B, 1, T)),
                ("mu", np.float32, (B, mel, T)),
                ("t", np.float32, (B,)),
                ("spks", np.float32, (B, mel)),
                ("cond", np.float32, (B, mel, T))],
        outputs=[("estimator_out", np.float32, (B, cfg.out_channels, T))])
