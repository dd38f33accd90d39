"""Convolutional subsampling front-ends (the port of the JAX package's
``layers/subsampling.py``).

Reference: cosyvoice/transformer/subsampling.py, the COSYVOICE_SUBSAMPLE
registry.  The TTS paths use the linear input layers
(``layers/conformer.embed_input``); these conv variants serve ASR-style
configs.  Weights keep the torch modules' names (``conv.0`` / ``conv.2`` /
``conv.4`` and ``out.0`` / ``linear``) and layouts (Conv1d (out, in, k),
Conv2d (out, in, kh, kw)), so real checkpoints load.

Every function takes (B, T, idim) and a (B, 1, T) bool mask and returns
(x', mask'), the mask strided as the reference's is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ctx import EVAL, Ctx
from ..params import P, Spec, _uniform
from .basic import conv1d, conv2d, dense


def conv1d_subsampling2(p: P, x: torch.Tensor, mask: torch.Tensor, ctx: Ctx = EVAL):
    """Conv1dSubsampling2 (subsampling.py:116-171): k3p1 -> GELU -> k3s2p1 ->
    GELU; rate 2, right context 4."""
    T = x.shape[1]
    h = F.gelu(conv1d(p, "conv.0", x.transpose(1, 2), padding=1))
    h = F.gelu(conv1d(p, "conv.2", h, stride=2, padding=1))
    return h.transpose(1, 2), mask[:, :, (T + 1) % 2::2]


def _conv2d_stack(p: P, x: torch.Tensor, strides, out: str, ctx: Ctx) -> torch.Tensor:
    """ReLU(Conv2d) over (B, 1, T, F) at each stride, then the (B, T', C F')
    flattening and the output Linear ``out``."""
    h = x[:, None]
    for i, s in enumerate(strides):
        h = F.relu(conv2d(p, f"conv.{2 * i}", h, stride=(s, s)))
    b, c, t, f = h.shape
    return dense(p, out, h.transpose(1, 2).reshape(b, t, c * f), ctx)


def conv2d_subsampling4(p: P, x: torch.Tensor, mask: torch.Tensor, ctx: Ctx = EVAL):
    """Conv2dSubsampling4 (subsampling.py:173-228): two k3s2 Conv2d + ReLU,
    a Linear over the flattened channels; rate 4, right context 6."""
    return _conv2d_stack(p, x, (2, 2), "out.0", ctx), mask[:, :, 2::2][:, :, 2::2]


def conv2d_subsampling6(p: P, x: torch.Tensor, mask: torch.Tensor, ctx: Ctx = EVAL):
    """Conv2dSubsampling6 (subsampling.py:230-280): k3s2 then k5s3; rate 6,
    right context 10."""
    return _conv2d_stack(p, x, (2, 3), "linear", ctx), mask[:, :, 2::2][:, :, 4::3]


def conv2d_subsampling8(p: P, x: torch.Tensor, mask: torch.Tensor, ctx: Ctx = EVAL):
    """Conv2dSubsampling8 (subsampling.py:282-336): three k3s2; rate 8,
    right context 14."""
    return (_conv2d_stack(p, x, (2, 2, 2), "linear", ctx),
            mask[:, :, 2::2][:, :, 2::2][:, :, 2::2])


# kind -> (function, rate, right context)
SUBSAMPLE_RATES = {
    "conv1d2": (conv1d_subsampling2, 2, 4),
    "conv2d": (conv2d_subsampling4, 4, 6),
    "conv2d6": (conv2d_subsampling6, 6, 10),
    "conv2d8": (conv2d_subsampling8, 8, 14),
}


def init_conv_subsampling(spec: Spec, prefix: str, kind: str, idim: int, odim: int) -> Spec:
    """The torch parameter names and shapes of subsampling ``kind``, each
    weight and bias uniform in +-1/sqrt(fan_in) (torch's default)."""
    pre = prefix + "." if prefix else ""

    def add(name, shape, fan_in):
        init = _uniform(1.0 / math.sqrt(fan_in))
        spec.add(pre + name + ".weight", shape, init)
        spec.add(pre + name + ".bias", (shape[0],), init)

    if kind == "conv1d2":
        add("conv.0", (odim, idim, 3), idim * 3)
        add("conv.2", (odim, odim, 3), odim * 3)
    elif kind == "conv2d":
        add("conv.0", (odim, 1, 3, 3), 9)
        add("conv.2", (odim, odim, 3, 3), odim * 9)
        f = ((idim - 1) // 2 - 1) // 2
        add("out.0", (odim, odim * f), odim * f)
    elif kind == "conv2d6":
        add("conv.0", (odim, 1, 3, 3), 9)
        add("conv.2", (odim, odim, 5, 5), odim * 25)
        f = ((idim - 1) // 2 - 2) // 3
        add("linear", (odim, odim * f), odim * f)
    elif kind == "conv2d8":
        add("conv.0", (odim, 1, 3, 3), 9)
        add("conv.2", (odim, odim, 3, 3), odim * 9)
        add("conv.4", (odim, odim, 3, 3), odim * 9)
        f = (((idim - 1) // 2 - 1) // 2 - 1) // 2
        add("linear", (odim, odim * f), odim * f)
    else:
        raise ValueError(kind)
    return spec
