"""Primitive layers over flat torch-named params.

The port of the JAX package's ``layers/basic.py``.  Each function reads
``name + ".weight"`` / ``".bias"`` through a ``P`` view and applies the op
with torch semantics.  LoRA adapters are consulted through the ``Ctx``: when
``ctx.lora`` holds ``<full name>.lora_A`` / ``.lora_B`` (Linear) or
``.lora_A.weight`` / ``.lora_B.weight`` (1x1 conv), the low-rank delta
``(drop(x) @ A^T) @ B^T * scale`` is added.  Voice-stacked adapters (a
leading voice axis: (V, r, in) / (V, out, r), conv kernels (V, r, in, 1) /
(V, out, r, 1)) route each batch row through its own voice's delta by
``ctx.lora_vids``, the (B,) voice index of every row (multi-voice
serving).  The ``_nwc`` variants take
channels-last (B, T, C) activations, the layout the JAX package keeps at
these functions' boundaries.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ctx import EVAL, Ctx
from ..parallel.tp import split_axis, split_dense
from ..params import P


def _lora_delta(ctx: Ctx, full_name: str, x: torch.Tensor, conv: bool):
    """The LoRA delta of a Linear, or of a 1x1 conv on a (B, C, T)
    activation (adapters stored as (r, in, 1) / (out, r, 1) conv kernels);
    None when the module has no adapter.  Voice-stacked adapters take row
    b's voice ``ctx.lora_vids[b]`` and raise without ``lora_vids``."""
    suffix = ".weight" if conv else ""
    a = ctx.lora.get(full_name + ".lora_A" + suffix)
    if a is None:
        return None
    b = ctx.lora[full_name + ".lora_B" + suffix]
    xd = ctx.dropout(x, ctx.lora_dropout)
    if a.ndim == (4 if conv else 3):
        if ctx.lora_vids is None:
            raise ValueError(f"stacked LoRA adapters for {full_name} need Ctx.lora_vids")
        vids = ctx.lora_vids.to(device=a.device, dtype=torch.long)
        a_sel = a[vids].to(x.dtype)  # (B, r, in[, 1])
        b_sel = b[vids].to(x.dtype)  # (B, out, r[, 1])
        if conv:  # x (B, C, T)
            h = torch.einsum("bct,brc->brt", xd, a_sel[..., 0])
            return torch.einsum("brt,bor->bot", h, b_sel[..., 0]) * ctx.lora_scale
        h = torch.einsum("b...i,bri->b...r", xd, a_sel)
        return torch.einsum("b...r,bor->b...o", h, b_sel) * ctx.lora_scale
    if conv:
        return F.conv1d(F.conv1d(xd, a.to(x.dtype)), b.to(x.dtype)) * ctx.lora_scale
    return F.linear(F.linear(xd, a.to(x.dtype)), b.to(x.dtype)) * ctx.lora_scale


def dense(p: P, name: str, x: torch.Tensor, ctx: Ctx = EVAL) -> torch.Tensor:
    """torch nn.Linear: weight (out, in), y = x @ W^T + b, plus the LoRA delta.
    A weight that ``p`` holds split over the model axis (``p.split``) runs
    the split product (``parallel.tp.split_dense``), which returns the
    whole output; the LoRA delta (whole adapters on the whole ``x``) adds
    after it.

    An int8 weight with a ``.weight@scale`` sibling (``quant.quantize_int8``)
    is weight-only quantized: the product runs on the weight cast to x's
    dtype and is scaled per output channel, then the bias and the LoRA
    delta are added."""
    b = p.get(name + ".bias")
    w = p[name + ".weight"]
    axis = split_axis(p, name + ".weight")
    if axis is not None:
        scale = p[name + ".weight@scale"].to(x.dtype) if w.dtype == torch.int8 else None
        y = split_dense(x, w.to(x.dtype), None if b is None else b.to(x.dtype), axis,
                        p.split.group, scale)
    elif w.dtype == torch.int8:
        y = F.linear(x, w.to(x.dtype)) * p[name + ".weight@scale"].to(x.dtype)
        if b is not None:
            y = y + b.to(x.dtype)
    else:
        y = F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))
    if ctx.lora is not None:
        delta = _lora_delta(ctx, p.full(name), x, conv=False)
        if delta is not None:
            y = y + delta
    return y


def embedding(p: P, name: str, ids: torch.Tensor,
              clamp_min: Optional[int] = None) -> torch.Tensor:
    if clamp_min is not None:
        ids = torch.clamp(ids, min=clamp_min)
    return p[name + ".weight"][ids]


def conv1d(p: P, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1, ctx: Ctx = EVAL) -> torch.Tensor:
    """torch nn.Conv1d on (B, C, T): weight (out, in/groups, k); a 1x1
    ungrouped conv takes a LoRA delta."""
    b = p.get(name + ".bias")
    w = p[name + ".weight"]
    y = F.conv1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 stride=stride, padding=padding, dilation=dilation, groups=groups)
    if ctx.lora is not None and w.shape[-1] == 1 and groups == 1:
        delta = _lora_delta(ctx, p.full(name), x, conv=True)
        if delta is not None:
            y = y + delta
    return y


def conv1d_nwc(p: P, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
               dilation: int = 1, groups: int = 1, ctx: Ctx = EVAL) -> torch.Tensor:
    """nn.Conv1d semantics on a channels-last (B, T, C) activation."""
    return conv1d(p, name, x.transpose(1, 2), stride, padding, dilation,
                  groups, ctx).transpose(1, 2)


def conv_transpose1d(p: P, name: str, x: torch.Tensor, stride: int,
                     padding: int = 0) -> torch.Tensor:
    """torch nn.ConvTranspose1d on (B, C, T): weight (in, out, k)."""
    b = p.get(name + ".bias")
    return F.conv_transpose1d(x, p[name + ".weight"].to(x.dtype),
                              None if b is None else b.to(x.dtype),
                              stride=stride, padding=padding)


def conv_transpose1d_nwc(p: P, name: str, x: torch.Tensor, stride: int,
                         padding: int = 0) -> torch.Tensor:
    return conv_transpose1d(p, name, x.transpose(1, 2), stride,
                            padding).transpose(1, 2)


def layer_norm(p: P, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with f32 statistics, cast back to x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], p[name + ".weight"].float(),
                     p[name + ".bias"].float(), eps)
    return y.to(x.dtype)


def group_norm(p: P, name: str, x: torch.Tensor, num_groups: int,
               eps: float = 1e-5, frames_valid=None) -> torch.Tensor:
    """torch nn.GroupNorm over (B, C, T) with f32 statistics.

    ``frames_valid`` ((B,) tensor or int): statistics over the first
    ``frames_valid`` frames only; x must already be zero beyond them, and
    callers re-mask the output."""
    if frames_valid is None:
        y = F.group_norm(x.float(), num_groups, p[name + ".weight"].float(),
                         p[name + ".bias"].float(), eps)
        return y.to(x.dtype)
    return group_norm_nwc(p, name, x.transpose(1, 2), num_groups, eps,
                          frames_valid).transpose(1, 2)


def group_norm_nwc(p: P, name: str, x: torch.Tensor, num_groups: int,
                   eps: float = 1e-5, frames_valid=None) -> torch.Tensor:
    """nn.GroupNorm semantics on channels-last (B, T, C): group g covers
    channels [g*C/G, (g+1)*C/G); statistics reduce over (T, group channels).

    ``frames_valid`` ((B,) tensor or int): statistics over the first
    ``frames_valid`` frames only; x must already be zero beyond them, and
    callers re-mask the output."""
    B, T, C = x.shape
    xf = x.float().reshape(B, T, num_groups, C // num_groups)
    if frames_valid is not None:
        n = (torch.as_tensor(frames_valid, device=x.device).reshape(-1, 1, 1, 1).float()
             * (C // num_groups))
        mean = xf.sum(dim=(1, 3), keepdim=True) / n
        var = torch.square(xf).sum(dim=(1, 3), keepdim=True) / n - torch.square(mean)
    else:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = torch.square(xf - mean).mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, T, C)
    y = y * p[name + ".weight"].float() + p[name + ".bias"].float()
    return y.to(x.dtype)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def weight_norm_weight(p: P, name: str, dtype) -> torch.Tensor:
    """A conv weight: ``name.weight``, or the weight-norm factorization
    w = g * v / ||v|| (norm over every dim but 0) computed on the fly from
    ``name.weight_g`` / ``name.weight_v``, the names torch's legacy
    ``weight_norm`` stores and the GAN discriminators train."""
    w = p.get(name + ".weight")
    if w is not None:
        return w.to(dtype)
    g, v = p[name + ".weight_g"], p[name + ".weight_v"]
    norm = torch.sqrt(torch.sum(torch.square(v.float()), dim=tuple(range(1, v.ndim)),
                                keepdim=True))
    return (g * v / torch.clamp(norm, min=1e-12)).to(dtype)


def conv2d(p: P, name: str, x: torch.Tensor, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """torch nn.Conv2d on (B, C, H, W): weight (out, in, kh, kw), plain or
    weight-normed (:func:`weight_norm_weight`)."""
    b = p.get(name + ".bias")
    return F.conv2d(x, weight_norm_weight(p, name, x.dtype), None if b is None else b.to(x.dtype),
                    stride=tuple(stride), padding=tuple(padding))


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def glu(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Gated linear unit: the first half of ``dim`` times the sigmoid of the
    second."""
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + 1/a * sin^2(a x); ``alpha`` (C,) over (B, C, T)."""
    a = alpha[None, :, None]
    return x + (1.0 / (a + 1e-9)) * torch.square(torch.sin(x * a))


ACT = {
    "relu": F.relu,
    "swish": silu,
    "silu": silu,
    "gelu": gelu,
    "mish": mish,
    "tanh": torch.tanh,
}
