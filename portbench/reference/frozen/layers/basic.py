"""Primitive layers over flat torch-named params.

The port of the JAX package's ``layers/basic.py``.  Each function reads
``name + ".weight"`` / ``".bias"`` through a ``P`` view and applies the op
with torch semantics.  The ``_nwc`` variants take
channels-last (B, T, C) activations, the layout the JAX package keeps at
these functions' boundaries.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ctx import EVAL, Ctx
from ..params import P


def dense(p: P, name: str, x: torch.Tensor, ctx: Ctx = EVAL) -> torch.Tensor:
    """torch nn.Linear: weight (out, in), y = x @ W^T + b, plus the LoRA
    delta ``(drop(x) @ A^T) @ B^T * scale`` where ``ctx.lora`` holds
    ``<full name>.lora_A`` / ``.lora_B``."""
    b = p.get(name + ".bias")
    w = p[name + ".weight"]
    y = F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))
    if ctx.lora is not None:
        a = ctx.lora.get(p.full(name) + ".lora_A")
        if a is not None:
            bb = ctx.lora[p.full(name) + ".lora_B"]
            xd = ctx.dropout(x, ctx.lora_dropout)
            y = y + F.linear(F.linear(xd, a.to(x.dtype)), bb.to(x.dtype)) * ctx.lora_scale
    return y


def embedding(p: P, name: str, ids: torch.Tensor,
              clamp_min: Optional[int] = None) -> torch.Tensor:
    if clamp_min is not None:
        ids = torch.clamp(ids, min=clamp_min)
    return p[name + ".weight"][ids]


def conv1d(p: P, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1, ctx: Ctx = EVAL) -> torch.Tensor:
    """torch nn.Conv1d on (B, C, T): weight (out, in/groups, k)."""
    b = p.get(name + ".bias")
    w = p[name + ".weight"]
    return F.conv1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation, groups=groups)


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


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


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
