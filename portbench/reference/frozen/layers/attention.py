"""Attention layers (the port of the JAX package's ``layers/attention.py``).

- ``rel_pos_mha``: wenet/ESPnet relative-position multi-head attention with
  pos_bias_u/v and the Transformer-XL rel-shift;
- ``diffusers_attention``: the estimator's to_q/to_k/to_v/to_out.0 attention,
  as the einsum-softmax on every device.

Masks arrive as additive biases (0 / -1e10); softmax runs in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ctx import EVAL, Ctx
from ..ops import masks as M
from ..params import P
from .basic import dense


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, h, D // h).transpose(1, 2)  # (B, h, T, d)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, h, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, h * d)


def _softmax(scores: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    s = scores.float()
    if bias is not None:
        s = s + bias.float()
    return torch.softmax(s, dim=-1)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T1, 2*T2-1) -> (B, H, T1, T2) Transformer-XL relative shift
    (the reference's row-major view trick)."""
    B, H, T1, Pn = x.shape
    x = torch.nn.functional.pad(x, (1, 0))
    x = x.reshape(B, H, Pn + 1, T1)[:, :, 1:, :]
    x = x.reshape(B, H, T1, Pn)
    return x[..., : Pn // 2 + 1]


def rel_pos_mha(
    p: P,
    name: str,
    x: torch.Tensor,  # (B, T, D), post layer-norm
    pos_emb: torch.Tensor,  # (1, 2T-1, D)
    bias: Optional[torch.Tensor],  # (B, T, T) or (B, 1, T, T) additive
    n_head: int,
    ctx: Ctx = EVAL,
    dropout_rate: float = 0.0,
    return_kv: bool = False,
):
    """Relative-position multi-head self-attention.  ``return_kv`` also
    returns this layer's split-head (K, V), so a decode prefill can seed its
    cache without recomputing them."""
    sp = p.sub(name)
    d_k = x.shape[-1] // n_head
    q = _split_heads(dense(sp, "linear_q", x, ctx), n_head)
    k = _split_heads(dense(sp, "linear_k", x, ctx), n_head)
    v = _split_heads(dense(sp, "linear_v", x, ctx), n_head)
    pk = _split_heads(dense(sp, "linear_pos", pos_emb, ctx), n_head)[0]  # (h, P, d)

    q_u = q + p[name + ".pos_bias_u"].to(x.dtype)[None, :, None, :]
    q_v = q + p[name + ".pos_bias_v"].to(x.dtype)[None, :, None, :]
    matrix_ac = torch.einsum("bhtd,bhsd->bhts", q_u, k)
    matrix_bd = torch.einsum("bhtd,hpd->bhtp", q_v, pk)
    if matrix_bd.shape[-1] != matrix_ac.shape[-1]:
        matrix_bd = rel_shift(matrix_bd)

    scores = (matrix_ac + matrix_bd) / math.sqrt(d_k)
    if bias is not None and bias.ndim == 3:
        bias = bias[:, None]
    attn = ctx.dropout(_softmax(scores, bias).to(x.dtype), dropout_rate)
    out = dense(sp, "linear_out", _merge_heads(torch.einsum("bhts,bhsd->bhtd", attn, v)),
                ctx)
    if return_kv:
        return out, (k, v)
    return out


def diffusers_attention(
    p: P,
    name: str,
    x: torch.Tensor,  # (B, T, D)
    bias: Optional[torch.Tensor],  # (B, T, T) additive, shared across heads
    heads: int,
    ctx: Ctx = EVAL,
    window: Optional[int] = None,  # local-band attention |t - s| <= window
) -> torch.Tensor:
    """diffusers attention with 1/sqrt(dim_head) scale; a ``window`` adds
    the band bias."""
    sp = p.sub(name)
    q = _split_heads(dense(sp, "to_q", x, ctx), heads)
    k = _split_heads(dense(sp, "to_k", x, ctx), heads)
    v = _split_heads(dense(sp, "to_v", x, ctx), heads)
    scale = q.shape[-1] ** -0.5
    T = x.shape[1]
    if window is not None:
        band = M.band_bias(T, window, x.dtype, x.device)[None]
        bias = band.expand(x.shape[0], T, T).contiguous() if bias is None else bias + band
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * scale
    attn = _softmax(scores, None if bias is None else bias[:, None]).to(x.dtype)
    out = torch.einsum("bhts,bhsd->bhtd", attn, v)
    return dense(sp, "to_out.0", _merge_heads(out), ctx)
