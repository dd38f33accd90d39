"""Positional encodings (the port of the JAX package's ``layers/posenc.py``):
the Transformer-XL relative table of the encoders, the scale-1000
sinusoidal timestep embedding of the CFM estimator."""

from __future__ import annotations

import math

import torch


def _sin_cos_interleaved(ang: torch.Tensor) -> torch.Tensor:
    """(T, d/2) angles -> (T, d) with sin at the even and cos at the odd
    columns."""
    pe = torch.zeros((ang.shape[0], 2 * ang.shape[1]), dtype=torch.float32, device=ang.device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def _angles(T: int, d_model: int, device) -> torch.Tensor:
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    return pos * div[None, :]


def rel_pos_table(T: int, d_model: int, device=None) -> torch.Tensor:
    """(1, 2T-1, d) relative-position table ordered [pos T-1 .. 0, -1 .. -(T-1)]
    (EspnetRelPositionalEncoding.extend_pe), f32."""
    ang = _angles(T, d_model, device)
    pe_pos = _sin_cos_interleaved(ang)
    pe_neg = _sin_cos_interleaved(-ang)
    return torch.cat([torch.flip(pe_pos, dims=(0,)), pe_neg[1:]], dim=0)[None]


def timestep_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """(B,) -> (B, dim) = cat([sin, cos]) over dim/2 frequencies.

    The scale of 1000 matches the pretrained Matcha/CosyVoice estimators; a
    wrong scale silently stalls training."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    ang = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
