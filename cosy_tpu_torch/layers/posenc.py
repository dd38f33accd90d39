"""Positional encodings (the port of the JAX package's ``layers/posenc.py``):
the Transformer-XL relative table of the encoders, the scale-1000
sinusoidal timestep embedding of the CFM estimator, and the registry's
other encoders (absolute, whisper, learnable, none), each returning
``(y, pos)`` as the reference's modules do."""

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


def sinusoid_table(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """(max_len, d_model) with pe[p, 2i] = sin(p w_i), pe[p, 2i+1] = cos(p w_i)."""
    return _sin_cos_interleaved(_angles(max_len, d_model, device))


def rel_pos_table(T: int, d_model: int, device=None) -> torch.Tensor:
    """(1, 2T-1, d) relative-position table ordered [pos T-1 .. 0, -1 .. -(T-1)]
    (EspnetRelPositionalEncoding.extend_pe), f32."""
    ang = _angles(T, d_model, device)
    pe_pos = _sin_cos_interleaved(ang)
    pe_neg = _sin_cos_interleaved(-ang)
    return torch.cat([torch.flip(pe_pos, dims=(0,)), pe_neg[1:]], dim=0)[None]


def abs_pos_encoding(x: torch.Tensor, offset: int = 0, apply_xscale: bool = True):
    """PositionalEncoding (embedding.py:26-118): x * sqrt(d) + pe[offset:
    offset + T].  Returns (y, pos (1, T, d))."""
    T, d = x.shape[1], x.shape[-1]
    pe = sinusoid_table(offset + T, d, x.device)[None, offset:offset + T].to(x.dtype)
    if apply_xscale:
        x = x * torch.tensor(d, dtype=x.dtype) ** 0.5
    return x + pe, pe


def whisper_pos_table(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """WhisperPositionalEncoding (embedding.py:150-165): cat([sin, cos])
    over d/2 frequencies (not interleaved)."""
    inc = math.log(10000.0) / (d_model // 2 - 1)
    inv = torch.exp(-inc * torch.arange(d_model // 2, dtype=torch.float32, device=device))
    ang = torch.arange(max_len, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def whisper_pos_encoding(x: torch.Tensor, offset: int = 0):
    """x + the whisper table's rows [offset, offset + T); no x scale."""
    T, d = x.shape[1], x.shape[-1]
    pe = whisper_pos_table(offset + T, d, x.device)[None, offset:offset + T].to(x.dtype)
    return x + pe, pe


def learnable_pos_encoding(pe_param: torch.Tensor, x: torch.Tensor, offset: int = 0):
    """LearnablePositionalEncoding (embedding.py:168-176): x + the learned
    (1, max_len, d) table's rows [offset, offset + T); no x scale."""
    pe = pe_param[:, offset:offset + x.shape[1]].to(x.dtype)
    return x + pe, pe


def no_pos_encoding(x: torch.Tensor, offset: int = 0):
    """NoPositionalEncoding (embedding.py:179-199): x and a zero table."""
    return x, torch.zeros((1, x.shape[1], x.shape[-1]), dtype=x.dtype, device=x.device)


def timestep_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """(B,) -> (B, dim) = cat([sin, cos]) over dim/2 frequencies.

    The scale of 1000 matches the pretrained Matcha/CosyVoice estimators; a
    wrong scale silently stalls training."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    ang = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
