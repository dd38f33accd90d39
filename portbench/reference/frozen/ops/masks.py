"""Mask builders: boolean masks and additive biases.

The port of the JAX package's ``ops/masks.py``.  Masks become additive
biases of 0 / -1e10, never -inf: a -inf row that is also padding-masked
turns softmax into NaN, where -1e10 gives a finite uniform row.
"""

from __future__ import annotations

import torch

NEG_BIAS = -1.0e10


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at padded positions.  (B,) int -> (B, T) bool."""
    idx = torch.arange(max_len, device=lengths.device)[None, :]
    return idx >= lengths[:, None]


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    return ~make_pad_mask(lengths, max_len)


def band_bias(T: int, window: int, dtype, device) -> torch.Tensor:
    """(T, T) additive bias: 0 where |i - j| <= window, NEG_BIAS outside."""
    i = torch.arange(T, device=device)
    ok = (i[:, None] - i[None, :]).abs() <= window
    return torch.where(ok, 0.0, NEG_BIAS).to(dtype)


def subsequent_chunk_mask(size: int, chunk_size: int, num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """(size, size) bool, True where position i may attend j: j < (i // chunk
    + 1) * chunk, optionally limited to ``num_left_chunks`` history chunks.
    chunk_size == 1 is causal."""
    pos = torch.arange(size, device=device)
    block = (pos // chunk_size + 1) * chunk_size
    allowed = pos[None, :] < block[:, None]
    if num_left_chunks >= 0:
        start = torch.clamp((pos // chunk_size - num_left_chunks) * chunk_size, min=0)
        allowed = allowed & (pos[None, :] >= start[:, None])
    return allowed


def add_optional_chunk_mask(
    T: int,
    masks: torch.Tensor,  # (B, 1, T) bool, True = valid
    use_dynamic_chunk: bool,
    use_dynamic_left_chunk: bool,
    decoding_chunk_size: int,
    static_chunk_size: int,
    num_decoding_left_chunks: int,
) -> torch.Tensor:
    """(B, T, T) bool attention mask: padding plus chunk structure, with
    fully masked rows opened up (they would otherwise be all-bias).  A
    dynamic chunk (``use_dynamic_chunk`` with ``decoding_chunk_size == 0``)
    is drawn in training only, which the reference does not run."""
    dev = masks.device
    if use_dynamic_chunk:
        if decoding_chunk_size < 0:
            chunk_masks = subsequent_chunk_mask(T, T, -1, dev)
        elif decoding_chunk_size > 0:
            chunk_masks = subsequent_chunk_mask(T, decoding_chunk_size,
                                                num_decoding_left_chunks, dev)
        else:
            raise NotImplementedError("dynamic-chunk masks are drawn in training only")
        chunk_masks = masks & chunk_masks[None]
    elif static_chunk_size > 0:
        chunk_masks = subsequent_chunk_mask(T, static_chunk_size,
                                            num_decoding_left_chunks, dev)
        chunk_masks = masks & chunk_masks[None]
    else:
        chunk_masks = masks.expand(masks.shape[0], T, T)
    dead = chunk_masks.sum(dim=-1, keepdim=True) == 0
    return chunk_masks | dead


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bool mask (True = attend) -> additive bias (0 / -1e10)."""
    return (1.0 - mask.to(dtype)) * NEG_BIAS




def prompt_isolation_bias(seq_len: int, prompt_lens: torch.Tensor,
                          dtype=torch.float32) -> torch.Tensor:
    """(B, seq_len, seq_len) additive bias blocking prompt <-> target
    attention, one prompt length per sample; a length of 0, or one that
    covers the sequence, disables it for that sample."""
    idx = torch.arange(seq_len, device=prompt_lens.device)
    in_prompt = idx[None, :] < prompt_lens[:, None]
    cross = in_prompt[:, :, None] != in_prompt[:, None, :]
    live = ((prompt_lens > 0) & (prompt_lens < seq_len))[:, None, None]
    return torch.where(cross & live, NEG_BIAS, 0.0).to(dtype)
