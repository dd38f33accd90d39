"""Mask builders: boolean masks and additive biases.

The port of the JAX package's ``ops/masks.py``.  Masks become additive
biases of 0 / -1e10, never -inf: a -inf row that is also padding-masked
turns softmax into NaN, where -1e10 gives a finite uniform row.
"""

from __future__ import annotations

from typing import Optional

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
    generator: Optional[torch.Generator] = None,
    enable_full_context: bool = True,
) -> torch.Tensor:
    """(B, T, T) bool attention mask: padding plus chunk structure, with
    fully masked rows opened up (they would otherwise be all-bias).

    Dynamic chunks in training (``use_dynamic_chunk`` with
    ``decoding_chunk_size == 0``) draw from ``generator``, once a call for
    the whole batch, the reference's distribution (mask.py:161-238): chunk
    ~ U[1, max(T, 2)); a draw above T // 2 with ``enable_full_context``
    means full context, else ``draw % 25 + 1``; with
    ``use_dynamic_left_chunk`` a small chunk also draws its left-context
    limit num_left ~ U[0, max((T - 1) // chunk, 1)), and full context keeps
    all history.  The draws stay on the device (no host sync).  Data-parallel
    ranks seeded alike draw the same chunk: the draw is one scalar, taken
    after the same whole-batch draws on every rank."""
    dev = masks.device
    if use_dynamic_chunk:
        if decoding_chunk_size < 0:
            chunk_masks = subsequent_chunk_mask(T, T, -1, dev)
        elif decoding_chunk_size > 0:
            chunk_masks = subsequent_chunk_mask(T, decoding_chunk_size,
                                                num_decoding_left_chunks, dev)
        else:
            chunk_masks = _dynamic_chunk_mask(T, use_dynamic_left_chunk, generator,
                                              enable_full_context).to(dev)
        chunk_masks = masks & chunk_masks[None]
    elif static_chunk_size > 0:
        chunk_masks = subsequent_chunk_mask(T, static_chunk_size,
                                            num_decoding_left_chunks, dev)
        chunk_masks = masks & chunk_masks[None]
    else:
        chunk_masks = masks.expand(masks.shape[0], T, T)
    dead = chunk_masks.sum(dim=-1, keepdim=True) == 0
    return chunk_masks | dead


def _dynamic_chunk_mask(T: int, use_left: bool, generator: Optional[torch.Generator],
                        enable_full_context: bool) -> torch.Tensor:
    """(T, T) bool mask of one random chunk size (and left limit), drawn
    on ``generator``'s device."""
    if generator is None:
        raise ValueError("dynamic-chunk training masks draw from a generator and none was given")
    dev = generator.device
    draw = torch.randint(1, max(T, 2), (), generator=generator, device=dev)
    full = (draw > T // 2) & enable_full_context
    chunk = torch.where(full, torch.full_like(draw, T), draw % 25 + 1)
    pos = torch.arange(T, device=dev)
    allowed = pos[None, :] < ((pos // chunk + 1) * chunk)[:, None]
    if use_left:
        max_left = torch.clamp((T - 1) // chunk, min=1)
        nleft = torch.randint(0, 1 << 30, (), generator=generator, device=dev) % max_left
        start = torch.clamp((pos // chunk - nleft) * chunk, min=0)
        limited = allowed & (pos[None, :] >= start[:, None])
        allowed = torch.where(full, allowed, limited)
    return allowed


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
