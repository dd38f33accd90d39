"""U-Net ConditionalDecoder, the CFM velocity estimator (the port of the JAX
package's ``layers/unet.py``): the non-causal estimator of CosyVoice-300M
and the causal one of CosyVoice2 (``causal``), with its static-chunk
attention in streaming (``streaming``).

    down_blocks.i = [ResnetBlock1D, [BasicTransformerBlock]*n, Down/Conv]
    mid_blocks.i  = [ResnetBlock1D, [BasicTransformerBlock]*n]
    up_blocks.i   = [ResnetBlock1D, [BasicTransformerBlock]*n, Up/Conv]
    final_block (Block1D), final_proj (1x1 conv), time_mlp

Internals are channels-last (B, T, C), as in the JAX package, so the
transformer blocks read their rows contiguously.  Every transformer block
runs the unfused layer sequence with the einsum-softmax attention, on every
device.  The causal estimator's streaming bias is expanded to a contiguous
(B, T, T) once a level.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import EstimatorConfig
from ..ctx import EVAL, Ctx
from ..ops import masks as M
from ..params import P, Spec
from .attention import diffusers_attention
from .basic import (conv1d_nwc, conv_transpose1d_nwc, dense, gelu, group_norm_nwc,
                    layer_norm, mish, silu)
from .posenc import timestep_embedding


def _mul_mask(x: torch.Tensor, mask) -> torch.Tensor:
    """x * mask, or x unchanged when mask is None (all frames valid)."""
    return x if mask is None else x * mask


def block1d(p: P, name: str, x: torch.Tensor, mask, ctx: Ctx = EVAL,
            frames_valid=None, causal: bool = False) -> torch.Tensor:
    """Conv3 + GroupNorm(8) + Mish, masked before and after; x (B, T, C),
    mask (B, T, 1) or None.  Causal (CosyVoice2): left-padded conv +
    LayerNorm over channels (state-dict index block.2) + Mish."""
    sp = p.sub(name)
    if causal:
        h = conv1d_nwc(sp, "block.0", F.pad(_mul_mask(x, mask), (0, 0, 2, 0)), ctx=ctx)
        return _mul_mask(mish(layer_norm(sp, "block.2", h)), mask)
    h = conv1d_nwc(sp, "block.0", _mul_mask(x, mask), padding=1, ctx=ctx)
    if frames_valid is not None:
        h = group_norm_nwc(sp, "block.1", _mul_mask(h, mask), num_groups=8,
                           frames_valid=frames_valid)
    else:
        h = group_norm_nwc(sp, "block.1", h, num_groups=8)
    return _mul_mask(mish(h), mask)


def resnet_block1d(p: P, name: str, x: torch.Tensor, mask, t: torch.Tensor,
                   ctx: Ctx = EVAL, frames_valid=None, causal: bool = False) -> torch.Tensor:
    """ResNet block with timestep conditioning; x (B, T, C), t (B, time_embed_dim)."""
    sp = p.sub(name)
    h = block1d(sp, "block1", x, mask, ctx, frames_valid, causal)
    h = h + dense(sp, "mlp.1", mish(t), ctx)[:, None, :]
    h = block1d(sp, "block2", h, mask, ctx, frames_valid, causal)
    return h + conv1d_nwc(sp, "res_conv", _mul_mask(x, mask), ctx=ctx)


def causal_conv1d(p: P, name: str, x: torch.Tensor, kernel: int, ctx: Ctx = EVAL) -> torch.Tensor:
    """Left-padded conv on (B, T, C) (decoder.py:36-62)."""
    return conv1d_nwc(p, name, F.pad(x, (0, 0, kernel - 1, 0)), ctx=ctx)


def feed_forward(p: P, name: str, x: torch.Tensor, act_fn: str, ctx: Ctx = EVAL,
                 gelu_approximate: bool = True, dropout: float = 0.0) -> torch.Tensor:
    """diffusers FeedForward: net.0 = activation with projection, dropout,
    net.2 = Linear."""
    sp = p.sub(name)
    h = dense(sp, "net.0.proj", x, ctx)
    if act_fn in ("gelu", "gelu-approximate"):
        h = gelu(h, approximate=gelu_approximate or act_fn == "gelu-approximate")
    elif act_fn == "geglu":
        h, gate = h.chunk(2, dim=-1)
        h = h * gelu(gate)
    else:
        raise ValueError(f"unported act_fn {act_fn}")
    return dense(sp, "net.2", ctx.dropout(h, dropout), ctx)


def basic_transformer_block(
    p: P,
    name: str,
    x: torch.Tensor,  # (B, T, C)
    attn_bias: Optional[torch.Tensor],
    heads: int,
    act_fn: str,
    ctx: Ctx = EVAL,
    gelu_approximate: bool = True,
    dropout: float = 0.0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """attn1 + ff with norm1/norm3."""
    sp = p.sub(name)
    h = layer_norm(sp, "norm1", x)
    x = x + diffusers_attention(sp, "attn1", h, attn_bias, heads, ctx, window=window)
    h = layer_norm(sp, "norm3", x)
    return x + feed_forward(sp, "ff", h, act_fn, ctx, gelu_approximate, dropout)


def _level_bias(mask: torch.Tensor, T_full: int, prompt_lens, dtype) -> torch.Tensor:
    """(B, T_l, T_l) additive attention bias: padding plus prompt isolation,
    the prompt length rescaled to the level (max(1, p * T_l // T_full))."""
    B, T_l, _ = mask.shape
    valid = mask.bool()[:, :, 0]
    bias = M.mask_to_bias(valid[:, None, :], dtype).expand(B, T_l, T_l)
    if prompt_lens is not None:
        pl = torch.as_tensor(prompt_lens, device=mask.device).reshape(-1).long()
        scaled = torch.where(pl > 0, torch.clamp((pl * T_l) // T_full, min=1), 0)
        bias = bias + M.prompt_isolation_bias(T_l, scaled, dtype)
    return bias.contiguous()


def _stream_bias(mask, B: int, T_l: int, chunk: int, dtype, device) -> torch.Tensor:
    """(B, T_l, T_l) static-chunk attention bias of the streaming causal
    estimator (decoder.py:439-443): row i sees the keys of its chunk and
    every chunk before it, and, with a mask, only valid keys; a row left
    with no key (a pad row past every valid key of its chunk) sees all of
    them instead."""
    allowed = M.subsequent_chunk_mask(T_l, chunk, -1, device)[None]
    if mask is not None:
        allowed = mask.bool()[:, :, 0][:, None, :] & allowed
        allowed = allowed | (allowed.sum(dim=-1, keepdim=True) == 0)
    return M.mask_to_bias(allowed, dtype).expand(B, T_l, T_l).contiguous()


def conditional_decoder(
    p: P,
    cfg: EstimatorConfig,
    x: torch.Tensor,  # (B, 80, T) noisy sample
    mask,  # (B, 1, T) float valid mask, or None == all frames valid
    mu: torch.Tensor,  # (B, 80, T)
    t: torch.Tensor,  # (B,) timestep in [0, 1]
    spks: torch.Tensor,  # (B, 80)
    cond: torch.Tensor,  # (B, 80, T)
    ctx: Ctx = EVAL,
    prompt_lens=None,  # (B,) ints, 0 = no isolation
    frames_valid=None,  # (B,) true frame counts (masked GroupNorm statistics)
    causal: bool = False,
    streaming: bool = False,
    static_chunk_size: int = 50,
) -> torch.Tensor:
    """Velocity field estimate (B, 80, T).  ``mask=None`` is the dense path
    (no masking multiplies, no padding bias); it equals an all-ones mask.
    ``causal``: CosyVoice2's estimator (left-padded convs, LayerNorm in
    its blocks); ``streaming`` adds the static-chunk attention bias of
    ``static_chunk_size`` frames at every level."""
    B, _, T = x.shape
    if T % 2:
        raise ValueError("estimator time axis must be a multiple of 2")
    dtype = x.dtype

    temb = timestep_embedding(t, cfg.in_channels).to(dtype)
    sp_t = p.sub("time_mlp")
    temb = dense(sp_t, "linear_2", silu(dense(sp_t, "linear_1", temb, ctx)), ctx)

    spks_t = spks[:, None, :].expand(B, T, spks.shape[1]).to(dtype)
    h = torch.cat([x.transpose(1, 2), mu.transpose(1, 2), spks_t,
                   cond.transpose(1, 2)], dim=-1)  # (B, T, 320)
    if mask is not None:
        mask = mask.transpose(1, 2)  # (B, T, 1)

    n_levels = len(cfg.channels)
    if mask is None and prompt_lens is not None and not streaming:
        mask = torch.ones((B, T, 1), dtype=dtype, device=x.device)
    if mask is None:
        level_masks = [None] * n_levels
    else:
        level_masks = [mask]
        for _ in range(n_levels - 1):
            level_masks.append(level_masks[-1][:, ::2, :])
    level_lens = [T]
    for _ in range(n_levels - 1):
        level_lens.append(-(-level_lens[-1] // 2))
    if streaming:
        level_bias = [_stream_bias(m, B, T_l, static_chunk_size, dtype, x.device)
                      for m, T_l in zip(level_masks, level_lens)]
    elif mask is None:
        level_bias = [None] * n_levels
    else:
        level_bias = [_level_bias(m, T, prompt_lens, dtype) for m in level_masks]
    if frames_valid is None:
        level_valid = [None] * n_levels
    else:
        level_valid = [torch.as_tensor(frames_valid, device=x.device).reshape(-1)]
        for _ in range(n_levels - 1):
            level_valid.append((level_valid[-1] + 1) // 2)
    # the window is for inference on levels without a bias; it halves with
    # each level, and one that covers its level is exactly full attention
    if cfg.attn_window and cfg.attn_window > 0 and not ctx.train:
        level_window = [
            w if (level_bias[lv] is None and w < level_lens[lv]) else None
            for lv, w in enumerate(max(1, (cfg.attn_window * T_l) // T)
                                   for T_l in level_lens)]
    else:
        level_window = [None] * n_levels

    def run_transformers(prefix, ht, lvl):
        for j in range(cfg.n_blocks):
            ht = basic_transformer_block(
                p, f"{prefix}.{j}", ht, level_bias[lvl], cfg.num_heads, cfg.act_fn,
                ctx, cfg.gelu_approximate, cfg.dropout, window=level_window[lvl])
        return ht

    hiddens = []
    for i in range(n_levels):
        m = level_masks[i]
        h = resnet_block1d(p, f"down_blocks.{i}.0", h, m, temb, ctx, level_valid[i], causal)
        h = run_transformers(f"down_blocks.{i}.1", h, i)
        hiddens.append(h)
        if i < n_levels - 1:
            h = conv1d_nwc(p, f"down_blocks.{i}.2.conv", _mul_mask(h, m), stride=2,
                           padding=1, ctx=ctx)
        elif causal:
            h = causal_conv1d(p, f"down_blocks.{i}.2", _mul_mask(h, m), 3, ctx)
        else:
            h = conv1d_nwc(p, f"down_blocks.{i}.2", _mul_mask(h, m), padding=1, ctx=ctx)

    mid = n_levels - 1
    m = level_masks[mid]
    for i in range(cfg.num_mid_blocks):
        h = resnet_block1d(p, f"mid_blocks.{i}.0", h, m, temb, ctx, level_valid[mid], causal)
        h = run_transformers(f"mid_blocks.{i}.1", h, mid)

    for i in range(n_levels):
        lvl = n_levels - 1 - i
        m = level_masks[lvl]
        skip = hiddens.pop()
        h = torch.cat([h[:, : skip.shape[1], :], skip], dim=-1)
        h = resnet_block1d(p, f"up_blocks.{i}.0", h, m, temb, ctx, level_valid[lvl], causal)
        h = run_transformers(f"up_blocks.{i}.1", h, lvl)
        if i < n_levels - 1:
            h = conv_transpose1d_nwc(p, f"up_blocks.{i}.2.conv", _mul_mask(h, m),
                                     stride=2, padding=1)
        elif causal:
            h = causal_conv1d(p, f"up_blocks.{i}.2", _mul_mask(h, m), 3, ctx)
        else:
            h = conv1d_nwc(p, f"up_blocks.{i}.2", _mul_mask(h, m), padding=1, ctx=ctx)

    m = level_masks[0]
    h = block1d(p, "final_block", h, m, ctx, level_valid[0], causal)
    out = conv1d_nwc(p, "final_proj", _mul_mask(h, m), ctx=ctx)
    return _mul_mask(out, mask).transpose(1, 2)  # (B, 80, T)


def init_conditional_decoder(spec: Spec, prefix: str, cfg: EstimatorConfig,
                             causal: bool = False):
    """Names and shapes of the JAX package's ``init_conditional_decoder``;
    causal blocks keep their LayerNorm at ``block.2``."""
    pre = prefix + "." if prefix else ""
    ted = cfg.time_embed_dim
    norm_idx = 2 if causal else 1
    spec.linear(pre + "time_mlp.linear_1", cfg.in_channels, ted)
    spec.linear(pre + "time_mlp.linear_2", ted, ted)

    def resnet(name, dim_in, dim_out):
        spec.linear(f"{name}.mlp.1", ted, dim_out)
        spec.conv1d(f"{name}.block1.block.0", dim_in, dim_out, 3)
        spec.norm(f"{name}.block1.block.{norm_idx}", dim_out)
        spec.conv1d(f"{name}.block2.block.0", dim_out, dim_out, 3)
        spec.norm(f"{name}.block2.block.{norm_idx}", dim_out)
        spec.conv1d(f"{name}.res_conv", dim_in, dim_out, 1)

    def tblock(name, dim):
        inner = cfg.num_heads * cfg.attention_head_dim
        spec.norm(f"{name}.norm1", dim)
        spec.norm(f"{name}.norm3", dim)
        for qkv in ("to_q", "to_k", "to_v"):
            spec.linear(f"{name}.attn1.{qkv}", dim, inner, bias=False)
        spec.linear(f"{name}.attn1.to_out.0", inner, dim)
        ff_inner = dim * 4
        spec.linear(f"{name}.ff.net.0.proj", dim,
                    ff_inner * 2 if cfg.act_fn == "geglu" else ff_inner)
        spec.linear(f"{name}.ff.net.2", ff_inner, dim)

    n_levels = len(cfg.channels)
    out_ch = cfg.in_channels
    for i in range(n_levels):
        in_ch, out_ch = out_ch, cfg.channels[i]
        resnet(f"{pre}down_blocks.{i}.0", in_ch, out_ch)
        for j in range(cfg.n_blocks):
            tblock(f"{pre}down_blocks.{i}.1.{j}", out_ch)
        if i < n_levels - 1:
            spec.conv1d(f"{pre}down_blocks.{i}.2.conv", out_ch, out_ch, 3)
        else:
            spec.conv1d(f"{pre}down_blocks.{i}.2", out_ch, out_ch, 3)

    for i in range(cfg.num_mid_blocks):
        resnet(f"{pre}mid_blocks.{i}.0", cfg.channels[-1], cfg.channels[-1])
        for j in range(cfg.n_blocks):
            tblock(f"{pre}mid_blocks.{i}.1.{j}", cfg.channels[-1])

    rev = tuple(reversed(cfg.channels)) + (cfg.channels[0],)
    for i in range(len(rev) - 1):
        in_ch, out_ch = rev[i] * 2, rev[i + 1]
        resnet(f"{pre}up_blocks.{i}.0", in_ch, out_ch)
        for j in range(cfg.n_blocks):
            tblock(f"{pre}up_blocks.{i}.1.{j}", out_ch)
        if i < len(rev) - 2:
            spec.conv_transpose1d(f"{pre}up_blocks.{i}.2.conv", out_ch, out_ch, 4)
        else:
            spec.conv1d(f"{pre}up_blocks.{i}.2", out_ch, out_ch, 3)

    spec.conv1d(f"{pre}final_block.block.0", rev[-1], rev[-1], 3)
    spec.norm(f"{pre}final_block.block.{norm_idx}", rev[-1])
    spec.conv1d(f"{pre}final_proj", rev[-1], cfg.out_channels, 1)
