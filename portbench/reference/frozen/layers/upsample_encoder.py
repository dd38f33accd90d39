"""UpsampleConformerEncoder, CosyVoice2's flow encoder (the port of the JAX
package's ``layers/upsample_encoder.py``).

Reference behavior: cosyvoice/transformer/upsample_encoder.py: a token-rate
conformer stack behind a PreLookaheadLayer (3-token lookahead), a x2
nearest-neighbour + causal-conv upsampler, and a mel-rate conformer stack;
streaming uses static chunk masks (25 at token rate, 50 after upsampling).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import EncoderConfig
from ..ctx import EVAL, Ctx
from ..ops import masks as M
from ..params import P, Spec
from .basic import conv1d, dense, layer_norm, leaky_relu
from .conformer import conformer_layer, embed_input, init_encoder
from .posenc import rel_pos_table


def pre_lookahead(p: P, x: torch.Tensor, pre_len: int, ctx: Ctx = EVAL,
                  context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, C): lookahead conv over the next ``pre_len`` rows (zeros, or
    the embedded ``context`` tokens of a window that is not the last), a
    causal conv, and the residual (upsample_encoder.py:66-102)."""
    h = x.transpose(1, 2)  # (B, C, T)
    if context is None or context.shape[1] == 0:
        h = F.pad(h, (0, pre_len))
    else:
        hc = context.transpose(1, 2)
        h = F.pad(torch.cat([h, hc], dim=2), (0, pre_len - hc.shape[2]))
    h = leaky_relu(conv1d(p, "conv1", h, ctx=ctx))  # k = pre_len + 1, valid
    h = conv1d(p, "conv2", F.pad(h, (2, 0)), ctx=ctx)  # k = 3, causal
    return h.transpose(1, 2) + x


def upsample1d(p: P, x: torch.Tensor, stride: int, ctx: Ctx = EVAL) -> torch.Tensor:
    """(B, C, T) -> (B, C, T * stride): nearest x stride, left pad
    2 * stride, conv k = 2 * stride + 1 (upsample_encoder.py:37-63)."""
    h = torch.repeat_interleave(x, stride, dim=2)
    return conv1d(p, "conv", F.pad(h, (stride * 2, 0)), ctx=ctx)


def upsample_encoder_forward(
    p: P,
    cfg: EncoderConfig,  # the token-rate stack's config
    xs: torch.Tensor,  # (B, T, input_size)
    xs_lens: torch.Tensor,  # (B,)
    ctx: Ctx = EVAL,
    streaming: bool = False,
    context: Optional[torch.Tensor] = None,  # (B, pre_len, input_size) embedded tokens
    num_up_blocks: int = 4,
    up_stride: int = 2,
    pre_lookahead_len: int = 3,
    token_chunk_size: int = 25,
    mask_pads_exact: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (xs (B, T * stride, D), the pad mask at mel rate (B, 1, T2)).

    ``mask_pads_exact``: the length-masked final bucket re-zeroes pad rows
    after the embed projection and after the lookahead layer (both add a
    bias, and the lookahead conv looks right into the pad region), so a
    bucket-padded input gives the unpadded run's valid rows."""
    B, T, _ = xs.shape
    dev = xs.device
    pad_mask = M.make_non_pad_mask(xs_lens.to(dev), T)[:, None, :]
    xs, pos_emb = embed_input(p, cfg, xs, ctx, xscale=True)
    if mask_pads_exact:
        xs = xs * pad_mask.transpose(1, 2).to(xs.dtype)
    ctx_emb = None
    if context is not None and context.shape[1] != 0:
        ctx_emb, _ = embed_input(p, cfg, context, ctx, xscale=True)
    chunk = token_chunk_size if streaming else 0
    attn_bias = M.mask_to_bias(M.add_optional_chunk_mask(T, pad_mask, False, False, 0, chunk, -1),
                               xs.dtype)
    xs = pre_lookahead(p.sub("pre_lookahead_layer"), xs, pre_lookahead_len, ctx, ctx_emb)
    if mask_pads_exact:
        xs = xs * pad_mask.transpose(1, 2).to(xs.dtype)
    for i in range(cfg.num_blocks):
        xs = conformer_layer(p, f"encoders.{i}", cfg, xs, attn_bias, pos_emb, pad_mask, ctx)

    xs = upsample1d(p.sub("up_layer"), xs.transpose(1, 2), up_stride, ctx).transpose(1, 2)
    T2 = xs.shape[1]
    pad_mask2 = M.make_non_pad_mask(xs_lens.to(dev) * up_stride, T2)[:, None, :]
    sp = p.sub("up_embed")
    xs = layer_norm(sp, "out.1", dense(sp, "out.0", xs, ctx), eps=1e-5)
    xs = ctx.dropout(xs, cfg.dropout_rate) * math.sqrt(cfg.output_size)
    pos_emb2 = rel_pos_table(T2, cfg.output_size, dev).to(xs.dtype)
    chunk2 = token_chunk_size * up_stride if streaming else 0
    attn_bias2 = M.mask_to_bias(
        M.add_optional_chunk_mask(T2, pad_mask2, False, False, 0, chunk2, -1), xs.dtype)
    for i in range(num_up_blocks):
        xs = conformer_layer(p, f"up_encoders.{i}", cfg, xs, attn_bias2, pos_emb2, pad_mask2,
                             ctx)
    if cfg.normalize_before:
        xs = layer_norm(p, "after_norm", xs, eps=1e-5)
    return xs, pad_mask2


def init_upsample_encoder(spec: Spec, prefix: str, cfg: EncoderConfig, num_up_blocks: int = 4,
                          pre_lookahead_len: int = 3, up_stride: int = 2) -> Spec:
    """Names and shapes of the JAX package's ``init_upsample_encoder``."""
    if cfg.input_size != cfg.output_size:
        raise ValueError("UpsampleConformerEncoder requires input_size == output_size "
                         f"(got {cfg.input_size} vs {cfg.output_size}), as the reference does")
    pre = prefix + "." if prefix else ""
    D, H = cfg.output_size, cfg.attention_heads
    init_encoder(spec, prefix, cfg, conformer=True)
    spec.conv1d(pre + "pre_lookahead_layer.conv1", D, D, pre_lookahead_len + 1)
    spec.conv1d(pre + "pre_lookahead_layer.conv2", D, D, 3)
    spec.conv1d(pre + "up_layer.conv", D, D, up_stride * 2 + 1)
    spec.linear(pre + "up_embed.out.0", cfg.input_size, D)
    spec.norm(pre + "up_embed.out.1", D)
    bound = math.sqrt(6.0 / (H + cfg.head_dim))
    for i in range(num_up_blocks):
        lp = f"{pre}up_encoders.{i}"
        for qkv in ("linear_q", "linear_k", "linear_v", "linear_out"):
            spec.linear(f"{lp}.self_attn.{qkv}", D, D)
        spec.linear(f"{lp}.self_attn.linear_pos", D, D, bias=False)
        for b in ("pos_bias_u", "pos_bias_v"):
            spec.add(f"{lp}.self_attn.{b}", (H, cfg.head_dim),
                     lambda t, g: t.uniform_(-bound, bound, generator=g))
        spec.linear(f"{lp}.feed_forward.w_1", D, cfg.linear_units)
        spec.linear(f"{lp}.feed_forward.w_2", cfg.linear_units, D)
        spec.norm(f"{lp}.norm_mha", D)
        spec.norm(f"{lp}.norm_ff", D)
    return spec
