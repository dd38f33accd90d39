"""Conformer / Transformer encoder stack (the port of the JAX package's
``layers/conformer.py``, without the CNN module): the flow
token encoder (6-block conformer), the LLM text encoder (6-block causal
conformer) and the LLM backbone (14-block causal transformer with the
``linear_legacy`` input).  The ``Ctx`` carries LoRA adapters and, in training,
the dropout points of the reference (embedding, positional table, attention
weights, feed-forward hidden and every residual branch)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import EncoderConfig
from ..ctx import EVAL, Ctx
from ..ops import masks as M
from ..params import P, Spec
from .attention import mha, rel_pos_mha
from .basic import ACT, dense, layer_norm
from .posenc import rel_pos_table


def positionwise_ff(p: P, name: str, x: torch.Tensor, act, dropout: float = 0.0,
                    ctx: Ctx = EVAL) -> torch.Tensor:
    """w_2(dropout(act(w_1(x))))."""
    sp = p.sub(name)
    h = ctx.dropout(act(dense(sp, "w_1", x, ctx)), dropout)
    return dense(sp, "w_2", h, ctx)


def conformer_layer(p: P, name: str, cfg: EncoderConfig, x, attn_bias, pos_emb,
                    ctx: Ctx = EVAL):
    """Pre-norm conformer block (macaron FF optional, no CNN module)."""
    if cfg.use_cnn_module:
        raise NotImplementedError("the conformer CNN module is not ported yet")
    sp = p.sub(name)
    act = ACT[cfg.activation_type]
    eps = cfg.layer_norm_eps
    ff_scale = 0.5 if cfg.macaron_style else 1.0
    if cfg.macaron_style:
        h = layer_norm(sp, "norm_ff_macaron", x, eps=eps)
        x = x + ff_scale * ctx.dropout(
            positionwise_ff(sp, "feed_forward_macaron", h, act, cfg.dropout_rate, ctx),
            cfg.dropout_rate)
    h = layer_norm(sp, "norm_mha", x, eps=eps)
    h = rel_pos_mha(sp, "self_attn", h, pos_emb, attn_bias, cfg.attention_heads, ctx,
                    dropout_rate=cfg.attention_dropout_rate)
    x = x + ctx.dropout(h, cfg.dropout_rate)
    h = layer_norm(sp, "norm_ff", x, eps=eps)
    return x + ff_scale * ctx.dropout(
        positionwise_ff(sp, "feed_forward", h, act, cfg.dropout_rate, ctx),
        cfg.dropout_rate)


def transformer_layer(p: P, name: str, cfg: EncoderConfig, x, attn_bias, pos_emb,
                      ctx: Ctx = EVAL, return_kv: bool = False):
    """Pre-norm transformer block with rel-pos self-attention.
    ``return_kv`` also returns the layer's split-head (K, V) for a decode
    prefill."""
    sp = p.sub(name)
    eps = cfg.layer_norm_eps
    act = ACT[cfg.activation_type]
    h = layer_norm(sp, "norm1", x, eps=eps)
    kv = None
    if cfg.selfattention_layer_type == "rel_selfattn":
        out = rel_pos_mha(sp, "self_attn", h, pos_emb, attn_bias, cfg.attention_heads,
                          ctx, dropout_rate=cfg.attention_dropout_rate,
                          return_kv=return_kv)
        if return_kv:
            out, kv = out
    else:
        if return_kv:
            raise NotImplementedError("return_kv needs rel_selfattn")
        out = mha(sp, "self_attn", h, h, h, attn_bias, cfg.attention_heads, ctx,
                  dropout_rate=cfg.attention_dropout_rate)
    x = x + ctx.dropout(out, cfg.dropout_rate)
    h = layer_norm(sp, "norm2", x, eps=eps)
    x = x + ctx.dropout(
        positionwise_ff(sp, "feed_forward", h, act, cfg.dropout_rate, ctx),
        cfg.dropout_rate)
    return (x, kv) if return_kv else x


def embed_input(p: P, cfg: EncoderConfig, xs: torch.Tensor, ctx: Ctx = EVAL,
                xscale: bool = True):
    """Linear + LayerNorm(1e-5) + dropout (+ ReLU for linear_legacy),
    x * sqrt(d), and the full (1, 2T-1, D) relative-position table (with its
    positional dropout)."""
    sp = p.sub("embed")
    xs = layer_norm(sp, "out.1", dense(sp, "out.0", xs, ctx), eps=1e-5)
    xs = ctx.dropout(xs, cfg.dropout_rate)
    if cfg.input_layer == "linear_legacy":
        xs = F.relu(xs)
    d = cfg.output_size
    if xscale:
        xs = xs * math.sqrt(d)
    pos_emb = rel_pos_table(xs.shape[1], d, xs.device).to(xs.dtype)
    return xs, ctx.dropout(pos_emb, cfg.positional_dropout_rate)


def encoder_forward(
    p: P,
    cfg: EncoderConfig,
    xs: torch.Tensor,  # (B, T, input_size)
    xs_lens: torch.Tensor,  # (B,)
    ctx: Ctx = EVAL,
    decoding_chunk_size: int = 0,
    num_decoding_left_chunks: int = -1,
    xscale: bool = True,
    conformer: bool = True,
):
    """Full-sequence encoder forward.  Returns (xs (B, T, D), pad_mask
    (B, 1, T) bool)."""
    B, T, _ = xs.shape
    pad_mask = M.make_non_pad_mask(xs_lens, T)[:, None, :]
    xs, pos_emb = embed_input(p, cfg, xs, ctx, xscale=xscale)
    chunk_masks = M.add_optional_chunk_mask(
        T, pad_mask, cfg.use_dynamic_chunk, cfg.use_dynamic_left_chunk,
        decoding_chunk_size, cfg.static_chunk_size, num_decoding_left_chunks)
    attn_bias = M.mask_to_bias(chunk_masks, xs.dtype)
    layer = conformer_layer if conformer else transformer_layer
    for i in range(cfg.num_blocks):
        xs = layer(p, f"encoders.{i}", cfg, xs, attn_bias, pos_emb, ctx)
    if cfg.normalize_before:
        xs = layer_norm(p, "after_norm", xs, eps=1e-5)
    return xs, pad_mask


def init_encoder(spec: Spec, prefix: str, cfg: EncoderConfig, conformer: bool = True):
    """Names and shapes of the JAX package's ``init_encoder``."""
    if cfg.use_cnn_module:
        raise NotImplementedError("the conformer CNN module is not ported yet")
    pre = prefix + "." if prefix else ""
    D, H = cfg.output_size, cfg.attention_heads
    spec.linear(pre + "embed.out.0", cfg.input_size, D)
    spec.norm(pre + "embed.out.1", D)
    spec.norm(pre + "after_norm", D)
    bound = math.sqrt(6.0 / (H + cfg.head_dim))  # xavier_uniform pos biases
    for i in range(cfg.num_blocks):
        lp = f"{pre}encoders.{i}"
        for qkv in ("linear_q", "linear_k", "linear_v", "linear_out"):
            spec.linear(f"{lp}.self_attn.{qkv}", D, D, bias=cfg.key_bias)
        spec.linear(f"{lp}.self_attn.linear_pos", D, D, bias=False)
        spec.add(f"{lp}.self_attn.pos_bias_u", (H, cfg.head_dim),
                 lambda t, g: t.uniform_(-bound, bound, generator=g))
        spec.add(f"{lp}.self_attn.pos_bias_v", (H, cfg.head_dim),
                 lambda t, g: t.uniform_(-bound, bound, generator=g))
        spec.linear(f"{lp}.feed_forward.w_1", D, cfg.linear_units)
        spec.linear(f"{lp}.feed_forward.w_2", cfg.linear_units, D)
        if conformer:
            spec.norm(f"{lp}.norm_mha", D)
            spec.norm(f"{lp}.norm_ff", D)
            if cfg.macaron_style:
                spec.linear(f"{lp}.feed_forward_macaron.w_1", D, cfg.linear_units)
                spec.linear(f"{lp}.feed_forward_macaron.w_2", cfg.linear_units, D)
                spec.norm(f"{lp}.norm_ff_macaron", D)
        else:
            spec.norm(f"{lp}.norm1", D)
            spec.norm(f"{lp}.norm2", D)
