"""ASR-style Transformer decoders, left-to-right and bidirectional (the
port of the JAX package's ``layers/decoder.py``).

Reference: cosyvoice/transformer/decoder.py (TransformerDecoder :33-250,
BiTransformerDecoder :253-356) and decoder_layer.py.  No TTS path runs them;
they complete the registry, with the torch weight names
(``decoders.N.{self_attn,src_attn}.linear_{q,k,v,out}``, ``norm1..3``,
``feed_forward.w_{1,2}``, ``embed.0``, ``output_layer``).  Masks become
additive biases once a call; there is no incremental decode cache, since
nothing in the TTS product drives ASR beam search.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ..ctx import EVAL, Ctx
from ..ops import masks as M
from ..params import P, Spec
from .attention import mha
from .basic import dense, embedding, layer_norm
from .posenc import abs_pos_encoding


@dataclass(frozen=True)
class DecoderConfig:
    """decoder.py:59-77 constructor args (the on-registry subset)."""

    vocab_size: int
    encoder_output_size: int
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    src_attention: bool = True
    activation: str = "relu"
    layer_norm_eps: float = 1e-5


def _ffn(p: P, x: torch.Tensor, cfg: DecoderConfig, ctx: Ctx) -> torch.Tensor:
    h = ctx.dropout(torch.relu(dense(p, "w_1", x, ctx)), cfg.dropout_rate)
    return dense(p, "w_2", h, ctx)


def decoder_layer(
    p: P,
    name: str,
    cfg: DecoderConfig,
    x: torch.Tensor,  # (B, L, D)
    tgt_bias: torch.Tensor,  # (B, L, L) additive
    memory: torch.Tensor,  # (B, S, D)
    mem_bias: torch.Tensor,  # (B, 1, S) additive, shared by the queries
    ctx: Ctx,
) -> torch.Tensor:
    """Pre-norm DecoderLayer (decoder_layer.py:62-132)."""
    sp = p.sub(name)
    eps, rate = cfg.layer_norm_eps, cfg.dropout_rate
    h = layer_norm(sp, "norm1", x, eps=eps)
    x = x + ctx.dropout(mha(sp, "self_attn", h, h, h, tgt_bias, cfg.attention_heads, ctx,
                            dropout_rate=rate), rate)
    if cfg.src_attention:
        h = layer_norm(sp, "norm2", x, eps=eps)
        bias = mem_bias.expand(x.shape[0], x.shape[1], memory.shape[1])
        x = x + ctx.dropout(mha(sp, "src_attn", h, memory, memory, bias, cfg.attention_heads,
                                ctx, dropout_rate=rate), rate)
    h = layer_norm(sp, "norm3", x, eps=eps)
    return x + ctx.dropout(_ffn(sp.sub("feed_forward"), h, cfg, ctx), rate)


def transformer_decoder_forward(
    p: P,
    cfg: DecoderConfig,
    memory: torch.Tensor,  # (B, S, D)
    memory_len: torch.Tensor,  # (B,)
    ys_in: torch.Tensor,  # (B, L) token ids, sos-prefixed
    ys_len: torch.Tensor,  # (B,)
    ctx: Ctx = EVAL,
):
    """decoder.py:117-180: embedding and positional encoding, the layers,
    after_norm, the output layer.  Returns (logits (B, L, V), olens (B,))."""
    L, S = ys_in.shape[1], memory.shape[1]
    pad = M.make_non_pad_mask(ys_len, L)  # (B, L)
    pos = torch.arange(L, device=ys_in.device)
    causal = pos[:, None] >= pos[None, :]
    tgt_bias = M.mask_to_bias(pad[:, None, :] & causal[None], memory.dtype)
    mem_bias = M.mask_to_bias(M.make_non_pad_mask(memory_len, S)[:, None, :], memory.dtype)

    x = embedding(p, "embed.0", ys_in)
    x, _ = abs_pos_encoding(x)  # PositionalEncoding with x * sqrt(d) (embed.1)
    x = ctx.dropout(x, cfg.positional_dropout_rate)
    for i in range(cfg.num_blocks):
        x = decoder_layer(p, f"decoders.{i}", cfg, x, tgt_bias, memory, mem_bias, ctx)
    x = layer_norm(p, "after_norm", x, eps=cfg.layer_norm_eps)
    return dense(p, "output_layer", x, ctx), pad.sum(dim=-1)


def bi_transformer_decoder_forward(
    p: P,
    cfg: DecoderConfig,
    memory: torch.Tensor,
    memory_len: torch.Tensor,
    ys_in: torch.Tensor,
    ys_len: torch.Tensor,
    r_ys_in: torch.Tensor,  # reversed targets for the right-to-left decoder
    reverse_weight: float = 0.0,
    r_num_blocks: Optional[int] = None,
    ctx: Ctx = EVAL,
):
    """BiTransformerDecoder (decoder.py:253-356): the left decoder always,
    the right one (its own, possibly shallower, block count) when
    ``reverse_weight > 0``, else a zero scalar in its place.  Returns
    (l_logits, r_logits, olens)."""
    l_x, olens = transformer_decoder_forward(p.sub("left_decoder"), cfg, memory, memory_len,
                                             ys_in, ys_len, ctx)
    r_x = torch.zeros((), dtype=l_x.dtype, device=l_x.device)
    if reverse_weight > 0.0:
        r_cfg = cfg if r_num_blocks is None else dataclasses.replace(cfg, num_blocks=r_num_blocks)
        r_x, _ = transformer_decoder_forward(p.sub("right_decoder"), r_cfg, memory, memory_len,
                                             r_ys_in, ys_len, ctx)
    return l_x, r_x, olens


def init_transformer_decoder(spec: Spec, prefix: str, cfg: DecoderConfig) -> Spec:
    """Names and shapes of the JAX package's ``init_transformer_decoder``
    (torch's default initializers)."""
    pre = prefix + "." if prefix else ""
    d = cfg.encoder_output_size
    spec.embedding(pre + "embed.0", cfg.vocab_size, d)
    for i in range(cfg.num_blocks):
        lp = f"{pre}decoders.{i}."
        for attn in ("self_attn",) + (("src_attn",) if cfg.src_attention else ()):
            for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
                spec.linear(lp + f"{attn}.{lin}", d, d)
        spec.linear(lp + "feed_forward.w_1", d, cfg.linear_units)
        spec.linear(lp + "feed_forward.w_2", cfg.linear_units, d)
        for n in ("norm1", "norm2", "norm3"):
            spec.norm(lp + n, d)
    spec.norm(pre + "after_norm", d)
    spec.linear(pre + "output_layer", d, cfg.vocab_size)
    return spec


def init_bi_transformer_decoder(spec: Spec, cfg: DecoderConfig, r_num_blocks: int = 0) -> Spec:
    """The left decoder under ``left_decoder.``, and with ``r_num_blocks``
    a right one of that depth under ``right_decoder.``."""
    init_transformer_decoder(spec, "left_decoder", cfg)
    if r_num_blocks:
        init_transformer_decoder(spec, "right_decoder",
                                 dataclasses.replace(cfg, num_blocks=r_num_blocks))
    return spec
