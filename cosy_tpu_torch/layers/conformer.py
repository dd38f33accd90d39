"""Conformer / Transformer encoder stack (the port of the JAX package's
``layers/conformer.py``): the flow token encoder (6-block conformer), the
LLM text encoder (6-block causal conformer) and the LLM backbone (14-block
causal transformer with the ``linear_legacy`` input).  A conformer block
takes the CNN module (``EncoderConfig.use_cnn_module``) where a
configuration asks for it; none of CosyVoice's does.  The ``Ctx`` carries
LoRA adapters and, in training, the dropout points of the reference
(embedding, positional table, attention weights, feed-forward hidden and
every residual branch).

``EncoderConfig.gradient_checkpointing`` recomputes each layer's
activations in the backward pass (``torch.utils.checkpoint``, non-reentrant)
where the JAX package wraps the layer in ``jax.checkpoint``, in training
only; a layer's dropout masks are drawn again from the same generator state
on the recompute, so the loss and gradients equal the stored run's."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import EncoderConfig
from ..ctx import EVAL, Ctx
from ..ops import masks as M
from ..parallel import comm
from ..parallel.tp import model_group, split_axis
from ..params import P, Spec
from .attention import mha, rel_pos_mha
from .basic import ACT, conv1d, dense, glu, layer_norm
from .posenc import rel_pos_table


def positionwise_ff(p: P, name: str, x: torch.Tensor, act, dropout: float = 0.0,
                    ctx: Ctx = EVAL) -> torch.Tensor:
    """w_2(dropout(act(w_1(x))))."""
    sp = p.sub(name)
    h = ctx.dropout(act(dense(sp, "w_1", x, ctx)), dropout)
    return dense(sp, "w_2", h, ctx)


def moe_ffn(p: P, name: str, x: torch.Tensor, n_expert: int, n_expert_per_token: int,
            act, dropout: float = 0.0, ctx: Ctx = EVAL) -> torch.Tensor:
    """Mixture-of-experts feed-forward (positionwise_feed_forward.py:58-115;
    weights ``gate`` and ``experts.{i}.w_1/w_2``, or stacked
    ``experts_stacked.w_1/w_2`` of (E, ...)).  Off every CosyVoice model
    path (the reference never instantiates it).  As in the JAX package,
    every expert runs over all tokens and is combined with its routing
    weight (zero for an unrouted token): static shapes, no gather loop.

    Expert parallelism: under ``parallel.tp.tensor_parallel`` stacked
    experts split their expert axis over the model ranks; each rank runs
    its experts and the routed combine's contraction over E is summed
    over the ranks."""
    sp = p.sub(name)
    B, L, D = x.shape
    xs = x.reshape(-1, D)
    router = dense(sp, "gate", xs, ctx)  # (B*L, n_expert)
    logits, indices = torch.topk(router, n_expert_per_token, dim=-1)
    weights = torch.softmax(logits.float(), dim=1).to(x.dtype)
    w_full = torch.zeros((xs.shape[0], n_expert), dtype=x.dtype, device=x.device)
    w_full = w_full.scatter_add(1, indices, weights)

    if sp.get("experts_stacked.w_1.weight") is not None:
        se = sp.sub("experts_stacked")
        w1, b1 = se["w_1.weight"].to(x.dtype), se["w_1.bias"].to(x.dtype)
        w2, b2 = se["w_2.weight"].to(x.dtype), se["w_2.bias"].to(x.dtype)
        group = None
        if split_axis(se.full("w_1.weight")) == 0:
            # this rank's experts: its columns of the routing weights
            group = model_group()
            E_l = w1.shape[0]
            xs = comm.grad_sum(xs, group)
            w_full = comm.grad_sum(w_full, group).narrow(1, comm.group_rank(group) * E_l, E_l)
        h = act(torch.einsum("nd,ehd->neh", xs, w1) + b1[None])
        if ctx.train and dropout > 0.0:
            h = ctx.dropout(h, dropout)
        y = torch.einsum("neh,edh->ned", h, w2) + b2[None]
        out = comm.reduce_sum(torch.einsum("ne,ned->nd", w_full, y), group)
        return out.reshape(B, L, D)

    out = torch.zeros_like(xs)
    for i in range(n_expert):
        out = out + w_full[:, i][:, None] * positionwise_ff(sp, f"experts.{i}", xs, act,
                                                            dropout, ctx)
    return out.reshape(B, L, D)


def convolution_module(p: P, name: str, x: torch.Tensor, pad_mask: torch.Tensor, act,
                       kernel_size: int, causal: bool, norm: str,
                       ctx: Ctx = EVAL) -> torch.Tensor:
    """Conformer conv module on (B, T, C) (reference: convolution.py /
    modules.py:454-530): pointwise conv -> GLU -> depthwise conv (causal:
    left-padded by kernel - 1; else centred) -> LayerNorm, or BatchNorm in
    eval from its running statistics -> activation -> pointwise conv.  Pad
    frames (``pad_mask`` (B, 1, T), True = valid) are zeroed on the way in
    and out."""
    sp = p.sub(name)
    xc = (x * pad_mask.transpose(1, 2).to(x.dtype)).transpose(1, 2)  # (B, C, T)
    C = xc.shape[1]
    xc = glu(conv1d(sp, "pointwise_conv1", xc, ctx=ctx), dim=1)
    if causal:
        xc = conv1d(sp, "depthwise_conv", F.pad(xc, (kernel_size - 1, 0)), groups=C, ctx=ctx)
    else:
        xc = conv1d(sp, "depthwise_conv", xc, padding=(kernel_size - 1) // 2, groups=C, ctx=ctx)
    if norm == "layer_norm":
        xc = layer_norm(sp, "norm", xc.transpose(1, 2), eps=1e-5).transpose(1, 2)
    else:
        mean, var, w, b = (sp["norm." + k].float()[None, :, None]
                           for k in ("running_mean", "running_var", "weight", "bias"))
        xc = ((xc.float() - mean) * torch.rsqrt(var + 1e-5) * w + b).to(xc.dtype)
    xc = conv1d(sp, "pointwise_conv2", act(xc), ctx=ctx)
    return (xc * pad_mask.to(xc.dtype)).transpose(1, 2)


def conformer_layer(p: P, name: str, cfg: EncoderConfig, x, attn_bias, pos_emb,
                    pad_mask, ctx: Ctx = EVAL):
    """Pre-norm conformer block: macaron FF and the CNN module (between
    attention and the FF, with a final LayerNorm) as ``cfg`` asks;
    ``pad_mask`` (B, 1, T) masks the CNN module's pad frames."""
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
    if cfg.use_cnn_module:
        h = convolution_module(sp, "conv_module", layer_norm(sp, "norm_conv", x, eps=eps),
                               pad_mask, act, cfg.cnn_module_kernel, cfg.causal,
                               cfg.cnn_module_norm, ctx)
        x = x + ctx.dropout(h, cfg.dropout_rate)
    h = layer_norm(sp, "norm_ff", x, eps=eps)
    x = x + ff_scale * ctx.dropout(
        positionwise_ff(sp, "feed_forward", h, act, cfg.dropout_rate, ctx),
        cfg.dropout_rate)
    if cfg.use_cnn_module:
        x = layer_norm(sp, "norm_final", x, eps=eps)
    return x


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
    return xs, ctx.dropout(pos_emb, cfg.positional_dropout_rate, batched=False)


def _checkpointed(layer, ctx: Ctx, *args) -> torch.Tensor:
    """``layer(*args, ctx)`` with its activations recomputed in backward.
    The recompute rewinds ``ctx.generator`` to the state the forward saw, so
    it draws the same dropout masks, and then puts the generator back where
    the rest of the step left it."""
    gen = ctx.generator
    start = None if gen is None else gen.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1 or gen is None:
            return layer(*a, ctx)
        after = gen.get_state()
        gen.set_state(start)
        try:
            return layer(*a, ctx)
        finally:
            gen.set_state(after)

    return checkpoint(run, *args, use_reentrant=False)


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
    (B, 1, T) bool).  Under the trainer's ``parallel.pp.pipeline_context``
    an eligible transformer stack runs as a GPipe pipeline."""
    if not conformer and decoding_chunk_size == 0:
        from ..parallel.pp import maybe_pipeline

        res = maybe_pipeline(p, cfg, xs, xs_lens, ctx, xscale,
                             num_decoding_left_chunks=num_decoding_left_chunks)
        if res is not None:
            return res
    B, T, _ = xs.shape
    pad_mask = M.make_non_pad_mask(xs_lens, T)[:, None, :]
    xs, pos_emb = embed_input(p, cfg, xs, ctx, xscale=xscale)
    chunk_masks = M.add_optional_chunk_mask(
        T, pad_mask, cfg.use_dynamic_chunk, cfg.use_dynamic_left_chunk,
        decoding_chunk_size, cfg.static_chunk_size, num_decoding_left_chunks,
        generator=ctx.generator if (cfg.use_dynamic_chunk and ctx.train) else None)
    attn_bias = M.mask_to_bias(chunk_masks, xs.dtype)
    layer, masks = ((conformer_layer, (attn_bias, pos_emb, pad_mask)) if conformer
                    else (transformer_layer, (attn_bias, pos_emb)))
    for i in range(cfg.num_blocks):
        if cfg.gradient_checkpointing and ctx.train:
            xs = _checkpointed(layer, ctx, p, f"encoders.{i}", cfg, xs, *masks)
        else:
            xs = layer(p, f"encoders.{i}", cfg, xs, *masks, ctx)
    if cfg.normalize_before:
        xs = layer_norm(p, "after_norm", xs, eps=1e-5)
    return xs, pad_mask


def init_encoder(spec: Spec, prefix: str, cfg: EncoderConfig, conformer: bool = True):
    """Names and shapes of the JAX package's ``init_encoder``; a BatchNorm
    CNN module also holds the running statistics it reads
    (``running_mean`` / ``running_var``, as a torch BatchNorm1d does)."""
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
            if cfg.use_cnn_module:
                cm = f"{lp}.conv_module"
                spec.conv1d(f"{cm}.pointwise_conv1", D, 2 * D, 1)
                spec.conv1d(f"{cm}.depthwise_conv", D, D, cfg.cnn_module_kernel, groups=D)
                spec.conv1d(f"{cm}.pointwise_conv2", D, D, 1)
                spec.norm(f"{cm}.norm", D)
                if cfg.cnn_module_norm == "batch_norm":
                    spec.zeros(f"{cm}.norm.running_mean", (D,))
                    spec.add(f"{cm}.norm.running_var", (D,), lambda t, g: t.fill_(1.0))
                spec.norm(f"{lp}.norm_conv", D)
                spec.norm(f"{lp}.norm_final", D)
        else:
            spec.norm(f"{lp}.norm1", D)
            spec.norm(f"{lp}.norm2", D)
