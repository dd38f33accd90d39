"""Qwen2 decoder backbone, CosyVoice2's LLM (the port of the JAX package's
``layers/qwen2.py``).

The public Qwen2 architecture (RMSNorm, rotary embeddings in the HF
half-rotation layout, grouped-query attention, SwiGLU MLP) over flat params
with HF state-dict names (``layers.N.self_attn.q_proj.weight`` ...), so the
packed CosyVoice2 llm.pt loads verbatim.  The JAX module reaches no Pallas
kernel: its products are XLA's, so this port is plain PyTorch throughout.

A KV cache is a pair of fixed-capacity (B, KV, S, d) buffers; a forward over
T new rows writes their keys and values at ``cache_index`` (one column for
all rows, or one column a row when T == 1) in place and attends over the
buffers with the caller's additive bias.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ctx import EVAL, Ctx
from ..ops import masks as M
from ..params import P, Spec
from .basic import dense


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2-0.5B defaults (public HF config)."""

    hidden_size: int = 896
    intermediate_size: int = 4864
    num_hidden_layers: int = 24
    num_attention_heads: int = 14
    num_key_value_heads: int = 2
    head_dim: int = 64
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    vocab_size: int = 151936
    max_position_embeddings: int = 32768


def rms_norm(p: P, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    return (y * p[name + ".weight"].float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """(T,) -> cos / sin (T, head_dim); (B, T) -> (B, T, head_dim) for
    per-row positions.  HF half-rotation layout."""
    dev = positions.device
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev)
                           / head_dim))
    ang = positions.float()[..., None] * inv
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, T, d); cos / sin (T, d) shared or (B, T, d) per row."""
    d = x.shape[-1]
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    if cos.ndim == 3:
        cos, sin = cos[:, None], sin[:, None]
    return x * cos.to(x.dtype) + rotated * sin.to(x.dtype)


KVCache = Tuple[torch.Tensor, torch.Tensor]


def qwen2_attention(
    p: P,
    cfg: Qwen2Config,
    x: torch.Tensor,  # (B, T, D)
    positions: torch.Tensor,  # (T,) shared or (B, T) per row
    bias: Optional[torch.Tensor],  # additive (B, 1|T, S) or None
    ctx: Ctx = EVAL,
    kv_cache: Optional[KVCache] = None,
    cache_index=None,  # int, or a (B,) long tensor of columns (T == 1)
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """GQA self-attention; with ``kv_cache`` the new keys and values are
    written into its buffers in place and the queries attend over all of
    their columns.  ``rope``: ``rope_cos_sin(positions, ...)`` computed once
    for every layer of a forward."""
    B, T, _ = x.shape
    H, KV, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = dense(p, "q_proj", x, ctx).view(B, T, H, d).transpose(1, 2)
    k = dense(p, "k_proj", x, ctx).view(B, T, KV, d).transpose(1, 2)
    v = dense(p, "v_proj", x, ctx).view(B, T, KV, d).transpose(1, 2)
    cos, sin = rope or rope_cos_sin(positions, d, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if kv_cache is not None:
        k_buf, v_buf = kv_cache
        if isinstance(cache_index, torch.Tensor):  # one column a row, T == 1
            rows = torch.arange(B, device=x.device)
            k_buf[rows, :, cache_index] = k[:, :, 0].to(k_buf.dtype)
            v_buf[rows, :, cache_index] = v[:, :, 0].to(v_buf.dtype)
        else:
            k_buf[:, :, cache_index:cache_index + T] = k.to(k_buf.dtype)
            v_buf[:, :, cache_index:cache_index + T] = v.to(v_buf.dtype)
        k, v = k_buf, v_buf
    # query head h reads key / value head h // (H / KV): the groups of
    # H / KV query heads broadcast over their key head
    qg = q.reshape(B, KV, H // KV, T, d)
    s = (qg @ k[:, :, None].transpose(-1, -2) / math.sqrt(d)).float()
    if bias is not None:
        s = s + (bias[:, None, None] if bias.ndim == 3 else bias[:, :, None]).float()
    attn = torch.softmax(s, dim=-1).to(x.dtype)
    out = (attn @ v[:, :, None]).reshape(B, H, T, d).transpose(1, 2).reshape(B, T, H * d)
    return dense(p, "o_proj", out, ctx)


def qwen2_mlp(p: P, x: torch.Tensor, ctx: Ctx = EVAL) -> torch.Tensor:
    return dense(p, "down_proj", F.silu(dense(p, "gate_proj", x, ctx))
                 * dense(p, "up_proj", x, ctx), ctx)


def qwen2_layer(p: P, cfg: Qwen2Config, x: torch.Tensor, positions, bias, ctx: Ctx = EVAL,
                kv_cache: Optional[KVCache] = None, cache_index=None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    h = rms_norm(p, "input_layernorm", x, cfg.rms_norm_eps)
    x = x + qwen2_attention(p.sub("self_attn"), cfg, h, positions, bias, ctx,
                            kv_cache, cache_index, rope)
    h = rms_norm(p, "post_attention_layernorm", x, cfg.rms_norm_eps)
    return x + qwen2_mlp(p.sub("mlp"), h, ctx)


def qwen2_forward(p: P, cfg: Qwen2Config, inputs_embeds: torch.Tensor,
                  lengths: torch.Tensor, ctx: Ctx = EVAL) -> torch.Tensor:
    """Full-sequence causal forward -> last hidden states (B, T, D)
    (llm.py:236-245: Qwen2Encoder.forward uses hidden_states[-1]); ``p``
    is rooted at the backbone (embed_tokens, layers.N, norm)."""
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    pad = M.make_non_pad_mask(lengths.to(dev), T)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
    bias = torch.where(causal[None] & pad[:, None, :], 0.0, M.NEG_BIAS).to(inputs_embeds.dtype)
    positions = torch.arange(T, device=dev)
    rope = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    x = inputs_embeds
    for i in range(cfg.num_hidden_layers):
        x = qwen2_layer(p.sub(f"layers.{i}"), cfg, x, positions, bias, ctx, rope=rope)
    return rms_norm(p, "norm", x, cfg.rms_norm_eps)


def qwen2_spec(spec: Spec, cfg: Qwen2Config, prefix: str = "model") -> Spec:
    """Names and shapes of the JAX package's ``init_qwen2_params``."""
    pre = prefix + "." if prefix else ""
    D, H, KV, hd = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
    ones = lambda t, g: t.fill_(1.0)  # noqa: E731
    spec.embedding(pre + "embed_tokens", cfg.vocab_size, D)
    for i in range(cfg.num_hidden_layers):
        lp = f"{pre}layers.{i}"
        spec.linear(f"{lp}.self_attn.q_proj", D, H * hd)
        spec.linear(f"{lp}.self_attn.k_proj", D, KV * hd)
        spec.linear(f"{lp}.self_attn.v_proj", D, KV * hd)
        spec.linear(f"{lp}.self_attn.o_proj", H * hd, D, bias=False)
        spec.linear(f"{lp}.mlp.gate_proj", D, cfg.intermediate_size, bias=False)
        spec.linear(f"{lp}.mlp.up_proj", D, cfg.intermediate_size, bias=False)
        spec.linear(f"{lp}.mlp.down_proj", cfg.intermediate_size, D, bias=False)
        spec.add(f"{lp}.input_layernorm.weight", (D,), ones)
        spec.add(f"{lp}.post_attention_layernorm.weight", (D,), ones)
    spec.add(pre + "norm.weight", (D,), ones)
    return spec
