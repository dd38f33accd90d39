"""Speech-token LLM (TransformerLM): text -> 50 Hz speech tokens (the port of
the JAX package's ``models/llm.py``): the no-prompt training forward
(``llm_forward_train`` over the dense ``pack_lm_inputs`` layout) and the AR
decode.

The AR decode keeps a fixed-capacity KV cache per layer and projects every
layer's positional keys once, before the loop: the Transformer-XL
relative-position keys of step ``L`` are the window ``[S-1-L, S-1-L+S)`` of
the (2S-1)-row table.  A step attends the first ``L+1`` cache slots only,
which equals the full-capacity attention with -1e10 on the unwritten slots.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import LLMConfig
from ..ctx import EVAL, Ctx
from ..layers.attention import _split_heads
from ..layers.basic import ACT, dense, embedding, layer_norm
from ..layers.conformer import (encoder_forward, init_encoder, positionwise_ff,
                                transformer_layer)
from ..layers.posenc import rel_pos_table
from ..ops import masks as M
from ..ops.sampling import ras_sample
from ..params import P, ParamTree, Spec, resolve_device


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def _token_embed_legacy(p_llm: P, x: torch.Tensor) -> torch.Tensor:
    """linear_legacy input embed of the LLM backbone: Linear + LayerNorm +
    ReLU, then x * sqrt(D)."""
    sp = p_llm.sub("embed")
    x = F.relu(layer_norm(sp, "out.1", dense(sp, "out.0", x), eps=1e-5))
    return x * math.sqrt(x.shape[-1])


IGNORE_ID = -1  # padding label of the LM target


def llm_encode_text(p: P, cfg: LLMConfig, text_token: torch.Tensor,
                    text_len: torch.Tensor, ctx: Ctx = EVAL) -> torch.Tensor:
    """text_embedding -> causal conformer -> affine."""
    emb = embedding(p, "text_embedding", text_token)
    h, _ = encoder_forward(p.sub("text_encoder"), cfg.text_encoder, emb, text_len, ctx,
                           decoding_chunk_size=1, num_decoding_left_chunks=-1,
                           conformer=True)
    return dense(p, "text_encoder_affine_layer", h, ctx)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def pack_lm_inputs(
    p: P,
    cfg: LLMConfig,
    text_enc: torch.Tensor,  # (B, Tt, D) encoded text
    text_len: torch.Tensor,  # (B,)
    spk_emb: torch.Tensor,  # (B, D) projected speaker embedding
    speech_emb: torch.Tensor,  # (B, Ts, D)
    speech_len: torch.Tensor,  # (B,)
    speech_token: torch.Tensor,  # (B, Ts) int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build (lm_input (B, S, D), lm_len (B,), lm_target (B, S)) densely,
    S = 3 + Tt + Ts.  Layout per row:

        input : [sos, spk, text_0..text_{tl-1}, task, sp_0..sp_{sl-1}, pad]
        target: [IGNORE x (2+tl),              sp_0..sp_{sl-1}, EOS,  IGNORE]
    """
    B, Tt, D = text_enc.shape
    Ts = speech_emb.shape[1]
    S = 3 + Tt + Ts
    dt, dev = text_enc.dtype, text_enc.device
    emb = p["llm_embedding.weight"]
    sos, task = emb[cfg.sos_eos].to(dt), emb[cfg.task_id].to(dt)

    pos = torch.arange(S, device=dev)[None, :]  # (1, S)
    tl = text_len.long()[:, None]
    sl = speech_len.long()[:, None]

    text_idx = torch.clamp(pos - 2, 0, Tt - 1).expand(B, S)
    speech_idx = torch.clamp(pos - 3 - tl, 0, Ts - 1)
    g_text = torch.gather(text_enc, 1, text_idx[:, :, None].expand(B, S, D))
    g_speech = torch.gather(speech_emb, 1, speech_idx[:, :, None].expand(B, S, D))

    is_text = (pos >= 2) & (pos < 2 + tl)
    is_task = pos == 2 + tl
    is_speech = (pos > 2 + tl) & (pos < 3 + tl + sl)
    lm_input = torch.where(is_speech[:, :, None], g_speech, torch.zeros((), dtype=dt, device=dev))
    lm_input = torch.where(is_task[:, :, None], task[None, None, :], lm_input)
    lm_input = torch.where(is_text[:, :, None], g_text, lm_input)
    lm_input = torch.where((pos == 1)[:, :, None], spk_emb[:, None, :].to(dt), lm_input)
    lm_input = torch.where((pos == 0)[:, :, None], sos[None, None, :], lm_input)
    lm_len = (3 + tl + sl)[:, 0]

    tgt_idx = torch.clamp(pos - 2 - tl, 0, Ts - 1)
    g_tok = torch.gather(speech_token.long(), 1, tgt_idx)
    is_tgt_speech = (pos >= 2 + tl) & (pos < 2 + tl + sl)
    is_eos = pos == 2 + tl + sl
    lm_target = torch.where(
        is_tgt_speech, g_tok,
        torch.where(is_eos, cfg.speech_token_size, IGNORE_ID))
    return lm_input, lm_len, lm_target


def label_smoothing_loss(
    logits: torch.Tensor,  # (B, S, V)
    target: torch.Tensor,  # (B, S) with IGNORE_ID padding
    smoothing: float = 0.0,
    normalize_length: bool = True,
) -> torch.Tensor:
    """KL(true_dist || softmax(logits)) with label smoothing, summed over
    the non-ignored positions and divided by their count (or by B)."""
    B, S, V = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = target != IGNORE_ID
    tgt = torch.where(valid, target, 0)
    logp_tgt = torch.gather(logp, 2, tgt[:, :, None])[:, :, 0]
    if smoothing > 0.0:
        # kl = sum_v true * (log true - logp), split into target + others
        confidence = 1.0 - smoothing
        low = smoothing / (V - 1)
        ent = confidence * math.log(confidence) + (V - 1) * low * math.log(low)
        kl = ent - (confidence - low) * logp_tgt - low * logp.sum(dim=-1)
    else:
        kl = -logp_tgt
    kl = torch.where(valid, kl, 0.0)
    denom = torch.clamp(valid.sum(), min=1) if normalize_length else B
    return kl.sum() / denom


def th_accuracy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Argmax accuracy over the non-ignored positions."""
    pred = logits.argmax(dim=-1)
    valid = target != IGNORE_ID
    correct = (valid & (pred == target)).sum()
    return correct / torch.clamp(valid.sum(), min=1)


def llm_forward_train(p: P, cfg: LLMConfig, batch: Dict[str, torch.Tensor],
                      ctx: Ctx) -> Dict[str, torch.Tensor]:
    """No-prompt training forward.  batch keys: text_token (B, Tt),
    text_token_len (B,), speech_token (B, Ts), speech_token_len (B,),
    embedding (B, 192).  Returns {'loss', 'acc'}."""
    text_len = batch["text_token_len"]
    speech_token = batch["speech_token"].long()
    speech_len = batch["speech_token_len"]

    text_enc = llm_encode_text(p, cfg, batch["text_token"].long(), text_len, ctx)
    spk_emb = dense(p, "spk_embed_affine_layer",
                    _l2_normalize(batch["embedding"].to(text_enc.dtype), dim=1), ctx)
    speech_emb = embedding(p, "speech_embedding", speech_token, clamp_min=0)

    lm_input, lm_len, lm_target = pack_lm_inputs(
        p, cfg, text_enc, text_len, spk_emb, speech_emb, speech_len, speech_token)
    lm_out, _ = encoder_forward(p.sub("llm"), cfg.llm, lm_input, lm_len, ctx,
                                conformer=False)
    logits = dense(p, "llm_decoder", lm_out, ctx)
    loss = label_smoothing_loss(logits, lm_target, cfg.lsm_weight,
                                cfg.length_normalized_loss)
    return {"loss": loss, "acc": th_accuracy(logits, lm_target)}


# ---------------------------------------------------------------------------
# Autoregressive decode
# ---------------------------------------------------------------------------


@dataclass
class KVCache:
    """Fixed-capacity decode state of one sequence."""
    k: torch.Tensor  # (nl, H, S, dk)
    v: torch.Tensor  # (nl, H, S, dk)
    pos_k: torch.Tensor  # (nl, H, 2S-1, dk) projected positional keys


def llm_prefill(p: P, cfg: LLMConfig, prefix_emb: torch.Tensor, capacity: int):
    """Run the causal backbone over the (1, L0, D) prefix, seed a cache of
    ``capacity`` slots with its K/V, and return (logits of the next token
    (V+1,), cache)."""
    ecfg = cfg.llm
    nl, H, dk = ecfg.num_blocks, ecfg.attention_heads, ecfg.head_dim
    p_llm = p.sub("llm")
    L0 = prefix_emb.shape[1]
    dt, dev = prefix_emb.dtype, prefix_emb.device
    table = rel_pos_table(capacity, ecfg.output_size, dev).to(dt)
    pos_k = torch.stack([
        _split_heads(dense(p_llm.sub(f"encoders.{i}.self_attn"), "linear_pos", table), H)[0]
        for i in range(nl)])
    cache = KVCache(k=torch.zeros((nl, H, capacity, dk), dtype=dt, device=dev),
                    v=torch.zeros((nl, H, capacity, dk), dtype=dt, device=dev),
                    pos_k=pos_k)
    h = _token_embed_legacy(p_llm, prefix_emb)
    pe0 = rel_pos_table(L0, ecfg.output_size, dev).to(dt)
    causal = torch.where(torch.arange(L0, device=dev)[:, None]
                         >= torch.arange(L0, device=dev)[None, :], 0.0, M.NEG_BIAS)
    causal = causal[None].to(dt)
    for i in range(nl):
        h, (ki, vi) = transformer_layer(p_llm, f"encoders.{i}", ecfg, h, causal, pe0,
                                        return_kv=True)
        cache.k[i, :, :L0] = ki[0]
        cache.v[i, :, :L0] = vi[0]
    h = layer_norm(p_llm, "after_norm", h, eps=1e-5)
    return dense(p, "llm_decoder", h[:, -1])[0], cache


def llm_decode_step(p: P, cfg: LLMConfig, cache: KVCache, token: int,
                    L: int) -> torch.Tensor:
    """Feed one speech token at absolute position / cache slot ``L``; writes
    its K/V into the cache and returns the next token's logits (V+1,)."""
    ecfg = cfg.llm
    H, dk = ecfg.attention_heads, ecfg.head_dim
    S = cache.k.shape[2]
    p_llm = p.sub("llm")
    act = ACT[ecfg.activation_type]
    eps = ecfg.layer_norm_eps
    ids = torch.tensor([[token]], device=cache.k.device)
    x = _token_embed_legacy(p_llm, embedding(p, "speech_embedding", ids))  # (1, 1, D)
    for i in range(ecfg.num_blocks):
        sp = p_llm.sub(f"encoders.{i}")
        sa = sp.sub("self_attn")
        hn = layer_norm(sp, "norm1", x, eps=eps)
        q = dense(sa, "linear_q", hn).reshape(H, dk)
        cache.k[i, :, L] = dense(sa, "linear_k", hn).reshape(H, dk)
        cache.v[i, :, L] = dense(sa, "linear_v", hn).reshape(H, dk)
        kc, vc = cache.k[i, :, : L + 1], cache.v[i, :, : L + 1]
        pk = cache.pos_k[i, :, S - 1 - L: S]  # relative positions L .. 0
        scores = (torch.einsum("hd,hsd->hs", q + sa["pos_bias_u"].to(q.dtype), kc)
                  + torch.einsum("hd,hsd->hs", q + sa["pos_bias_v"].to(q.dtype), pk))
        attn = torch.softmax(scores.float() / math.sqrt(dk), dim=-1).to(x.dtype)
        o = torch.einsum("hs,hsd->hd", attn, vc).reshape(1, 1, H * dk)
        x = x + dense(sa, "linear_out", o)
        x = x + positionwise_ff(sp, "feed_forward", layer_norm(sp, "norm2", x, eps=eps), act)
    x = layer_norm(p_llm, "after_norm", x, eps=1e-5)
    return dense(p, "llm_decoder", x[:, -1])[0]


def llm_decode(
    p: P,
    cfg: LLMConfig,
    prefix_emb: torch.Tensor,  # (1, L0, D) packed [sos, spk, text, task]
    min_len: int,
    max_len: int,
    top_p: float = 0.8,
    top_k: int = 25,
    win_size: int = 10,
    tau_r: float = 0.1,
    generator: Optional[torch.Generator] = None,
) -> List[int]:
    """AR decode of up to ``max_len`` speech tokens with RAS sampling; EOS
    is masked on the first step and before ``min_len`` (the exact
    renormalized form of the reference's rejection loop).  ``generator`` is
    a CPU generator: sampling runs on the host."""
    eos = cfg.speech_token_size
    L0 = prefix_emb.shape[1]
    logits, cache = llm_prefill(p, cfg, prefix_emb, L0 + max_len)
    tokens: List[int] = []
    for i in range(max_len):
        logp = torch.log_softmax(logits.float(), dim=-1)
        if i == 0 or i < min_len:
            logp[eos] = -math.inf
        tok = ras_sample(logp, tokens, top_p, top_k, win_size, tau_r, generator)
        if tok == eos:
            break
        tokens.append(tok)
        if i + 1 < max_len:
            logits = llm_decode_step(p, cfg, cache, tok, L0 + i)
    return tokens


class TransformerLM(ParamTree):
    """TransformerLM weights (llm.pt names)."""

    def __init__(self, cfg: LLMConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(llm_spec(cfg), device, dtype, generator)
        self.cfg = cfg


def llm_spec(cfg: LLMConfig) -> Spec:
    spec = Spec()
    spec.embedding("text_embedding", cfg.text_token_size, cfg.text_encoder_input_size)
    init_encoder(spec, "text_encoder", cfg.text_encoder, conformer=True)
    spec.linear("text_encoder_affine_layer", cfg.text_encoder.output_size,
                cfg.llm_input_size)
    spec.embedding("llm_embedding", 2, cfg.llm_input_size)
    init_encoder(spec, "llm", cfg.llm, conformer=False)
    spec.linear("llm_decoder", cfg.llm_output_size, cfg.speech_token_size + 1)
    spec.embedding("speech_embedding", cfg.speech_token_size, cfg.llm_input_size)
    spec.linear("spk_embed_affine_layer", cfg.spk_embed_dim, cfg.llm_input_size)
    return spec


def init_llm_params(cfg: LLMConfig, device=None, dtype=torch.float32,
                    seed: int = 0) -> TransformerLM:
    """A randomly initialized :class:`TransformerLM` built directly on ``device``."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    return TransformerLM(cfg, dev, dtype, gen)
