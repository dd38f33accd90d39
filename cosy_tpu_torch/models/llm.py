"""Speech-token LLM (TransformerLM): text -> 50 Hz speech tokens (the port of
the JAX package's ``models/llm.py``): the no-prompt training forward
(``llm_forward_train`` over the dense ``pack_lm_inputs`` layout) and the AR
decode.

The AR decode is one resumable object, :class:`DecodeState`, over B rows: a
solo decode (``llm_decode``) is B = 1, a micro-batch shares each step's
weight reads, and a continuous-batching engine admits requests into free
rows (``llm_admit_slot``); its state and RAS sampling live on the device
(``models.decode``), so a step makes no host read.  Prefixes are
left-padded to a common L0 and
every layer's positional keys are projected once: the Transformer-XL
relative-position keys of a query at column ``c`` are the window
``[S-1-c, S-1-c+W)`` of the (2S-1)-row table.  A step reads only the live
columns, which equals the full-capacity attention with -1e10 on the others.

Un-merged LoRA adapters serve several voices from one base model: a decode
takes a voice-stacked adapter bank (``lora.stack_voice_loras``) and each
row's voice index (``vids``).  Prefill routes them through the ``Ctx``; the
per-token step adds each row's own deltas to ``linear_q/k/v/out`` and
``w_1/w_2`` of every block (``_DECODE_LORA_MODS``), and an adapter on any
other module of the backbone is refused rather than dropped.

Weight-only int8 decode: the per-token step reads its own view of the
weights, ``step_p`` (:func:`quantize_decode_step`: those six matrices of
every block in int8), while the prefill, the positional keys and the head
read the full-precision ``p``; voice adapters add their deltas on top of
the int8 products.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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
from ..ops import sampling as S
from ..ops.sampling import ras_sample
from ..parallel.mesh import rows_denominator
from ..params import P, ParamTree, Spec, resolve_device
from .decode import Columns, DeviceDecode


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
    # batch-wide count: a data-parallel rank divides by the whole batch's
    denom = rows_denominator(valid.sum(), minimum=1) if normalize_length else B
    return kl.sum() / denom


def th_accuracy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Argmax accuracy over the non-ignored positions."""
    pred = logits.argmax(dim=-1)
    valid = target != IGNORE_ID
    correct = (valid & (pred == target)).sum()
    return correct / rows_denominator(valid.sum(), minimum=1)


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
    """Fixed-capacity decode cache of B rows.  Prefixes are LEFT-padded to a
    common L0: row b's valid prefix keys sit at columns ``[start[b], L0)``
    and the keys of its generated tokens follow at ``[L0, L0 + n_b)``.  A
    solo decode is the B = 1 case with ``start`` 0.  Relative positions make
    a row's logits those of its unpadded run."""
    k: torch.Tensor  # (nl, B, H, S, dk)
    v: torch.Tensor  # (nl, B, H, S, dk)
    pos_k: torch.Tensor  # (nl, H, 2S-1, dk) projected positional keys
    start: torch.Tensor  # (B,) long, first valid prefix column of each row


def _empty_cache(p: P, cfg: LLMConfig, B: int, capacity: int, dtype, device) -> KVCache:
    """A zeroed cache of ``capacity`` columns; every layer's positional keys
    are projected once here: the keys of a query at column ``c`` are the
    window ``[S-1-c, S-1-c+W)`` of the (2S-1)-row table."""
    ecfg = cfg.llm
    p_llm = p.sub("llm")
    table = rel_pos_table(capacity, ecfg.output_size, device).to(dtype)
    pos_k = torch.stack([
        _split_heads(dense(p_llm.sub(f"encoders.{i}.self_attn"), "linear_pos", table),
                     ecfg.attention_heads)[0]
        for i in range(ecfg.num_blocks)])
    shape = (ecfg.num_blocks, B, ecfg.attention_heads, capacity, ecfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), pos_k=pos_k,
                   start=torch.zeros((B,), dtype=torch.long, device=device))


def _prefill(p: P, cfg: LLMConfig, prefix_emb: torch.Tensor, start: torch.Tensor,
             ctx: Ctx = EVAL):
    """The causal backbone over (B, L0, D) left-padded prefixes: key k is
    visible to query q iff ``start[b] <= k <= q``; ``ctx`` carries the rows'
    adapters.  Returns (the logits of each row's next token (B, V+1), keys
    and values (nl, B, H, L0, dk))."""
    ecfg = cfg.llm
    p_llm = p.sub("llm")
    L0 = prefix_emb.shape[1]
    dt, dev = prefix_emb.dtype, prefix_emb.device
    h = _token_embed_legacy(p_llm, prefix_emb)
    pe0 = rel_pos_table(L0, ecfg.output_size, dev).to(dt)
    kq = torch.arange(L0, device=dev)
    vis = (kq[None, None, :] <= kq[None, :, None]) & (kq[None, None, :] >= start[:, None, None])
    bias = torch.where(vis, 0.0, M.NEG_BIAS).to(dt)
    ks, vs = [], []
    for i in range(ecfg.num_blocks):
        h, (ki, vi) = transformer_layer(p_llm, f"encoders.{i}", ecfg, h, bias, pe0, ctx,
                                        return_kv=True)
        ks.append(ki)
        vs.append(vi)
    h = layer_norm(p_llm, "after_norm", h, eps=1e-5)
    return dense(p, "llm_decoder", h[:, -1]), torch.stack(ks), torch.stack(vs)


def _prefilled_cache(p: P, cfg: LLMConfig, prefix_emb: torch.Tensor, valid: Sequence[int],
                     capacity: int, ctx: Ctx = EVAL):
    """Prefill B LEFT-padded prefixes (``valid[b]`` real rows each) into a
    cache of ``capacity`` columns: (next-token logits (B, V+1), cache)."""
    B, L0 = prefix_emb.shape[:2]
    cache = _empty_cache(p, cfg, B, capacity, prefix_emb.dtype, prefix_emb.device)
    cache.start = torch.tensor([L0 - v for v in valid], device=prefix_emb.device)
    logits, k, v = _prefill(p, cfg, prefix_emb, cache.start, ctx)
    cache.k[:, :, :, :L0] = k
    cache.v[:, :, :, :L0] = v
    return logits, cache


def llm_prefill(p: P, cfg: LLMConfig, prefix_emb: torch.Tensor, capacity: int):
    """Solo prefill of a (1, L0, D) prefix: (logits of the next token
    (V+1,), a cache of ``capacity`` columns seeded with the prefix's K/V)."""
    logits, cache = _prefilled_cache(p, cfg, prefix_emb, [prefix_emb.shape[1]], capacity)
    return logits[0], cache


# the six backbone matmuls the reference's LLM LoRA config targets
# (config.py LLM_LORA_DEFAULT; substring matching): the per-token step
# applies each row's own deltas to these
_DECODE_LORA_MODS = ("self_attn.linear_q", "self_attn.linear_k",
                     "self_attn.linear_v", "self_attn.linear_out",
                     "feed_forward.w_1", "feed_forward.w_2")


def _stack_decode_loras(lora: Dict[str, torch.Tensor], nl: int,
                        prefix: str = "llm.encoders") -> Dict[str, torch.Tensor]:
    """The adapters the decode's prefill and step read, voice-stacked
    ((V, r, in) / (V, out, r); one un-stacked voice is wrapped as V = 1):
    the ``{prefix}.{i}.<module>.lora_A/B`` keys of ``_DECODE_LORA_MODS``
    over all ``nl`` blocks.  Any other adapter key would be applied in
    training but dropped by the decode, so the tokens would leave the
    merged-weights build's: it raises.  ``text_encoder.*`` adapters are
    prefill-only (the pipeline's prefix runs the text encoder) and pass."""
    from ..lora import ensure_voice_stacked

    unsupported = sorted(
        k for k in lora
        if ".lora_" in k and not k.startswith("text_encoder.")
        and not any(f".{mod}.lora_" in k for mod in _DECODE_LORA_MODS))
    if unsupported:
        raise ValueError(
            "decode-loop LoRA routing covers the llm-block modules "
            f"{_DECODE_LORA_MODS} (plus text_encoder.* in prefill); these "
            f"adapter keys would be silently ignored at decode: "
            f"{unsupported[:6]}{'...' if len(unsupported) > 6 else ''} - "
            "merge them into the weights or retrain with the default target list")
    out: Dict[str, torch.Tensor] = {}
    for mod in _DECODE_LORA_MODS:
        if f"{prefix}.0.{mod}.lora_A" not in lora:
            continue
        for i in range(nl):
            for s in ("A", "B"):
                k = f"{prefix}.{i}.{mod}.lora_{s}"
                out[k] = lora[k]
    return ensure_voice_stacked(out)


def quantize_decode_step(p: P, cfg: LLMConfig) -> P:
    """The weights the int8 decode step reads: ``p`` with ``linear_q/k/v/
    out``, ``w_1`` and ``w_2`` of every backbone block (``llm.encoders.*``)
    weight-only int8 with per-output-row scales (``quant.quantize_int8``).
    The JAX package quantizes the same matrices with q, k and v fused into
    one, whose per-row scales are theirs taken apart, so the int8 values
    are the same."""
    from ..quant import quantize_int8

    return P(quantize_int8(p.d, tuple(f"{m}.weight" for m in _DECODE_LORA_MODS),
                           prefix=p.prefix + "llm.encoders."), p.prefix)


def _decode_ctx(lora: Optional[Dict[str, torch.Tensor]], vids: Optional[Sequence[int]],
                scale: float, device) -> Ctx:
    """The ``Ctx`` that routes row b through voice ``vids[b]`` of ``lora``."""
    if lora is None:
        return EVAL
    return Ctx(lora=lora, lora_scale=scale,
               lora_vids=torch.tensor(list(vids), dtype=torch.long, device=device))


def llm_decode_step_batch(p: P, cfg: LLMConfig, cache: KVCache, tokens, cols,
                          ctx: Ctx = EVAL) -> torch.Tensor:
    """Feed row b's token ``tokens[b]`` at cache column ``cols[b]`` (its
    absolute position); writes its K/V there and returns every row's
    next-token logits (B, V+1).  Row b attends columns ``[start[b], cols[b]]``
    with its own positional window.  The step reads only the columns
    ``[0, max(cols) + 1)``, or ``[0, cols.width)`` for device columns: the
    -1e10 bias beyond a row's last column adds exact zeros to its softmax,
    so a row's result is its solo decode's.  ``tokens`` and ``cols`` are
    host sequences, or a (B,) long tensor and :class:`~.decode.Columns` on
    the cache's device (the device-resident decode's: no host read).
    ``ctx`` adds each row's adapter deltas (``_decode_ctx``)."""
    ecfg = cfg.llm
    H, dk = ecfg.attention_heads, ecfg.head_dim
    S = cache.k.shape[3]
    dev = cache.k.device
    p_llm = p.sub("llm")
    act = ACT[ecfg.activation_type]
    eps = ecfg.layer_norm_eps
    if not isinstance(cols, Columns):
        cols = Columns(torch.tensor(list(cols), device=dev), max(cols) + 1)
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.tensor(list(tokens), device=dev)
    B, W, col = tokens.shape[0], cols.width, cols.at
    rows = torch.arange(B, device=dev)
    kpos = torch.arange(W, device=dev)
    live = (kpos[None, :] >= cache.start[:, None]) & (kpos[None, :] <= col[:, None])
    bias = torch.where(live, 0.0, M.NEG_BIAS)[:, None, :]  # (B, 1, W) f32
    pidx = (S - 1 - col)[:, None] + kpos[None, :]  # (B, W): relative positions c .. c-W+1
    ids = tokens[:, None]
    x = _token_embed_legacy(p_llm, embedding(p, "speech_embedding", ids))  # (B, 1, D)
    for i in range(ecfg.num_blocks):
        sp = p_llm.sub(f"encoders.{i}")
        sa = sp.sub("self_attn")
        hn = layer_norm(sp, "norm1", x, eps=eps)
        q = dense(sa, "linear_q", hn, ctx).reshape(B, H, dk)
        cache.k[i, rows, :, col] = dense(sa, "linear_k", hn, ctx).reshape(B, H, dk)
        cache.v[i, rows, :, col] = dense(sa, "linear_v", hn, ctx).reshape(B, H, dk)
        kc, vc = cache.k[i, :, :, :W], cache.v[i, :, :, :W]
        pk = cache.pos_k[i][:, pidx]  # (H, B, W, dk)
        scores = (torch.einsum("bhd,bhwd->bhw", q + sa["pos_bias_u"].to(q.dtype), kc)
                  + torch.einsum("bhd,hbwd->bhw", q + sa["pos_bias_v"].to(q.dtype), pk))
        attn = torch.softmax(scores.float() / math.sqrt(dk) + bias, dim=-1).to(x.dtype)
        o = torch.einsum("bhw,bhwd->bhd", attn, vc).reshape(B, 1, H * dk)
        x = x + dense(sa, "linear_out", o, ctx)
        x = x + positionwise_ff(sp, "feed_forward", layer_norm(sp, "norm2", x, eps=eps), act,
                                ctx=ctx)
    x = layer_norm(p_llm, "after_norm", x, eps=1e-5)
    return dense(p, "llm_decoder", x[:, -1])


def llm_decode_step(p: P, cfg: LLMConfig, cache: KVCache, token: int,
                    L: int) -> torch.Tensor:
    """Solo step: feed one speech token at absolute position / cache column
    ``L`` and return the next token's logits (V+1,)."""
    return llm_decode_step_batch(p, cfg, cache, [token], [L])[0]


def llm_teacher_forced_logits(p: P, cfg: LLMConfig, prefix_emb: torch.Tensor,
                              valid: Sequence[int], tokens: Sequence[Sequence[int]],
                              lora: Optional[Dict[str, torch.Tensor]] = None,
                              vids: Optional[Sequence[int]] = None,
                              lora_scale: float = 1.0,
                              step_p: Optional[P] = None) -> torch.Tensor:
    """(B, n + 1, V+1) next-token logits of B LEFT-padded prefixes fed the
    given tokens (B rows of n) through the batched prefill and steps: the
    logits each step of a batched decode samples from, for those tokens
    (with ``lora`` / ``vids`` / ``step_p`` as :func:`llm_decode_start`
    takes them)."""
    B, L0 = prefix_emb.shape[:2]
    n = len(tokens[0])
    lora, vids = _voice_rows(cfg, lora, vids, B)
    ctx = _decode_ctx(lora, vids, lora_scale, prefix_emb.device)
    logits, cache = _prefilled_cache(p, cfg, prefix_emb, valid, L0 + n, ctx)
    out = [logits]
    for j in range(n):
        out.append(llm_decode_step_batch(p if step_p is None else step_p, cfg, cache,
                                         [row[j] for row in tokens], [L0 + j] * B, ctx))
    return torch.stack(out, 1)


def _voice_rows(cfg: LLMConfig, lora, vids, B: int):
    """(the decode's voice-stacked adapters, each row's voice) or (None,
    None); one un-stacked voice dict serves every row as voice 0."""
    if lora is None:
        if vids is not None:
            raise ValueError("voice ids given without adapters")
        return None, None
    lora = _stack_decode_loras(lora, cfg.llm.num_blocks)
    vids = [0] * B if vids is None else [int(v) for v in vids]
    if len(vids) != B:
        raise ValueError(f"{len(vids)} voice ids for {B} rows")
    return lora, vids


class DecodeState(DeviceDecode):
    """A resumable AR decode of B rows on the device: the JAX package's
    ``DecodeState`` and ``BatchDecodeState`` in one (a solo decode is B =
    1), its state and RAS sampling in device tensors (``models.decode``).

    Every row keeps its own tokens, EOS floor (``min_lens``), cap
    (``caps``) and CPU ``torch.Generator``, two uniforms a token from it,
    so row b's tokens are those of a solo decode with that generator.  A
    row that sampled EOS or reached its cap is frozen (``done``).
    ``run(stop_at)`` pauses when the loop-step counter ``i`` reaches
    ``stop_at`` and resumes where it stopped, so segments give the tokens
    of one uninterrupted run.  Cache columns are slot-local
    (:class:`KVCache`): a request admitted into a free row
    (:func:`llm_admit_slot`) starts at its own column L0 whatever the other
    rows have decoded.  With adapters, ``lora`` is the voice-stacked bank
    and ``vids[b]`` row b's voice in it.  ``step_p`` is the weights the
    per-token step reads (the int8 view of :func:`quantize_decode_step`;
    None: ``p``)."""

    def __init__(self, p: P, cfg: LLMConfig, cache: KVCache, L0: int,
                 sampling: Tuple[float, int, int, float],
                 lora: Optional[Dict[str, torch.Tensor]] = None,
                 vids: Optional[List[int]] = None, lora_scale: float = 1.0,
                 step_p: Optional[P] = None):
        super().__init__(L0, cache.k.shape[1], cache.k.shape[3], cache.k.device,
                         cfg.speech_token_size, sampling)
        self.p, self.cfg, self.cache = p, cfg, cache
        self.lora, self.vids, self.lora_scale, self.step_p = lora, vids, lora_scale, step_p
        self._set_ctx()

    def _set_ctx(self):
        """The step's adapter routing, built once a change of voices (its
        voice ids go to the device then, not in a step)."""
        self._ctx = _decode_ctx(self.lora, self.vids, self.lora_scale, self.cache.k.device)

    def _host_rule(self):
        return None if ras_sample is S.ras_sample else ras_sample

    def _logits(self, tokens, cols):
        return llm_decode_step_batch(self.p if self.step_p is None else self.step_p, self.cfg,
                                     self.cache, tokens, cols, self._ctx)


def llm_decode_start(p: P, cfg: LLMConfig, prefix_emb: torch.Tensor,
                     valid: Sequence[int], min_lens: Sequence[int], caps: Sequence[int],
                     generators: Sequence[Optional[torch.Generator]],
                     top_p: float = 0.8, top_k: int = 25, win_size: int = 10,
                     tau_r: float = 0.1, lora: Optional[Dict[str, torch.Tensor]] = None,
                     vids: Optional[Sequence[int]] = None,
                     lora_scale: float = 1.0, step_p: Optional[P] = None) -> DecodeState:
    """Prefill B LEFT-padded prefixes (B, L0, D) with ``valid[b]`` real
    rows each and sample every row's first token on the device: a
    :class:`DecodeState` of capacity ``max(caps)`` tokens a row, paused
    after step 0.  ``lora``: a voice-stacked adapter bank (or one voice's
    dict) served un-merged, row b through voice ``vids[b]`` (all 0 when
    None) at ``lora_scale``.  ``step_p``: the per-token step's weights
    (:func:`quantize_decode_step` for the int8 decode); the prefill reads
    ``p``."""
    B, L0 = prefix_emb.shape[:2]
    if min(caps) < 1:
        raise ValueError(f"every cap must be >= 1, got {list(caps)}")
    lora, vids = _voice_rows(cfg, lora, vids, B)
    ctx = _decode_ctx(lora, vids, lora_scale, prefix_emb.device)
    logits, cache = _prefilled_cache(p, cfg, prefix_emb, valid, L0 + max(caps), ctx)
    state = DecodeState(p, cfg, cache, L0, (top_p, top_k, win_size, tau_r), lora=lora,
                        vids=vids, lora_scale=lora_scale, step_p=step_p)
    state._reset(slice(None), min_lens, caps, generators)
    state._first(logits, slice(None))
    return state


def llm_decode_idle(p: P, cfg: LLMConfig, slots: int, L0: int, max_len: int, dtype, device,
                    top_p: float = 0.8, top_k: int = 25, win_size: int = 10,
                    tau_r: float = 0.1, lora: Optional[Dict[str, torch.Tensor]] = None,
                    lora_scale: float = 1.0, step_p: Optional[P] = None) -> DecodeState:
    """A :class:`DecodeState` of ``slots`` free rows (all done), prefix width
    L0 and ``max_len`` tokens a row, for :func:`llm_admit_slot` to fill;
    with ``lora`` (a voice-stacked bank) every admission names its voice.
    ``step_p`` as :func:`llm_decode_start` takes it."""
    cache = _empty_cache(p, cfg, slots, L0 + max_len, dtype, device)
    lora, vids = _voice_rows(cfg, lora, None, slots)
    return DecodeState(p, cfg, cache, L0, (top_p, top_k, win_size, tau_r), lora=lora,
                       vids=vids, lora_scale=lora_scale, step_p=step_p)


def llm_admit_slot(state: DecodeState, prefix_emb: torch.Tensor, valid: int, min_len: int,
                   cap: int, generator: Optional[torch.Generator], slot: int,
                   vid: Optional[int] = None) -> None:
    """Admit one request into row ``slot`` of a paused state (the
    continuous-batching join): prefill its (1, L0, D) LEFT-padded prefix
    (``valid`` real rows), sample its first token on the device from ITS
    OWN generator, as a solo decode with that generator does, and splice its
    cache, tokens, ``last``, ``done`` and bounds into the row.  ``state.i``
    is untouched.  ``vid``: the request's voice in the state's adapter
    bank; a state with adapters needs one, a state without refuses one."""
    if prefix_emb.shape[1] != state.L0 or not 1 <= cap <= state.max_len:
        raise ValueError(f"prefix width {prefix_emb.shape[1]} (state {state.L0}) or cap "
                         f"{cap} (state {state.max_len}) does not fit")
    if (vid is None) != (state.lora is None):
        raise ValueError("a voice id needs a state started with adapters, and such a "
                         "state needs every admission's voice id")
    L0 = state.L0
    start = torch.tensor([L0 - valid], device=prefix_emb.device)
    if vid is not None:
        state.vids[slot] = int(vid)
        state._set_ctx()
    ctx = _decode_ctx(state.lora, None if vid is None else [vid], state.lora_scale,
                      prefix_emb.device)
    logits, k, v = _prefill(state.p, state.cfg, prefix_emb, start, ctx)
    state.cache.k[:, slot, :, :L0] = k[:, 0]
    state.cache.v[:, slot, :, :L0] = v[:, 0]
    state.cache.start[slot] = L0 - valid
    sl = slice(slot, slot + 1)
    state._reset(sl, [min_len], [cap], [generator])
    state._first(logits, sl)


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
    lora: Optional[Dict[str, torch.Tensor]] = None,
    vid: Optional[int] = None,
    lora_scale: float = 1.0,
    step_p: Optional[P] = None,
) -> List[int]:
    """AR decode of up to ``max_len`` speech tokens with RAS sampling: one
    uninterrupted run of a solo :class:`DecodeState`.  ``generator`` is a
    CPU generator: its uniforms are drawn in bulk and sampled on the device.
    ``lora`` / ``vid``: serve voice ``vid`` of a voice-stacked bank (or one
    voice's dict) un-merged.  ``step_p``: the int8 step weights of
    :func:`quantize_decode_step`."""
    state = llm_decode_start(p, cfg, prefix_emb, [prefix_emb.shape[1]], [min_len],
                             [max_len], [generator], top_p, top_k, win_size, tau_r,
                             lora=lora, vids=None if vid is None else [vid],
                             lora_scale=lora_scale, step_p=step_p)
    return state.run().tokens[0]


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
