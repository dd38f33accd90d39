"""Qwen2LM, CosyVoice2's speech-token LLM over the Qwen2 backbone (the port
of the JAX package's ``models/qwen2lm.py``, its serving path): the prefix
pack [sos, text, task, prompt speech] and the AR decode.

The decode is one resumable object over B rows, :class:`Qwen2DecodeState`,
in the design of the port's ``models.llm.DecodeState``: a solo decode
(``qwen2lm_decode``) is B = 1, a micro-batch shares each step's weight
reads (``qwen2lm_decode_batch``), and ``run(stop_at)`` pauses and resumes so
segments give the tokens of one uninterrupted run (the segmented decode
behind streaming).  Prefixes are LEFT-padded to a common L0; a row's keys
are visible from its first valid column, and RoPE is relative, so a row's
logits are those of its unpadded run.  Sampling runs on the device, two
uniforms an attempt from each row's own CPU ``torch.Generator`` drawn in
bulk for a segment (``models.decode``); the bistream decode samples on the
host.

The reference's fill-token rule (llm.py:504-507): a sampled id above EOS is
neither stored nor fed back, but the attempt still feeds the previous token
at the next cache column, so attempts and emitted tokens count apart; the
EOS floor (``min_len``) counts attempts.  The first attempt masks every id
above EOS (there is no previous token to re-feed).  A row stops at EOS or
after ``cap`` attempts, which is the JAX solo decode's bound (its batched
decode bounds attempts by the bucketed capacity instead, which differs only
for a row that skips fill tokens and reaches its cap).

Continuous batching: :func:`qwen2lm_decode_idle` makes a state of free rows
and :func:`qwen2lm_admit_slot` prefills a request into one of them at its
own positions ``arange(L0)``, so the admitted row decodes as its solo run
whatever the other rows have done.  Streaming text (bistream):
:class:`Qwen2StreamDecoder` feeds segments of embeddings into one
fixed-capacity cache and :func:`qwen2lm_inference_bistream` interleaves text
and speech on the host (llm.py:513-611).

Training (llm.py:304-425): :func:`qwen2lm_forward_train` and
:func:`qwen2lm_forward_dpo` build the ragged uni/bistream sequences densely
from integer index maps, both layouts for every row, and pick one per row by
the reference's coin (p 0.5, and only where speech/text exceeds the mix
ratio); the coin is an argument, so a test passes JAX's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ctx import Ctx
from ..layers.basic import dense, embedding
from ..layers.qwen2 import (Qwen2Config, qwen2_forward, qwen2_layer, qwen2_spec, rms_norm,
                            rope_cos_sin)
from ..ops import masks as M
from ..ops import sampling as S
from ..ops.sampling import ras_sample
from ..parallel.mesh import draw_rows
from ..params import P, ParamTree, Spec, resolve_device
from .decode import Columns, DeviceDecode
from .llm import IGNORE_ID, label_smoothing_loss, th_accuracy


@dataclass(frozen=True)
class Qwen2LMConfig:
    llm_input_size: int = 896
    llm_output_size: int = 896
    speech_token_size: int = 6561  # CosyVoice2 FSQ speech tokens
    sos_eos: int = 0
    task_id: int = 1
    fill_token: int = 2
    mix_ratio: Tuple[int, int] = (5, 15)
    length_normalized_loss: bool = True
    lsm_weight: float = 0.0
    qwen: Qwen2Config = field(default_factory=Qwen2Config)


def qwen2lm_prefix(p: P, cfg: Qwen2LMConfig, text_tokens: torch.Tensor,
                   prompt_speech_token: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1, L0, D) decode prefix [sos, text, task, prompt speech] (no speaker
    row in CosyVoice2; llm.py:427-462)."""
    emb = p["llm_embedding.weight"]
    parts = [emb[cfg.sos_eos][None, None],
             embedding(p.sub("llm.model.model"), "embed_tokens", text_tokens),
             emb[cfg.task_id][None, None]]
    if prompt_speech_token is not None and prompt_speech_token.numel():
        parts.append(embedding(p, "speech_embedding", prompt_speech_token)
                     .reshape(1, -1, cfg.llm_input_size))
    return torch.cat(parts, dim=1)


def _gather(emb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """emb (B, L, D) rows at idx (B, S) -> (B, S, D)."""
    return torch.gather(emb, 1, idx[:, :, None].expand(-1, -1, emb.shape[2]))


def _pick(conds, values, default):
    """Nested where: the value of the first true condition, else default."""
    out = default
    for c, v in reversed(list(zip(conds, values))):
        out = torch.where(c, v, out)
    return out


def _pack_unistream(cfg: "Qwen2LMConfig", pos, tl, sl, text_emb, speech_emb, speech_tok,
                    sos, task):
    """input [sos, text, task, speech]; target [IGN x (1 + tl), speech, EOS]
    (llm.py:335-338).  pos (1, S), tl / sl (B, 1)."""
    B = tl.shape[0]
    pos = pos.expand(B, -1)
    t_idx = torch.clamp(pos - 1, 0, text_emb.shape[1] - 1)
    s_idx = torch.clamp(pos - 2 - tl, 0, speech_emb.shape[1] - 1)
    zero = torch.zeros((), dtype=text_emb.dtype, device=text_emb.device)
    lm_input = _pick(
        [(pos == 0)[..., None], ((pos >= 1) & (pos < 1 + tl))[..., None],
         (pos == 1 + tl)[..., None], ((pos > 1 + tl) & (pos < 2 + tl + sl))[..., None]],
        [sos, _gather(text_emb, t_idx), task, _gather(speech_emb, s_idx)], zero)
    g_tok = torch.gather(speech_tok, 1, torch.clamp(pos - 1 - tl, 0, speech_tok.shape[1] - 1))
    lm_target = _pick([(pos >= 1 + tl) & (pos < 1 + tl + sl), pos == 1 + tl + sl],
                      [g_tok, torch.full_like(g_tok, cfg.speech_token_size)],
                      torch.full_like(g_tok, IGNORE_ID))
    return lm_input, lm_target, (2 + tl + sl)[:, 0]


def _pack_bistream(cfg: "Qwen2LMConfig", pos, tl, sl, text_emb, speech_emb, speech_tok,
                   sos, task):
    """Interleaved [m0 text | m1 speech] blocks with FILL targets, then the
    partial tail [text_rest, task, speech_rest] (llm.py:312-333)."""
    B = tl.shape[0]
    pos = pos.expand(B, -1)
    m0, m1 = cfg.mix_ratio
    blk = m0 + m1
    n_full = tl // m0
    q = pos - 1
    block, off = torch.div(q, blk, rounding_mode="floor"), torch.remainder(q, blk)
    in_blocks = (pos >= 1) & (block < n_full)
    r = pos - (1 + blk * n_full)
    t_rest, s_rest = tl - m0 * n_full, sl - m1 * n_full

    blk_is_text = in_blocks & (off < m0)
    tail_is_text = (r >= 0) & (r < t_rest)
    tail_is_task = r == t_rest
    tail_is_speech = (r > t_rest) & (r < t_rest + 1 + s_rest)
    t_idx = torch.clamp(torch.where(blk_is_text, block * m0 + off, m0 * n_full + r),
                        0, text_emb.shape[1] - 1)
    s_idx = torch.clamp(torch.where(in_blocks, block * m1 + (off - m0),
                                    m1 * n_full + r - t_rest - 1), 0, speech_emb.shape[1] - 1)
    zero = torch.zeros((), dtype=text_emb.dtype, device=text_emb.device)
    lm_input = _pick(
        [(pos == 0)[..., None], (blk_is_text | tail_is_text)[..., None],
         tail_is_task[..., None], ((in_blocks & (off >= m0)) | tail_is_speech)[..., None]],
        [sos, _gather(text_emb, t_idx), task, _gather(speech_emb, s_idx)], zero)

    # a full block: off 0..m0-2 ignored, m0-1..m0+m1-2 speech, the last FILL;
    # the tail: t_rest ignored, then s_rest speech, then EOS
    blk_tgt_speech = in_blocks & (off >= m0 - 1) & (off < m0 - 1 + m1)
    tail_tgt_speech = (r >= t_rest) & (r < t_rest + s_rest)
    tgt_sidx = torch.clamp(torch.where(in_blocks, block * m1 + (off - (m0 - 1)),
                                       m1 * n_full + r - t_rest), 0, speech_tok.shape[1] - 1)
    g_tok = torch.gather(speech_tok, 1, tgt_sidx)
    lm_target = _pick(
        [in_blocks & (off == blk - 1), blk_tgt_speech | tail_tgt_speech,
         (r == t_rest + s_rest) & (pos > 0)],
        [torch.full_like(g_tok, cfg.speech_token_size + 2), g_tok,
         torch.full_like(g_tok, cfg.speech_token_size)],
        torch.full_like(g_tok, IGNORE_ID))
    return lm_input, lm_target, (2 + tl + sl)[:, 0]


def _packed(p: P, cfg: "Qwen2LMConfig", text_token, tl_vec, speech_token, sl_vec, use_coin):
    """(lm_input, lm_target, lm_len) of rows packed uni- or bistream:
    bistream where ``use_coin`` and speech/text exceeds the mix ratio."""
    qp = p.sub("llm.model.model")
    text_emb = embedding(qp, "embed_tokens", text_token)
    speech_emb = embedding(p, "speech_embedding", torch.clamp(speech_token, min=0))
    S = 2 + text_token.shape[1] + speech_token.shape[1]
    pos = torch.arange(S, device=text_token.device)[None, :]
    tl, sl = tl_vec[:, None], sl_vec[:, None]
    sos = p["llm_embedding.weight"][cfg.sos_eos].to(text_emb.dtype)[None, None]
    task = p["llm_embedding.weight"][cfg.task_id].to(text_emb.dtype)[None, None]
    args = (pos, tl, sl, text_emb, speech_emb, speech_token, sos, task)
    uni, bi = _pack_unistream(cfg, *args), _pack_bistream(cfg, *args)
    use_bi = use_coin & (sl_vec * cfg.mix_ratio[0] > tl_vec * cfg.mix_ratio[1])
    return (torch.where(use_bi[:, None, None], bi[0], uni[0]),
            torch.where(use_bi[:, None], bi[1], uni[1]), uni[2])


def _coin(B: int, coin, generator, device) -> torch.Tensor:
    """The (B,) uni/bistream coin: the given one, one drawn from
    ``generator`` (uniform < 0.5), or all False (unistream)."""
    if coin is not None:
        return torch.as_tensor(coin, device=device).bool()
    if generator is not None:
        return draw_rows(lambda s: torch.rand(s, generator=generator, device=device), (B,)) < 0.5
    return torch.zeros((B,), dtype=torch.bool, device=device)


def qwen2lm_forward_train(p: P, cfg: "Qwen2LMConfig", batch: Dict[str, torch.Tensor], ctx: Ctx,
                          generator: Optional[torch.Generator] = None,
                          coin: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Training forward (llm.py:346-378) -> {'loss', 'acc'}.  ``coin`` (B,)
    bool picks bistream rows; else drawn from ``generator``; neither forces
    unistream."""
    text_token = batch["text_token"].long()
    speech_token = batch["speech_token"].long()
    tl_vec, sl_vec = batch["text_token_len"].long(), batch["speech_token_len"].long()
    use = _coin(text_token.shape[0], coin, generator, text_token.device)
    lm_input, lm_target, lm_len = _packed(p, cfg, text_token, tl_vec, speech_token, sl_vec, use)
    hidden = qwen2_forward(p.sub("llm.model.model"), cfg.qwen, lm_input, lm_len, ctx)
    logits = dense(p, "llm_decoder", hidden, ctx)
    loss = label_smoothing_loss(logits, lm_target, cfg.lsm_weight, cfg.length_normalized_loss)
    return {"loss": loss, "acc": th_accuracy(logits, lm_target)}


def qwen2lm_forward_dpo(p: P, cfg: "Qwen2LMConfig", batch: Dict[str, torch.Tensor], ctx: Ctx,
                        generator: Optional[torch.Generator] = None,
                        coin: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """DPO forward (llm.py:380-425): chosen and rejected continuations in one
    batch of 2B rows (each pair packed by the same coin) -> the chosen rows'
    loss and accuracy and per-row mean target log-probs for ``dpo_loss``."""
    B = batch["text_token"].shape[0]
    text_token = torch.cat([batch["text_token"]] * 2).long()
    tl_vec = torch.cat([batch["text_token_len"]] * 2).long()
    speech_token = torch.cat([batch["speech_token"].long(),
                              batch["reject_speech_token"].long()])
    sl_vec = torch.cat([batch["speech_token_len"], batch["reject_speech_token_len"]]).long()
    use = _coin(B, coin, generator, text_token.device).repeat(2)
    lm_input, lm_target, lm_len = _packed(p, cfg, text_token, tl_vec, speech_token, sl_vec, use)
    hidden = qwen2_forward(p.sub("llm.model.model"), cfg.qwen, lm_input, lm_len, ctx)
    logits = dense(p, "llm_decoder", hidden, ctx)
    chosen, rejected = logits[:B], logits[B:]
    loss = label_smoothing_loss(chosen, lm_target[:B], cfg.lsm_weight,
                                cfg.length_normalized_loss)

    def mean_logps(lg, tgt):
        # the reference averages log-probs over the IGNORE mask, an
        # acknowledged quirk (llm.py:419-424) kept for parity
        mask = tgt == IGNORE_ID
        logp = torch.log_softmax(lg.float(), dim=-1)
        tok = torch.gather(logp, 2, torch.where(mask, 0, tgt)[:, :, None])[:, :, 0]
        return (tok * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1)

    return {"loss": loss, "acc": th_accuracy(chosen, lm_target[:B]),
            "chosen_logps": mean_logps(chosen, lm_target[:B]),
            "rejected_logps": mean_logps(rejected, lm_target[B:])}


@dataclass
class Qwen2Cache:
    """Fixed-capacity GQA caches of B rows: row b's valid prefix keys sit at
    columns ``[start[b], L0)`` and attempt a's key at column ``L0 + a``."""
    k: torch.Tensor  # (nl, B, KV, S, d)
    v: torch.Tensor  # (nl, B, KV, S, d)
    start: torch.Tensor  # (B,) long


def _empty_cache(cfg: Qwen2LMConfig, B: int, capacity: int, dtype, device) -> Qwen2Cache:
    q = cfg.qwen
    shape = (q.num_hidden_layers, B, q.num_key_value_heads, capacity, q.head_dim)
    return Qwen2Cache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros((B,), dtype=torch.long, device=device))


def _prefilled_cache(p: P, cfg: Qwen2LMConfig, prefix_emb: torch.Tensor,
                     valid: Sequence[int], capacity: int):
    """Prefill B LEFT-padded prefixes (``valid[b]`` real rows each) into a
    cache of ``capacity`` columns at positions ``arange(L0)``: (the logits
    of each row's first attempt (B, V), cache)."""
    q = cfg.qwen
    B, L0 = prefix_emb.shape[:2]
    dt, dev = prefix_emb.dtype, prefix_emb.device
    cache = _empty_cache(cfg, B, capacity, dt, dev)
    cache.start = torch.tensor([L0 - v for v in valid], device=dev)
    kq = torch.arange(L0, device=dev)
    vis = (kq[None, None, :] <= kq[None, :, None]) & (kq[None, None, :] >= cache.start[:, None, None])
    bias = torch.where(vis, 0.0, M.NEG_BIAS).to(dt)
    qp = p.sub("llm.model.model")
    rope = rope_cos_sin(kq, q.head_dim, q.rope_theta)
    h = prefix_emb
    for i in range(q.num_hidden_layers):
        h = qwen2_layer(qp.sub(f"layers.{i}"), q, h, kq, bias,
                        kv_cache=(cache.k[i, :, :, :L0], cache.v[i, :, :, :L0]), cache_index=0,
                        rope=rope)
    h = rms_norm(qp, "norm", h, q.rms_norm_eps)
    return dense(p, "llm_decoder", h[:, -1]), cache


def qwen2lm_decode_step(p: P, cfg: Qwen2LMConfig, cache: Qwen2Cache, tokens,
                        cols) -> torch.Tensor:
    """Feed row b's token ``tokens[b]`` at cache column and RoPE position
    ``cols[b]``; returns every row's next logits (B, V).  The step reads
    only the columns ``[0, max(cols) + 1)``, or ``[0, cols.width)`` for
    device columns: the -1e10 bias past a row's column adds exact zeros to
    its softmax.  ``tokens`` and ``cols`` are host sequences, or a (B,)
    long tensor and :class:`~.decode.Columns` on the cache's device (no
    host read)."""
    q = cfg.qwen
    dev = cache.k.device
    if not isinstance(cols, Columns):
        cols = Columns(torch.tensor(list(cols), device=dev), max(cols) + 1)
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.tensor(list(tokens), device=dev)
    W, col = cols.width, cols.at
    kpos = torch.arange(W, device=dev)
    live = (kpos[None, :] >= cache.start[:, None]) & (kpos[None, :] <= col[:, None])
    bias = torch.where(live, 0.0, M.NEG_BIAS).to(cache.k.dtype)[:, None, :]  # (B, 1, W)
    ids = tokens[:, None]
    h = embedding(p, "speech_embedding", ids).to(cache.k.dtype)  # (B, 1, D)
    qp = p.sub("llm.model.model")
    rope = rope_cos_sin(col[:, None], q.head_dim, q.rope_theta)  # once for every layer
    for i in range(q.num_hidden_layers):
        h = qwen2_layer(qp.sub(f"layers.{i}"), q, h, col[:, None], bias,
                        kv_cache=(cache.k[i, :, :, :W], cache.v[i, :, :, :W]), cache_index=col,
                        rope=rope)
    h = rms_norm(qp, "norm", h, q.rms_norm_eps)
    return dense(p, "llm_decoder", h[:, -1])


def qwen2lm_teacher_forced_logits(p: P, cfg: Qwen2LMConfig, prefix_emb: torch.Tensor,
                                  valid: Sequence[int], tokens: Sequence[Sequence[int]]
                                  ) -> torch.Tensor:
    """(B, n + 1, V) logits of B LEFT-padded prefixes fed the given tokens
    (B rows of n, one attempt each) through the prefill and the steps."""
    B, L0 = prefix_emb.shape[:2]
    n = len(tokens[0])
    logits, cache = _prefilled_cache(p, cfg, prefix_emb, valid, L0 + n)
    out = [logits]
    for j in range(n):
        out.append(qwen2lm_decode_step(p, cfg, cache, [row[j] for row in tokens],
                                       [L0 + j] * B))
    return torch.stack(out, 1)


class Qwen2DecodeState(DeviceDecode):
    """A resumable AR decode of B rows on the device (the JAX package's
    solo decode state and ``BatchDecodeState`` in one; ``models.decode``).
    Each row keeps its emitted tokens, its attempt count (which drives its
    cache column), its EOS floor, cap and CPU generator; a row that sampled
    EOS or made ``cap`` attempts is frozen.  ``run(stop_at)`` pauses when
    the loop-step counter ``i`` reaches ``stop_at``."""

    fill_ids = True

    def __init__(self, p: P, cfg: Qwen2LMConfig, cache: Qwen2Cache, L0: int,
                 sampling: Tuple[float, int, int, float]):
        super().__init__(L0, cache.k.shape[1], cache.k.shape[3], cache.k.device,
                         cfg.speech_token_size, sampling)
        self.p, self.cfg, self.cache = p, cfg, cache

    def _host_rule(self):
        return None if ras_sample is S.ras_sample else ras_sample

    def _logits(self, tokens, cols):
        return qwen2lm_decode_step(self.p, self.cfg, self.cache, tokens, cols)


def qwen2lm_decode_start(p: P, cfg: Qwen2LMConfig, prefix_emb: torch.Tensor,
                         valid: Sequence[int], min_lens: Sequence[int], caps: Sequence[int],
                         generators: Sequence[Optional[torch.Generator]],
                         top_p: float = 0.8, top_k: int = 25, win_size: int = 10,
                         tau_r: float = 0.1) -> Qwen2DecodeState:
    """Prefill B LEFT-padded prefixes (B, L0, D) and sample every row's
    first attempt on the device: a :class:`Qwen2DecodeState` paused after
    step 0, with ``max(caps)`` attempt columns a row."""
    B, L0 = prefix_emb.shape[:2]
    if min(caps) < 1:
        raise ValueError(f"every cap must be >= 1, got {list(caps)}")
    logits, cache = _prefilled_cache(p, cfg, prefix_emb, valid, L0 + max(caps))
    state = Qwen2DecodeState(p, cfg, cache, L0, (top_p, top_k, win_size, tau_r))
    state._reset(slice(None), min_lens, caps, generators)
    state._first(logits, slice(None))
    return state


def qwen2lm_decode_idle(p: P, cfg: Qwen2LMConfig, slots: int, L0: int, max_len: int, dtype,
                       device, top_p: float = 0.8, top_k: int = 25, win_size: int = 10,
                       tau_r: float = 0.1) -> Qwen2DecodeState:
    """A :class:`Qwen2DecodeState` of ``slots`` free rows (all done), prefix
    width L0 and ``max_len`` attempt columns in EVERY row, for
    :func:`qwen2lm_admit_slot` to fill: a row admitted later may carry any
    cap up to ``max_len``, whatever the rows before it asked for."""
    return Qwen2DecodeState(p, cfg, _empty_cache(cfg, slots, L0 + max_len, dtype, device), L0,
                            (top_p, top_k, win_size, tau_r))


def qwen2lm_admit_slot(state: Qwen2DecodeState, prefix_emb: torch.Tensor, valid: int,
                       min_len: int, cap: int, generator: Optional[torch.Generator],
                       slot: int) -> None:
    """Admit one request into row ``slot`` of a paused state (the
    continuous-batching join, the JAX package's ``qwen2lm_admit_slot``):
    prefill its (1, L0, D) LEFT-padded prefix (``valid`` real rows) at
    positions ``arange(L0)`` into the row's own columns, exactly as its solo
    prefill, and sample its first attempt on the device from ITS OWN
    generator (ids above EOS masked; EOS masked while ``min_len`` > 0).
    ``state.i`` is untouched."""
    if prefix_emb.shape[1] != state.L0 or not 1 <= cap <= state.max_len:
        raise ValueError(f"prefix width {prefix_emb.shape[1]} (state {state.L0}) or cap "
                         f"{cap} (state {state.max_len}) does not fit")
    L0 = state.L0
    logits, cache = _prefilled_cache(state.p, state.cfg, prefix_emb, [valid], L0)
    state.cache.k[:, slot, :, :L0] = cache.k[:, 0]
    state.cache.v[:, slot, :, :L0] = cache.v[:, 0]
    state.cache.start[slot] = L0 - valid
    sl = slice(slot, slot + 1)
    state._reset(sl, [min_len], [cap], [generator])
    state._first(logits, sl)


def qwen2lm_decode(p: P, cfg: Qwen2LMConfig, prefix_emb: torch.Tensor, min_len: int,
                   max_len: int, top_p: float = 0.8, top_k: int = 25, win_size: int = 10,
                   tau_r: float = 0.1, generator: Optional[torch.Generator] = None) -> List[int]:
    """Solo decode of up to ``max_len`` attempts: one uninterrupted run."""
    return qwen2lm_decode_start(p, cfg, prefix_emb, [prefix_emb.shape[1]], [min_len],
                                [max_len], [generator], top_p, top_k, win_size,
                                tau_r).run().tokens[0]


def qwen2lm_decode_batch(p: P, cfg: Qwen2LMConfig, prefix_emb: torch.Tensor,
                         valid: Sequence[int], min_lens: Sequence[int], caps: Sequence[int],
                         generators: Sequence[Optional[torch.Generator]],
                         **sampling) -> List[List[int]]:
    """B LEFT-padded prefixes decoded in lock step: row b's tokens are those
    of a solo decode with ``generators[b]``."""
    return qwen2lm_decode_start(p, cfg, prefix_emb, valid, min_lens, caps, generators,
                                **sampling).run().tokens


class Qwen2StreamDecoder:
    """Incremental decoder for streaming-text (bistream) inference: one
    fixed-capacity GQA cache; :meth:`advance` feeds a segment of input
    embeddings at the next positions and returns the last one's logits.
    The bistream control flow (llm.py:513-611) runs on the host in
    :func:`qwen2lm_inference_bistream`."""

    def __init__(self, p: P, cfg: Qwen2LMConfig, capacity: int = 2048,
                 dtype=torch.float32, device=None):
        self.p, self.cfg, self.capacity = p, cfg, capacity
        dev = p["llm_embedding.weight"].device if device is None else torch.device(device)
        self.cache = _empty_cache(cfg, 1, capacity, dtype, dev)
        self.L = 0

    def advance(self, emb: torch.Tensor) -> torch.Tensor:
        """Feed (1, n, D) embeddings at positions ``[L, L + n)``; returns the
        logits (V,) after the last of them.  Only the live columns
        ``[0, L + n)`` are read: the keys past them add exact zeros."""
        n = emb.shape[1]
        if self.L + n > self.capacity:
            # a write past the cache would corrupt it while the positions
            # keep advancing: fail loudly instead
            raise ValueError(f"bistream sequence overflows the decoder capacity: "
                             f"{self.L} + {n} > {self.capacity}")
        q = self.cfg.qwen
        k_buf, v_buf = self.cache.k, self.cache.v
        dev, dt = k_buf.device, k_buf.dtype
        W = self.L + n
        positions = torch.arange(self.L, W, device=dev)
        kpos = torch.arange(W, device=dev)
        bias = torch.where(kpos[None, :] <= positions[:, None], 0.0, M.NEG_BIAS).to(dt)[None]
        rope = rope_cos_sin(positions, q.head_dim, q.rope_theta)
        qp = self.p.sub("llm.model.model")
        h = emb.to(dt)
        for i in range(q.num_hidden_layers):
            h = qwen2_layer(qp.sub(f"layers.{i}"), q, h, positions, bias,
                            kv_cache=(k_buf[i, :, :, :W], v_buf[i, :, :, :W]),
                            cache_index=self.L, rope=rope)
        h = rms_norm(qp, "norm", h, q.rms_norm_eps)
        self.L = W
        return dense(self.p, "llm_decoder", h[0, -1])


def qwen2lm_inference_bistream(
    p: P,
    cfg: Qwen2LMConfig,
    text_chunks: Iterable,  # (1, n) int arrays: the text tokens as they arrive
    prompt_text=None,  # (1, Tp)
    prompt_speech_token=None,  # (1, Ts)
    top_p: float = 0.8,
    top_k: int = 25,
    win_size: int = 10,
    tau_r: float = 0.1,
    capacity: int = 2048,
    max_tokens: int = 100000,
    generator: Optional[torch.Generator] = None,
) -> Iterator[int]:
    """Streaming-text generator yielding speech tokens as text arrives
    (llm.py:513-611 inference_bistream): while prompt speech remains, text
    and prompt speech are fed in blocks of ``mix_ratio`` = (text, speech);
    then every ``mix_ratio[0]`` text tokens the model speaks until it emits
    the fill token, after which the reference forces a fill every
    ``mix_ratio[1] + 1`` tokens (``next_fill_index``); once the text ends,
    the rest of it and the task token are fed and the decode runs to EOS.
    Sampling runs on the host from ``generator`` (a CPU generator), one RAS
    draw an attempt over the tokens so far (fill tokens included)."""
    m0, m1 = cfg.mix_ratio
    eos = cfg.speech_token_size
    fill = cfg.speech_token_size + 2
    dev = p["llm_embedding.weight"].device
    qp = p.sub("llm.model.model")

    def ids(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=dev).reshape(1, -1)

    def embed_text(x):
        return embedding(qp, "embed_tokens", ids(x))

    def embed_speech(x):
        return embedding(p, "speech_embedding", ids(x))

    dec = Qwen2StreamDecoder(p, cfg, capacity, p["llm_embedding.weight"].dtype, dev)
    sos = p["llm_embedding.weight"][cfg.sos_eos][None, None]
    task = p["llm_embedding.weight"][cfg.task_id][None, None]
    empty = torch.zeros((1, 0, cfg.llm_input_size), dtype=sos.dtype, device=dev)

    pending = [sos]  # embeddings not yet fed
    text_cache = embed_text(prompt_text) if prompt_text is not None and np.size(prompt_text) \
        else empty
    speech_cache = embed_speech(prompt_speech_token) \
        if prompt_speech_token is not None and np.size(prompt_speech_token) else empty
    out_tokens: List[int] = []
    next_fill_index = -1

    def sample(logits, ignore_eos):
        # the reference raises on sampling eos + 1 (llm.py:585-589) and on
        # fill in the final loop; masking those ids at the sampler is the
        # same for a trained model, which never emits them there
        logp = torch.log_softmax(logits.float(), dim=-1).cpu()
        logp[eos + 1] = -math.inf
        logp[eos if ignore_eos else fill] = -math.inf
        return int(ras_sample(logp, out_tokens, top_p, top_k, win_size, tau_r,
                              generator=generator))

    def flush_pending():
        nonlocal pending
        if not pending:
            return None
        seg, pending = torch.cat(pending, dim=1), []
        return dec.advance(seg)

    for chunk in text_chunks:
        text_cache = torch.cat([text_cache, embed_text(chunk)], dim=1)
        # interleave [m0 text | m1 speech] while prompt speech remains
        while speech_cache.shape[1] != 0 and text_cache.shape[1] >= m0:
            pending += [text_cache[:, :m0], speech_cache[:, :m1]]
            text_cache, speech_cache = text_cache[:, m0:], speech_cache[:, m1:]
        if speech_cache.shape[1] != 0:
            continue  # more text is needed to pair with the prompt speech left
        # a text block comes before decoding after a fill (or at the start)
        need_text = (out_tokens and out_tokens[-1] == fill) or \
                    (not out_tokens and len(pending) == 1 and dec.L == 0)
        if need_text:
            if text_cache.shape[1] < m0:
                continue
            if out_tokens and out_tokens[-1] == fill:
                pending = [text_cache[:, :m0]]
            else:
                pending.append(text_cache[:, :m0])
            text_cache = text_cache[:, m0:]
        while True:
            logits = flush_pending()
            if logits is None:
                logits = dec.advance(embed_speech([out_tokens[-1]]))
            if next_fill_index != -1 and len(out_tokens) == next_fill_index:
                tok = fill
                next_fill_index += m1 + 1
            else:
                tok = sample(logits, ignore_eos=True)
            if tok == fill:
                next_fill_index = len(out_tokens) + m1 + 1
            out_tokens.append(tok)
            if tok >= eos:
                if tok == fill:
                    break
                raise ValueError(f"should not get token {tok}")
            yield tok
            pending = [embed_speech([tok])]

    # the final decode: the rest of the text and the task token, until EOS
    if text_cache.shape[1]:
        pending.append(text_cache)
    pending.append(task)
    while len(out_tokens) < max_tokens and dec.L < capacity - 2:
        logits = flush_pending()
        if logits is None:
            logits = dec.advance(embed_speech([out_tokens[-1]]))
        tok = sample(logits, ignore_eos=False)
        out_tokens.append(tok)
        if tok >= eos:
            if tok == eos:
                break
            raise ValueError(f"should not get token {tok}")
        yield tok
        pending = [embed_speech([tok])]


class Qwen2LM(ParamTree):
    """Qwen2LM weights (CosyVoice2 llm.pt names)."""

    def __init__(self, cfg: Qwen2LMConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(qwen2lm_spec(cfg), device, dtype, generator)
        self.cfg = cfg


def qwen2lm_spec(cfg: Qwen2LMConfig) -> Spec:
    """Names and shapes of the JAX package's ``init_qwen2lm_params``."""
    spec = qwen2_spec(Spec(), cfg.qwen, prefix="llm.model.model")
    spec.embedding("llm_embedding", 2, cfg.llm_input_size)
    spec.linear("llm_decoder", cfg.llm_output_size, cfg.speech_token_size + 3)
    spec.embedding("speech_embedding", cfg.speech_token_size + 3, cfg.llm_input_size)
    return spec


def init_qwen2lm_params(cfg: Qwen2LMConfig, device=None, dtype=torch.float32,
                        seed: int = 0) -> Qwen2LM:
    """A randomly initialized :class:`Qwen2LM` built directly on ``device``."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    return Qwen2LM(cfg, dev, dtype, gen)
