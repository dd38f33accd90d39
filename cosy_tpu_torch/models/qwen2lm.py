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
logits are those of its unpadded run.  Sampling runs on the host with each
row's own CPU ``torch.Generator`` (two uniforms an attempt).

The reference's fill-token rule (llm.py:504-507): a sampled id above EOS is
neither stored nor fed back, but the attempt still feeds the previous token
at the next cache column, so attempts and emitted tokens count apart; the
EOS floor (``min_len``) counts attempts.  The first attempt masks every id
above EOS (there is no previous token to re-feed).  A row stops at EOS or
after ``cap`` attempts, which is the JAX solo decode's bound (its batched
decode bounds attempts by the bucketed capacity instead, which differs only
for a row that skips fill tokens and reaches its cap).

Left out here: the training forwards (``qwen2lm_forward_train`` /
``_dpo``), the bistream decoder and slot admission.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

from ..layers.basic import dense, embedding
from ..layers.qwen2 import Qwen2Config, qwen2_layer, qwen2_spec, rms_norm, rope_cos_sin
from ..ops import masks as M
from ..ops.sampling import ras_sample
from ..params import P, ParamTree, Spec, resolve_device


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


@dataclass
class Qwen2Cache:
    """Fixed-capacity GQA caches of B rows: row b's valid prefix keys sit at
    columns ``[start[b], L0)`` and attempt a's key at column ``L0 + a``."""
    k: torch.Tensor  # (nl, B, KV, S, d)
    v: torch.Tensor  # (nl, B, KV, S, d)
    start: torch.Tensor  # (B,) long


def _prefilled_cache(p: P, cfg: Qwen2LMConfig, prefix_emb: torch.Tensor,
                     valid: Sequence[int], capacity: int):
    """Prefill B LEFT-padded prefixes (``valid[b]`` real rows each) into a
    cache of ``capacity`` columns at positions ``arange(L0)``: (the logits
    of each row's first attempt (B, V), cache)."""
    q = cfg.qwen
    B, L0 = prefix_emb.shape[:2]
    dt, dev = prefix_emb.dtype, prefix_emb.device
    shape = (q.num_hidden_layers, B, q.num_key_value_heads, capacity, q.head_dim)
    cache = Qwen2Cache(torch.zeros(shape, dtype=dt, device=dev),
                       torch.zeros(shape, dtype=dt, device=dev),
                       torch.tensor([L0 - v for v in valid], device=dev))
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


def qwen2lm_decode_step(p: P, cfg: Qwen2LMConfig, cache: Qwen2Cache, tokens: Sequence[int],
                        cols: Sequence[int]) -> torch.Tensor:
    """Feed row b's token ``tokens[b]`` at cache column and RoPE position
    ``cols[b]``; returns every row's next logits (B, V).  The step reads
    only the live columns ``[0, max(cols) + 1)``: the -1e10 bias past a
    row's column adds exact zeros to its softmax."""
    q = cfg.qwen
    dev = cache.k.device
    B, W = len(tokens), max(cols) + 1
    col = torch.tensor(list(cols), device=dev)
    kpos = torch.arange(W, device=dev)
    live = (kpos[None, :] >= cache.start[:, None]) & (kpos[None, :] <= col[:, None])
    bias = torch.where(live, 0.0, M.NEG_BIAS).to(cache.k.dtype)[:, None, :]  # (B, 1, W)
    ids = torch.tensor(list(tokens), device=dev)[:, None]
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


@dataclass
class Qwen2DecodeState:
    """A resumable AR decode of B rows (the JAX package's solo decode state
    and ``BatchDecodeState`` in one).  Each row keeps its emitted tokens, its
    attempt count (which drives its cache column), its EOS floor, cap and
    CPU generator; a row that sampled EOS or made ``cap`` attempts is
    frozen.  ``run(stop_at)`` pauses when the loop-step counter ``i``
    reaches ``stop_at``."""
    p: P
    cfg: Qwen2LMConfig
    cache: Qwen2Cache
    L0: int
    tokens: List[List[int]]
    attempts: List[int]
    last: List[int]
    done: List[bool]
    min_lens: List[int]
    caps: List[int]
    generators: List[Optional[torch.Generator]]
    sampling: Tuple[float, int, int, float]  # top_p, top_k, win_size, tau_r
    i: int = 1  # loop steps so far (the prefill's sample is step 0)

    def _sample(self, b: int, logits: torch.Tensor):
        eos = self.cfg.speech_token_size
        a = self.attempts[b]
        logits = logits.float().clone()
        if a == 0:
            logits[eos + 1:] = -math.inf
        logp = torch.log_softmax(logits, dim=-1)
        if a < self.min_lens[b]:
            logp[eos] = -math.inf
        tok = ras_sample(logp, self.tokens[b], *self.sampling, generator=self.generators[b])
        self.attempts[b] = a + 1
        if tok == eos:
            self.done[b] = True
            return
        if tok < eos:
            self.tokens[b].append(tok)
            self.last[b] = tok
        self.done[b] = self.attempts[b] >= self.caps[b]

    def run(self, stop_at: Optional[int] = None) -> "Qwen2DecodeState":
        """Step until every row is done or ``i`` reaches ``stop_at``.  A
        frozen row is fed at column L0 - 1 and its output dropped."""
        while not all(self.done) and (stop_at is None or self.i < stop_at):
            cols = [self.L0 - 1 if d else self.L0 + a - 1
                    for a, d in zip(self.attempts, self.done)]
            live = [b for b, d in enumerate(self.done) if not d]
            logits = qwen2lm_decode_step(self.p, self.cfg, self.cache, self.last,
                                         cols).float().cpu()
            for b in live:
                self._sample(b, logits[b])
            self.i += 1
        return self


def qwen2lm_decode_start(p: P, cfg: Qwen2LMConfig, prefix_emb: torch.Tensor,
                         valid: Sequence[int], min_lens: Sequence[int], caps: Sequence[int],
                         generators: Sequence[Optional[torch.Generator]],
                         top_p: float = 0.8, top_k: int = 25, win_size: int = 10,
                         tau_r: float = 0.1) -> Qwen2DecodeState:
    """Prefill B LEFT-padded prefixes (B, L0, D) and sample every row's
    first attempt: a :class:`Qwen2DecodeState` paused after step 0, with
    ``max(caps)`` attempt columns a row."""
    B, L0 = prefix_emb.shape[:2]
    if min(caps) < 1:
        raise ValueError(f"every cap must be >= 1, got {list(caps)}")
    logits, cache = _prefilled_cache(p, cfg, prefix_emb, valid, L0 + max(caps))
    state = Qwen2DecodeState(p, cfg, cache, L0, [[] for _ in range(B)], [0] * B, [0] * B,
                             [False] * B, list(min_lens), list(caps), list(generators),
                             (top_p, top_k, win_size, tau_r))
    logits = logits.float().cpu()
    for b in range(B):
        state._sample(b, logits[b])
    return state


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
