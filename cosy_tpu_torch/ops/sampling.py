"""Token sampling for the AR decode (the port of the JAX package's
``ops/sampling.py``): nucleus and repetition-aware (RAS) sampling.

Each draw is an inverse-CDF lookup of one uniform in [0, 1), taken from an
explicit ``torch.Generator`` or injected (``u``) so tests can hand the same
numbers to a reference statement of the rule.

:func:`ras_sample_batch` is the decode's sampler: B rows on device tensors
with static shapes and no host read (the JAX package's
``cosy_tpu/ops/sampling.py:14-62``, which samples inside its
``lax.while_loop``).  Row b gives the id that :func:`ras_sample` gives for
the same log-probs, history and uniforms.  The host functions stay for the
bistream decode, which interleaves text and speech on the host.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _draw(generator: Optional[torch.Generator]) -> float:
    return float(torch.rand((), generator=generator))


def _pick(weights: torch.Tensor, u: float) -> int:
    """Index i of the first cumulative share above u (weights >= 0)."""
    cdf = torch.cumsum(weights.double(), 0)
    i = int((cdf <= u * cdf[-1]).sum())
    return min(i, weights.shape[0] - 1)


def nucleus_sample(logits: torch.Tensor, top_p: float = 0.8, top_k: int = 25,
                   u: Optional[float] = None,
                   generator: Optional[torch.Generator] = None) -> int:
    """Sample from the top-p / top-k head of softmax(logits), (V,) -> id.

    Token i in descending-probability order is kept iff the cumulative
    probability before it is < top_p and it is among the top_k."""
    probs = torch.softmax(logits.float().cpu(), dim=-1)
    top_vals, top_idx = torch.topk(probs, min(top_k, probs.shape[-1]))
    cum_before = torch.cumsum(top_vals, 0) - top_vals
    kept = torch.where(cum_before < top_p, top_vals, 0.0)
    return int(top_idx[_pick(kept, _draw(generator) if u is None else u)])


def random_sample(logits: torch.Tensor, u: Optional[float] = None,
                  generator: Optional[torch.Generator] = None) -> int:
    """Sample from the full softmax(logits)."""
    probs = torch.softmax(logits.float().cpu(), dim=-1)
    return _pick(probs, _draw(generator) if u is None else u)


def ras_sample(
    logits: torch.Tensor,  # (V,) log-probs or logits
    decoded: Sequence[int],  # tokens decoded so far
    top_p: float = 0.8,
    top_k: int = 25,
    win_size: int = 10,
    tau_r: float = 0.1,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[float]] = None,  # (u_nucleus, u_fallback)
) -> int:
    """Repetition-aware sampling (VALL-E 2 style): take the nucleus sample
    unless it occurs >= win_size * tau_r times among the last win_size
    decoded tokens; then sample the full distribution instead.  Two uniforms
    are consumed per call either way."""
    if uniforms is None:
        uniforms = (_draw(generator), _draw(generator))
    cand = nucleus_sample(logits, top_p, top_k, u=uniforms[0])
    rep = sum(1 for t in list(decoded)[-win_size:] if t == cand) if win_size > 0 else 0
    if rep >= win_size * tau_r:
        return random_sample(logits, u=uniforms[1])
    return cand


def _pick_rows(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`_pick` of every row: (B, n) weights >= 0, (B,) uniforms -> (B,)."""
    cdf = torch.cumsum(weights.double(), -1)
    i = (cdf <= u.double()[:, None] * cdf[:, -1:]).sum(-1)
    return torch.clamp(i, max=weights.shape[-1] - 1)


def decode_log_probs(logits: torch.Tensor, steps: torch.Tensor, min_lens: torch.Tensor,
                     eos: int, fill_ids: bool = False) -> torch.Tensor:
    """(B, V) log-probs of a decode step with the EOS rule applied: EOS is
    -inf while ``steps < min_lens`` and, for the TransformerLM, at step 0.
    ``fill_ids`` (Qwen2LM, whose ids above EOS are fill tokens): step 0
    masks the ids above EOS instead of EOS."""
    x = logits.float()
    first = steps == 0
    if fill_ids:
        above = torch.arange(x.shape[-1], device=x.device) > eos
        x = torch.where(first[:, None] & above[None], -math.inf, x)
    logp = torch.log_softmax(x, dim=-1)
    mask = steps < min_lens
    if not fill_ids:
        mask = mask | first
    logp[:, eos] = torch.where(mask, -math.inf, logp[:, eos])
    return logp


def ras_sample_batch(
    logits: torch.Tensor,  # (B, V) raw step logits
    history: torch.Tensor,  # (B, H) long, each row's decoded tokens, -1 past its count
    counts: torch.Tensor,  # (B,) valid history entries
    uniforms: torch.Tensor,  # (B, 2): (u_nucleus, u_fallback) a row
    steps: torch.Tensor,  # (B,) the step (attempt) each row samples
    min_lens: torch.Tensor,  # (B,) EOS floors
    eos: int,
    top_p: float = 0.8,
    top_k: int = 25,
    win_size: int = 10,
    tau_r: float = 0.1,
    fill_ids: bool = False,
) -> torch.Tensor:
    """RAS over B rows on the logits' device -> (B,) long ids: the log-probs
    of :func:`decode_log_probs`, then :func:`ras_sample`'s rule row by row
    (the nucleus of the top_k head below top_p; the full distribution when
    the candidate fills win_size * tau_r of the last win_size history
    entries).  Static shapes; nothing is read back to the host."""
    logp = decode_log_probs(logits, steps, min_lens, eos, fill_ids)
    probs = torch.softmax(logp, dim=-1)
    top_vals, top_idx = torch.topk(probs, min(top_k, probs.shape[-1]), dim=-1)
    cum_before = torch.cumsum(top_vals, -1) - top_vals
    kept = torch.where(cum_before < top_p, top_vals, 0.0)
    cand = torch.gather(top_idx, 1, _pick_rows(kept, uniforms[:, 0])[:, None])[:, 0]
    if win_size > 0:
        pos = torch.arange(history.shape[1], device=history.device)[None]
        window = (pos >= (counts - win_size)[:, None]) & (pos < counts[:, None])
        rep = ((history == cand[:, None]) & window).sum(-1)
    else:
        rep = torch.zeros_like(cand)
    alt = _pick_rows(probs, uniforms[:, 1])
    return torch.where(rep >= win_size * tau_r, alt, cand)
