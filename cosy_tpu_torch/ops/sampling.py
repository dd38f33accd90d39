"""Token sampling for the AR decode (the port of the JAX package's
``ops/sampling.py``): nucleus and repetition-aware (RAS) sampling.

Each draw is an inverse-CDF lookup of one uniform in [0, 1), taken from an
explicit ``torch.Generator`` or injected (``u``) so tests can hand the same
numbers to a reference statement of the rule.  Sampling runs on the host:
the decode loop needs the token id there anyway (EOS check, next input).
"""

from __future__ import annotations

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
