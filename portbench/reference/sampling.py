"""The decode's sampling rule, restated in float64, and how far a served
token lies from what the reference's distribution and the request's own
uniforms give.

Rule (the program's documented one): log-probs with EOS masked below the
floor (and at step 0 for the TransformerLM; the ids above EOS at step 0
for Qwen2LM), the nucleus of the top-k head below top-p sampled with the
first uniform by an inverse CDF; when that candidate occurs in the last
``win`` emitted tokens at least ``win * tau`` times, the whole
distribution is sampled with the second uniform instead.

``miss`` is the distance, in probability mass, between a uniform and the
interval the served token holds in the reference's CDF (0 when the
reference draws the same token), the smaller over the two branches the
rule allows for that token: the nucleus branch where the token does not
repeat, the whole distribution only where the nucleus draw of the first
uniform (or a draw within ``TIE`` of it) repeats; infinite for a token of
probability 0.
Rounding moves a CDF boundary by about the logits' error, so a sound
program reads 0 or that much; a token the rule would not give reads the
width of the gap to its interval.  Rounding also decides the order of
tokens whose probabilities all but tie, and so where each one's interval
lies in the nucleus: tokens within ``TIE`` of each other (relative) are
taken in either order, a token within ``TIE`` of the top-k cut on either
side of it, and a token whose preceding mass lies within ``TIE`` of top-p
on either side of that cut.  f32 logits agree to ~1e-6; the control's
TF32 logits to ~1e-3.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch


def log_probs(logits: torch.Tensor, step: int, min_len: int, eos: int,
              fill_ids: bool) -> torch.Tensor:
    x = logits.double().clone()
    if fill_ids and step == 0:
        x[eos + 1:] = -math.inf
    logp = torch.log_softmax(x, dim=-1)
    if step < min_len or (not fill_ids and step == 0):
        logp[eos] = -math.inf
    return logp


TIE = 1e-4


class Rule:
    def __init__(self, top_p: float, top_k: int, win: int, tau: float):
        self.top_p, self.top_k, self.win, self.tau = top_p, top_k, win, tau

    def _nucleus(self, logp: torch.Tensor):
        probs = torch.softmax(logp, dim=-1)
        vals, idx = torch.topk(probs, min(self.top_k, probs.shape[0]))
        before = torch.cumsum(vals, 0) - vals
        kept = torch.where(before < self.top_p, vals, torch.zeros_like(vals))
        return probs, idx, torch.cumsum(kept, 0), kept

    def _repeats(self, token: int, history: Sequence[int]) -> bool:
        if self.win <= 0:
            return False
        return sum(1 for t in list(history)[-self.win:] if t == token) >= self.win * self.tau

    def choose(self, logp: torch.Tensor, u: Sequence[float], history: Sequence[int]) -> int:
        probs, idx, cdf, _ = self._nucleus(logp)
        i = min(int((cdf <= u[0] * cdf[-1]).sum()), cdf.shape[0] - 1)
        cand = int(idx[i])
        if not self._repeats(cand, history):
            return cand
        full = torch.cumsum(probs, 0)
        return min(int((full <= u[1] * full[-1]).sum()), probs.shape[0] - 1)

    def _heads(self, probs: torch.Tensor) -> List[List[Tuple[int, float]]]:
        """The nucleus the rule keeps, as (token, p) in sorted order, and
        the variants rounding could give at the top-k and top-p cuts."""
        k = min(self.top_k, probs.shape[0])
        vals, idx = torch.topk(probs, min(k + 1, probs.shape[0]))
        ranked = [(int(t), float(v)) for t, v in zip(idx, vals)]
        tops = [ranked[:k]]
        if len(ranked) > k and ranked[k][1] >= ranked[k - 1][1] * (1 - TIE):
            tops.append(ranked[:k - 1] + [ranked[k]])
        heads = []
        for top in tops:
            before, keep = 0.0, []
            for t, v in top:
                if before < self.top_p - TIE:
                    keep.append((t, v))
                elif before < self.top_p + TIE:  # at the cut: kept or not
                    heads.append(list(keep))
                    keep.append((t, v))
                before += v
            heads.append(keep)
        return heads

    def _candidates(self, heads: List[List[Tuple[int, float]]], u: float) -> List[int]:
        """The nucleus draws the first uniform can give: every token whose
        interval (widened over its ties) lies within ``TIE`` of ``u`` in
        any of the heads rounding allows."""
        return [t for head in heads for t, v in head if _interval_miss(head, t, v, u) <= TIE]

    def miss(self, logp: torch.Tensor, token: int, u: Sequence[float],
             history: Sequence[int]) -> float:
        probs = torch.softmax(logp, dim=-1)
        heads = self._heads(probs)
        best = math.inf
        if not self._repeats(token, history):
            for head in heads:
                best = min(best, _interval_miss(head, token, float(probs[token]), u[0]))
        if best == 0.0 or float(probs[token]) == 0.0:
            return best
        # the whole distribution is sampled only where the nucleus draw repeats
        if not any(self._repeats(t, history) for t in self._candidates(heads, u[0])):
            return best
        full = torch.cumsum(probs, 0)
        total = float(full[-1])
        lo = (float(full[token - 1]) if token else 0.0) / total
        return min(best, _dist(u[1], lo, float(full[token]) / total))


def _interval_miss(head: List[Tuple[int, float]], token: int, p: float, u: float) -> float:
    """The distance of u from the interval of ``token`` (probability p) in
    the normalized CDF of ``head``, the interval widened over the tokens
    that tie with it; a token outside the head takes the place of a member
    it ties with."""
    pos = [i for i, (t, _) in enumerate(head) if t == token]
    if not pos:
        pos = [i for i, (_, v) in enumerate(head) if abs(v - p) <= TIE * p]
        if not pos:
            return math.inf
        head = list(head)
        head[pos[0]] = (token, p)
    i = pos[0]
    lo_i = hi_i = i
    while lo_i > 0 and head[lo_i - 1][1] <= p * (1 + TIE):
        lo_i -= 1
    while hi_i + 1 < len(head) and head[hi_i + 1][1] >= p * (1 - TIE):
        hi_i += 1
    total = sum(v for _, v in head)
    lo = sum(v for _, v in head[:lo_i]) / total
    hi = sum(v for _, v in head[:hi_i + 1]) / total
    return _dist(u, lo, hi)


def _dist(u: float, lo: float, hi: float) -> float:
    if lo <= u < hi:
        return 0.0
    return min(abs(u - lo), abs(u - hi))
