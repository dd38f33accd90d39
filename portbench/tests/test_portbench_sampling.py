"""The sampling rule the reference restates, and the token miss built on
it."""

import math

import numpy as np
import torch

from portbench.reference.sampling import TIE, Rule, log_probs
from cosy_tpu_torch.ops import sampling as S

RULE = Rule(0.8, 25, 10, 0.1)


def _case(rng, V=300, scale=3.0):
    logits = torch.tensor(rng.standard_normal(V) * scale, dtype=torch.float32)
    hist = list(rng.integers(0, V, rng.integers(0, 12)))
    u = [float(rng.random()), float(rng.random())]
    return logits, hist, u


def test_the_restated_rule_draws_the_ports_token():
    rng = np.random.default_rng(5)
    for _ in range(300):
        logits, hist, u = _case(rng)
        logp = torch.log_softmax(logits.double(), -1)
        want = S.ras_sample(logp.float(), hist, 0.8, 25, 10, 0.1, uniforms=u)
        assert RULE.choose(logp, u, hist) == want
        assert RULE.miss(logp, want, u, hist) == 0.0


def test_another_token_misses():
    rng = np.random.default_rng(6)
    misses = []
    for _ in range(200):
        logits, hist, u = _case(rng)
        logp = torch.log_softmax(logits.double(), -1)
        got = RULE.choose(logp, u, hist)
        other = int(torch.argsort(logp, descending=True)[1 if got != 1 else 2])
        misses.append(RULE.miss(logp, (got + 1) % 300 if other == got else other, u, hist))
    assert np.median(misses) > 1e-2


def test_near_ties_and_cuts_are_taken_either_way():
    p = torch.tensor([0.4, 0.2, 0.2 * (1 - TIE / 10), 0.1, 0.1], dtype=torch.float64)
    logp = torch.log(p)
    # the nucleus keeps tokens 0-3 (mass 0.9); u * 0.9 lies in token 2's
    # interval [0.6, 0.8), and token 1 ties with token 2, so may sit there
    u = [0.75, 0.5]
    assert RULE.choose(logp, u, []) == 2
    assert RULE.miss(logp, 1, u, []) == 0.0
    assert RULE.miss(logp, 3, u, []) > 0.1
    # top-p: token 3's preceding mass 0.8 - 1e-8 is kept; 0.8 + 1e-8 would not be
    q = torch.tensor([0.5, 0.3 - 1e-8, 0.1, 0.1], dtype=torch.float64)
    head_u = [0.95, 0.5]
    assert RULE.miss(torch.log(q), 2, head_u, []) == 0.0


def test_eos_and_fill_rules():
    logits = torch.zeros(10)
    lp = log_probs(logits, 0, 5, eos=7, fill_ids=True)
    assert torch.isinf(lp[7]) and torch.isinf(lp[8:]).all() and torch.isfinite(lp[:7]).all()
    lp = log_probs(logits, 3, 5, eos=7, fill_ids=True)
    assert torch.isinf(lp[7]) and torch.isfinite(lp[8:]).all()
    lp = log_probs(logits, 6, 5, eos=7, fill_ids=False)
    assert torch.isfinite(lp).all()
    lp = log_probs(logits, 0, 0, eos=7, fill_ids=False)
    assert torch.isinf(lp[7])
    assert math.isinf(RULE.miss(log_probs(logits, 0, 5, 7, True), 8, [0.5, 0.5], []))


def _full_draw(logp, u):
    full = torch.cumsum(torch.softmax(logp, -1), 0)
    return min(int((full <= u * full[-1]).sum()), logp.shape[0] - 1)


def test_the_whole_distribution_only_where_the_nucleus_draw_repeats():
    rng = np.random.default_rng(7)
    misses, taken = [], 0
    for _ in range(300):
        logits, hist, u = _case(rng)
        logp = torch.log_softmax(logits.double(), -1)
        cand = RULE.choose(logp, [u[0], 2.0], [])  # the nucleus draw alone
        tok = _full_draw(logp, u[1])
        if RULE._repeats(cand, hist):
            taken += 1
            assert RULE.miss(logp, tok, u, hist) == 0.0
        elif tok != cand:
            misses.append(RULE.miss(logp, tok, u, hist))
    # a sampler that always draws from the whole distribution misses
    assert misses and np.median(misses) > 1e-2
    # a history that repeats the nucleus draw takes that branch
    logits, _, u = _case(rng)
    logp = torch.log_softmax(logits.double(), -1)
    cand = RULE.choose(logp, [u[0], 2.0], [])
    assert RULE.miss(logp, _full_draw(logp, u[1]), u, [cand] * 10) == 0.0
