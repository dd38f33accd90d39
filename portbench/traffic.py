"""The one generator every traffic mix goes through.

A mix is a data file ``portbench/traffic/<mix>.json``.  Its ``driver``
names the harness module that offers the load (``portbench/drivers/``);
its size distributions are turned into a fixed table of ``table`` values
at the distribution's quantiles.  Requests take the table in cycles, each
cycle in an order of its own drawn from the run's seed: every seed offers
every size once a cycle, so a window of a few cycles holds nearly the same
work whatever the seed, and the seed changes which inputs arrive when.

Distribution: ``{"dist": "loguniform", "min", "max"}``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

_SALT = {"order": 1, "ids": 2, "seeds": 3, "inputs": 4}


def rng(seed: int, purpose: str, index: int = 0) -> np.random.Generator:
    """A numpy generator for one purpose of one run (and one request)."""
    return np.random.default_rng([int(seed) & ((1 << 63) - 1), _SALT[purpose], int(index)])


def quantile_table(dist: Dict[str, Any], n: int) -> List[float]:
    """The distribution's values at the quantiles (i + 1/2) / n."""
    ps = [(i + 0.5) / n for i in range(n)]
    kind = dist["dist"]
    if kind == "loguniform":
        lo, hi = math.log(dist["min"]), math.log(dist["max"])
        return [math.exp(lo + p * (hi - lo)) for p in ps]
    raise ValueError(f"unknown distribution {kind!r}")


class Sizes:
    """``sizes[j]``: request j's size, the ``n``-entry quantile table taken
    in cycles, each permuted by the seed."""

    def __init__(self, dist: Dict[str, Any], n: int, seed: int):
        self.table, self.seed, self._orders = quantile_table(dist, n), seed, {}

    def __getitem__(self, j: int) -> float:
        n = len(self.table)
        c = j // n
        if c not in self._orders:
            self._orders[c] = rng(self.seed, "order", c).permutation(n)
        return self.table[self._orders[c][j % n]]


def request_seed(seed: int, index: int) -> int:
    """The seed a request hands the program (its decode and wav draws)."""
    return int(rng(seed, "seeds", index).integers(0, 1 << 31))


def text_ids(seed: int, index: int, n: int, vocab: int) -> np.ndarray:
    """(1, n) random text ids of request ``index``."""
    return rng(seed, "ids", index).integers(0, vocab, (1, n)).astype(np.int64)
