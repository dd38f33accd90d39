"""Sequence parallelism: the estimator's time axis over the ``seq`` mesh
axis (the port of the JAX package's ``parallel/sp.py``).

The JAX package annotates the flow loss's (.., T, ..) activations and lets
GSPMD shard the work over T, inserting the all-gathers attention needs.
Eager PyTorch has no partitioner, so the port splits where the work is:
the estimator's transformer stacks (``layers/unet.py``).  Inside a stack
each ``seq`` rank keeps its slice of the frames (:func:`shard_seq`),
computes LayerNorm, the products and the feed-forward for those frames
only, and attends from its queries to every frame's keys and values
(:func:`gather_keys`); the stack's output is gathered whole again
(:func:`gather_seq`) for the convolutions between stacks, whose time
mixing would otherwise need halos.  The stacks' parameters sum their
gradients over the ranks (:func:`region_params`).  The math is the
replicated run's, in another order of summation.

Models never take a mesh: trainers enter :func:`sequence_sharding` around
the loss, and every function here is the identity outside it, at seq 1,
or when the time axis does not divide.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

from ..params import P
from . import comm

_state = threading.local()


@contextmanager
def sequence_sharding(mesh):
    """Activate the time-axis split for loss forwards run within."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def _current_mesh():
    return getattr(_state, "mesh", None)


def seq_axis_size(mesh=None) -> int:
    mesh = mesh or _current_mesh()
    return 1 if mesh is None else mesh.size("seq")


def _group():
    mesh = _current_mesh()
    return None if mesh is None else mesh.group("seq")


def applies(T: int) -> bool:
    """Whether a time axis of ``T`` frames splits here."""
    size = seq_axis_size()
    return size > 1 and T % size == 0


def frames(T: int):
    """This rank's frames [lo, hi) of ``T``."""
    size = seq_axis_size()
    n = T // size
    lo = _current_mesh().coord("seq") * n
    return lo, lo + n


def shard_seq(x: torch.Tensor, time_axis: int) -> torch.Tensor:
    """This rank's slice of ``x``'s ``time_axis`` (the gradient is
    gathered back whole); ``x`` itself when the split does not apply."""
    if x.dim() <= time_axis or not applies(x.shape[time_axis]):
        return x
    return comm.split(x, time_axis, _group())


def gather_seq(x: torch.Tensor, time_axis: int) -> torch.Tensor:
    """The whole time axis from every rank's slice, consumed alike by every
    rank (the inverse of :func:`shard_seq`)."""
    if seq_axis_size() <= 1:
        return x
    return comm.gather(x, time_axis, _group())


def gather_keys(x: torch.Tensor, time_axis: int) -> torch.Tensor:
    """Every frame's keys (or values) for this rank's queries: the
    gradient of each frame sums over the ranks that attended to it."""
    if seq_axis_size() <= 1:
        return x
    return comm.gather(x, time_axis, _group(), partial_grad=True)


class _Region(dict):
    """A flat param dict whose tensors, read inside a split region, sum
    their gradients over the seq ranks (each rank's frames contribute a
    part)."""

    def __init__(self, d, group):
        super().__init__()
        self._d, self._group = d, group

    def __missing__(self, key):
        v = comm.grad_sum(self._d[key], self._group)
        self[key] = v
        return v

    def get(self, key, default=None):
        return self[key] if key in self._d else default

    def __contains__(self, key):
        return key in self._d


_region = threading.local()


def in_region() -> bool:
    return getattr(_region, "on", False)


@contextmanager
def region():
    """Mark the split region (attention gathers its keys within)."""
    prev = in_region()
    _region.on = True
    try:
        yield
    finally:
        _region.on = prev


def region_params(p: P) -> P:
    """``p`` over a view whose tensors sum their gradients over seq."""
    return P(_Region(p.d, _group()), p.prefix)


def bias_rows(bias: Optional[torch.Tensor], T: int) -> Optional[torch.Tensor]:
    """The query rows [lo, hi) of a (B, T, T) attention bias."""
    if bias is None:
        return None
    lo, hi = frames(T)
    return bias[:, lo:hi]
