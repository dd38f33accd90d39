"""The harness's own spans around the calls into the program's layers.

A per-layer metric's file names the spans it reads in ``SPANS``:
``{span: ["module:attribute", ...]}``, each attribute being the one the
program's caller looks up when it calls the layer (``models.flow``'s
``conditional_decoder`` is the name ``cfm_solve_euler`` calls, and
``DeviceDecode._step`` a method).  In a traced run, and only while the
profiler runs, each is replaced by a wrapper that opens
``record_function(PREFIX + span)`` around the call and records what the
call's arguments say about its size (``capture``): the shapes of its
tensor arguments, its simple keyword values, and for a method what the
metric file's ``CAPTURE`` function reads from the object.  The profile's
reduction charges each device event to the span its launch fell in: the
span's interval on the host clock, whatever thread made the call (the
profiler records the operators of the thread that started it only, the
CUDA API calls of every thread), mapped onto the profiler's clock through
the marker ``CLOCK`` that :meth:`Spans.mark` records on both.
"""

from __future__ import annotations

import importlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "portbench."
CLOCK = PREFIX + "clock"


def _resolve(target: str) -> Tuple[Any, str]:
    """(owner, attribute name) of ``module:attr`` or ``module:Class.attr``."""
    mod_name, _, path = target.partition(":")
    owner: Any = importlib.import_module(mod_name)
    parts = path.split(".")
    for part in parts[:-1]:
        owner = getattr(owner, part)
    return owner, parts[-1]


def _shape_of(value):
    if isinstance(value, torch.Tensor):
        return tuple(value.shape)
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return type(value).__name__


class Spans:
    """The spans of a cell's metrics; ``calls`` holds one record a call
    made while installed: (span, host start ns, host end ns, arguments'
    sizes).  Only the calls that began after the first marker and ended
    before the last count (:meth:`complete`): a call cut by the profiler's
    start or stop would charge part of its device time to all of its work."""

    def __init__(self, targets: Dict[str, List[str]],
                 captures: Optional[Dict[str, Callable]] = None):
        self.targets = targets
        self.captures = captures or {}
        self.calls: List[Tuple[str, int, int, Dict[str, Any]]] = []
        self.marks: List[int] = []  # host ns of each CLOCK marker
        self._saved: List[Tuple[Any, str, Any]] = []

    @staticmethod
    def mark(marks: List[int]):
        """Record the marker ``CLOCK`` on the profiler and its host time."""
        with torch.profiler.record_function(CLOCK):
            marks.append(time.perf_counter_ns())

    def install(self):
        for span, attrs in self.targets.items():
            for target in attrs:
                owner, attr = _resolve(target)
                orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
                self._saved.append((owner, attr, orig))
                setattr(owner, attr, self._wrap(span, orig))

    def remove(self):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved = []

    def _wrap(self, span: str, fn):
        name, calls, capture = PREFIX + span, self.calls, self.captures.get(span)

        def wrapped(*args, **kwargs):
            info = {"args": [_shape_of(a) for a in args],
                    "kwargs": {k: _shape_of(v) for k, v in kwargs.items()}}
            if capture is not None:
                info.update(capture(*args, **kwargs))
            t0 = time.perf_counter_ns()
            try:
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            finally:
                calls.append((span, t0, time.perf_counter_ns(), info))

        return wrapped

    def complete(self):
        """The calls inside the profiled stretch (between the markers)."""
        if len(self.marks) < 2:
            return []
        lo, hi = self.marks[0], self.marks[-1]
        return [c for c in self.calls if lo <= c[1] and c[2] <= hi]

    def of(self, span: str) -> List[Dict[str, Any]]:
        return [info for s, _, _, info in self.complete() if s == span]


def collect(modules) -> Spans:
    """One :class:`Spans` over the ``SPANS`` and ``CAPTURE`` of the cell's
    metric modules (a span several name is installed once)."""
    targets: Dict[str, List[str]] = {}
    captures: Dict[str, Callable] = {}
    for mod in modules:
        for span, attrs in getattr(mod, "SPANS", {}).items():
            have = targets.setdefault(span, [])
            have += [a for a in attrs if a not in have]
        captures.update(getattr(mod, "CAPTURE", {}))
    return Spans(targets, captures)
