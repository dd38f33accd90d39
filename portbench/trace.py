"""The traced run's profile, reduced to what the per-layer metric readers
and the ``breakdown`` need.

The profiler keeps its events in memory and nothing is written to disk.
The reduction reads the raw Kineto events, which is far cheaper than
building the profiler's event tree:

- device intervals (kernels, copies, sets) clipped to the traced window,
  their union is the busy time (the arithmetic of ``chip_smoke.py``'s
  ``profile_device``, copied here);
- kernel time by name;
- launch API calls (kernel and graph launches, runtime and driver API);
- the host event running in the middle of each idle gap, for naming gaps:
  the innermost operator or span recorded on the profiling thread, else
  the CUDA API call of any thread, else none (the host ran Python between
  API calls);
- the device seconds of each harness span (``spans.py``): a device event
  is charged to the span in which the host launched it, matched through
  the launch call's correlation id.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "portbench.window"
LAUNCH_API = re.compile(r"^(cu|cuda)(LaunchKernel|LaunchKernelEx|LaunchKernelExC|"
                        r"LaunchCooperativeKernel|GraphLaunch)(_v\d+)?$")
_RUNTIME = re.compile(r"^(cu|cuda)[A-Z]")


def union_seconds(spans: List[Tuple[int, int]]) -> float:
    """Length of the union of (start, end) intervals in ns, in seconds."""
    if not spans:
        return 0.0
    spans = sorted(spans)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + cur_e - cur_s) / 1e9


def gaps(spans: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle (start, end) intervals of [lo, hi] outside ``spans``."""
    out, cur = [], lo
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


class Profile:
    """The reduction of one traced window."""

    def __init__(self, device: List[Tuple[str, int, int]], host: List[Tuple[str, int, int]],
                 launches: int, lo: int, hi: int,
                 api: Optional[List[Tuple[str, int, int]]] = None,
                 span_device: Optional[Dict[str, int]] = None):
        self.lo, self.hi = lo, hi
        self.span_device = span_device or {}  # span name -> device ns launched inside it
        self.window_s = (hi - lo) / 1e9
        self.device = device  # (name, start ns, end ns), clipped to the window
        self.host = host  # (name, start ns, end ns) of host operators and spans
        self.api = api or []  # (name, start ns, end ns) of CUDA API calls
        self.launches = launches
        self.busy_s = union_seconds([(s, e) for _, s, e in device])

    def span_seconds(self, span: str) -> Optional[float]:
        """Device seconds of the events launched inside harness span
        ``span`` (None when no event was charged to it)."""
        ns = self.span_device.get(span)
        return None if not ns else ns / 1e9

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0) + (e - s)
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_by_host(self, k: int = 10, named: int = 20000) -> List[List]:
        """Idle seconds summed by what the host was doing at each gap's
        middle (the ``named`` longest gaps), the top ``k`` names."""
        idle = sorted(gaps([(s, e) for _, s, e in self.device], self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:named]
        lookups = [_Lookup(self.host), _Lookup(self.api)]
        by: Dict[str, int] = {}
        for s, e in idle:
            mid = (s + e) // 2
            name = next((n for n in (lk.at(mid) for lk in lookups) if n is not None),
                        "(host between CUDA API calls)")
            by[name] = by.get(name, 0) + (e - s)
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


class _Lookup:
    """The innermost (latest-starting) event covering a time."""

    def __init__(self, events: List[Tuple[str, int, int]]):
        self.events = sorted(events, key=lambda h: h[1])
        self.starts = [h[1] for h in self.events]

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - 400, -1), -1):
            if self.events[j][2] >= t:
                return self.events[j][0]
        return None


class Tracer:
    """Profiles the span between :meth:`start` and :meth:`stop` when ``on``;
    the load driver's ``record_function(WINDOW_SPAN)`` inside it bounds the
    traced window.  :meth:`reduce`, called once the measured window has
    closed, leaves the reduction in ``profile`` (None when off, or when
    the profiler recorded no device event)."""

    def __init__(self, on: bool, spans=None):
        self.on = on
        self.spans = spans  # a spans.Spans, installed while the profiler runs
        self.profile: Optional[Profile] = None
        self.reduce_s = 0.0
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if self.spans is not None:
            self.spans.install()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if self.spans is not None:
            self.spans.mark(self.spans.marks)

    def stop(self):
        if self.spans is not None:
            self.spans.mark(self.spans.marks)
        self._prof.__exit__(None, None, None)
        if self.spans is not None:
            self.spans.remove()

    def reduce(self):
        if self._prof is None:
            return
        t0 = time.perf_counter()
        self.profile = reduce_profile(self._prof, self.spans)
        self.reduce_s = time.perf_counter() - t0
        self._prof = None


def _annotation(ev) -> bool:
    """A user span the profiler mirrors onto the device's track."""
    is_ann = getattr(ev, "is_user_annotation", None)
    return bool(is_ann()) if is_ann is not None else False


def _correlation(ev) -> int:
    get = getattr(ev, "correlation_id", None)
    return int(get()) if get is not None else 0


def charge_spans(device: List[Tuple[int, int, int]], launch_at: Dict[int, int],
                 spans: List[Tuple[str, int, int]]) -> Dict[str, int]:
    """Device ns by span: each (correlation id, start, end) device event is
    charged to the span whose host interval holds its launch (the innermost
    where spans nest); an event without a launch in a span is charged to
    none."""
    look = _Lookup(spans)
    out: Dict[str, int] = {}
    for corr, s, e in device:
        t = launch_at.get(corr)
        name = None if t is None else look.at(t)
        if name is not None:
            out[name] = out.get(name, 0) + (e - s)
    return out


def reduce_profile(prof, harness_spans=None) -> Optional[Profile]:
    from .spans import CLOCK, PREFIX

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    lo = hi = None
    device, host, api, launches, marked = [], [], [], [], []
    launch_at: Dict[int, int] = {}
    clocks: List[int] = []
    for ev in events:
        name = ev.name()
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type() == cuda:
            if name != WINDOW_SPAN and not name.startswith(PREFIX) and not _annotation(ev):
                device.append((name, s, e))
                marked.append((_correlation(ev), s, e))
        elif name == WINDOW_SPAN:
            lo, hi = s, e
        elif name == CLOCK:
            clocks.append(s)
        elif name.startswith(PREFIX):
            host.append((name, s, e))
        else:
            if LAUNCH_API.match(name):
                launches.append(s)
            if _RUNTIME.match(name):
                api.append((name, s, e))
                corr = _correlation(ev)
                if corr:
                    launch_at[corr] = s
            else:
                host.append((name, s, e))
    if lo is None or not device:
        return None
    inside = [(c, max(s, lo), min(e, hi)) for c, s, e in marked if e > lo and s < hi]
    device = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
    host = [h for h in host if h[2] > lo and h[1] < hi]
    api = [h for h in api if h[2] > lo and h[1] < hi]
    n_launch = sum(1 for t in launches if lo <= t <= hi)
    spans: List[Tuple[str, int, int]] = []
    if harness_spans is not None and clocks and harness_spans.marks:
        # the profiler's clock less the host's, from the first marker
        offset = sorted(clocks)[0] - harness_spans.marks[0]
        spans = [(n, s + offset, e + offset) for n, s, e, _ in harness_spans.complete()]
    return Profile(device, host, n_launch, lo, hi, api,
                   charge_spans(inside, launch_at, spans))
