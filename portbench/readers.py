"""Readers that several metric files share; each metric file under
``metrics/`` names its reader, its spans and how it captures a call.  A
reader returns None where its window holds nothing to read, never 0 for
a share of a roofline or of a peak."""

from __future__ import annotations

import statistics
from typing import Optional

from .yardstick import costs as C


def idle_share(rec) -> Optional[float]:
    """Percent of the traced window in which no operation ran on the card."""
    p = rec.profile
    return None if p is None else 100.0 * (1.0 - p.busy_s / p.window_s)


def mfu(rec) -> Optional[float]:
    """The cost model's flops of the work done in the traced window over the
    window's seconds times the card's peak for the type the work computes in."""
    p = rec.profile
    if p is None or rec.traced_flops <= 0:
        return None
    return 100.0 * rec.traced_flops / (p.window_s * rec.peak_flops)


def _estimator_cfg(rec):
    plain = rec.plain
    return plain.model.flow.estimator if hasattr(plain, "model") else plain.flow.estimator


def estimator_roofline(rec) -> Optional[float]:
    """The least time of the traced estimator calls (each call's flops over
    the peak or its bytes over the bandwidth, the larger, from the shape
    of its input) over the device time of the kernels launched inside the
    estimator spans, in percent."""
    if rec.profile is None or rec.spans is None:
        return None
    seconds = rec.profile.span_seconds("estimator")
    calls = rec.spans.of("estimator")
    if not seconds or not calls:
        return None
    cfg = _estimator_cfg(rec)
    least = 0.0
    for c in calls:
        rows, _, T = c["args"][2]
        least += max(C.estimator_call_flops(cfg, rows, T).total / rec.peak_flops,
                     C.estimator_call_bytes(cfg, rows, T) / rec.peak_bytes)
    return 100.0 * least / seconds


def decode_roofline(rec) -> Optional[float]:
    """The least time of the traced decode steps (each step's weights read
    once and every row's cache columns ``[0, W)``, over the bandwidth, or
    its flops over the peak, the larger) over the device time of the
    kernels launched inside the step spans, in percent."""
    if rec.profile is None or rec.spans is None:
        return None
    seconds = rec.profile.span_seconds("decode_step")
    steps = rec.spans.of("decode_step")
    if not seconds or not steps:
        return None
    least = 0.0
    for s in steps:
        nbytes, flops = C.decode_step_work(rec.plain, s["rows"], s["width"])
        least += max(flops / rec.peak_flops, nbytes / rec.peak_bytes)
    return 100.0 * least / seconds


def decode_capture(state, *args, **kwargs):
    """A decode step's rows and the width of the columns it reads."""
    return {"rows": state.B, "width": state._width()}


def span_ms_per_audio_s(rec, span: str) -> Optional[float]:
    if rec.profile is None or rec.traced_audio_s <= 0:
        return None
    seconds = rec.profile.span_seconds(span)
    return None if not seconds else 1e3 * seconds / rec.traced_audio_s


def launches_per_audio_s(rec) -> Optional[float]:
    p = rec.profile
    if p is None or rec.traced_audio_s <= 0 or not p.launches:
        return None
    return p.launches / rec.traced_audio_s


def ttfa_p50_ms(rec) -> Optional[float]:
    return 1e3 * statistics.median(rec.ttfa_s) if rec.ttfa_s else None


def segment_ms(rec) -> Optional[float]:
    return 1e3 * rec.segment_s if rec.segments else None


def launches_per_step(rec) -> Optional[float]:
    p = rec.profile
    if p is None or rec.traced_steps <= 0 or not p.launches:
        return None
    return p.launches / rec.traced_steps


def loader_wait_ms(rec) -> Optional[float]:
    return 1e3 * statistics.median(rec.loader_wait_s) if rec.loader_wait_s else None
