"""What one measured window leaves for the metric readers."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .trace import Profile


@dataclasses.dataclass
class Record:
    """One run's window: host-clock counts over the whole window, and the
    traced sub-window's profile with the work done inside it."""

    window_s: float
    setup_s: float = 0.0
    memory_peak_bytes: int = 0  # the card's peak, read when the window has closed
    audio_s: float = 0.0  # seconds of audio delivered inside the window
    attempted: int = 0
    failed: int = 0
    segments: int = 0  # engine segments completed in the window
    segment_s: float = 0.0  # their mean length, from the window's opening boundary
    ttfa_s: List[float] = dataclasses.field(default_factory=list)  # first chunks in the window
    pending: Tuple[int, int] = (0, 0)  # the engine's pending requests at open and close
    profile: Optional[Profile] = None
    traced_audio_s: float = 0.0
    traced_flops: float = 0.0  # the cost model's flops of the work done in the traced window
    loader_wait_s: List[float] = dataclasses.field(default_factory=list)  # each batch's wait
    traced_steps: int = 0
    spans: Any = None  # the harness's spans.Spans of the traced window
    plain: Any = None  # the configuration's frozen dataclasses
    peaks: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dtype: str = "float32"  # the type the timed work computes in: its peak is the mfu's

    @property
    def peak_flops(self) -> float:
        return float(self.peaks["flops_per_s"][self.dtype])

    @property
    def peak_bytes(self) -> float:
        return float(self.peaks["hbm_bytes_per_s"])
