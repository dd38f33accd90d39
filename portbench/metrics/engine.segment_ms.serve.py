"""The window's milliseconds over the rise in the engine's ``segments_run``
(a segment: every live row's decode, then the windows it made ready)."""

from portbench.readers import segment_ms as read  # noqa: F401
