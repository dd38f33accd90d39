"""Kernel and graph launch calls in the traced window an optimizer step
completed in it."""

from portbench.readers import launches_per_step as read  # noqa: F401
