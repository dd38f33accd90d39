"""Median milliseconds a step waited for its batch from the loader's
prefetch thread, over the steps of the window."""

from portbench.readers import loader_wait_ms as read  # noqa: F401
