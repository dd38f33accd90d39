"""Median milliseconds on the client's clock from a request's submission to
its first chunk, over every request whose first chunk arrived in the
window."""

from portbench.readers import ttfa_p50_ms as read  # noqa: F401
