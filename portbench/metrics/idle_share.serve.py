"""Percent of the traced window in which no operation ran on the card
(100 less the union of the device's intervals over the window)."""

from portbench.readers import idle_share as read  # noqa: F401
