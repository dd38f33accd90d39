"""The cost model's flops of the work done in the traced window over the
window's seconds times the card's peak (the dense TF32 rate for float32)."""

from portbench.readers import mfu as read  # noqa: F401
