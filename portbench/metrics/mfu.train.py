"""The cost model's flops of the traced optimizer steps over the window's
seconds times the card's peak for the step's type (the dense bfloat16 rate:
the step runs bf16 base weights and activations)."""

from portbench.readers import mfu as read  # noqa: F401
