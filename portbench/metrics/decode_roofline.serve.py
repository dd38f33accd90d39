"""The decode steps' least time on the card (the weights read once and every
row's cache columns [0, W), or the flops, by the benchmark's own count)
over the device time of the kernels launched inside the step spans."""

from portbench.readers import decode_capture
from portbench.readers import decode_roofline as read  # noqa: F401

SPANS = {"decode_step": ["cosy_tpu_torch.models.decode:DeviceDecode._step"]}
CAPTURE = {"decode_step": decode_capture}
