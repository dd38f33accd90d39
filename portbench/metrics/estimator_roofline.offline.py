"""The estimator calls' least time on the card (each call's flops over the
peak or its bytes over the bandwidth, the larger, from its shape) over the
device time of the kernels launched inside the estimator spans."""

from portbench.readers import estimator_roofline as read  # noqa: F401

SPANS = {"estimator": ["cosy_tpu_torch.models.flow:conditional_decoder",
                        "cosy_tpu_torch.models.flow2:conditional_decoder"]}
