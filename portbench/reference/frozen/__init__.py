"""A frozen copy of the port's plain forward math, as it stood when the
benchmark was defined: configs, parameter specs, layers, models and the
pipelines' prefix, ``token2wav`` and streamed windows.  No kernel call,
parallel path, LoRA, int8 or training code is left: attention is the
einsum-softmax and the estimator's blocks run unfused on every device.
The benchmark's reference runs it; it imports nothing outside itself.
"""
