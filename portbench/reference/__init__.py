"""The plain reference the benchmark holds the program's outputs to.

``frozen/`` is a copy of the port's plain PyTorch math (configs, layers,
models, pipelines) with every kernel call taken out: attention is the
einsum-softmax and the estimator's blocks run unfused on every device.  It
imports nothing outside itself.  The modules beside it recompute, from
the inputs the harness drew and the seeds it handed the program, what the
timed path should have produced, and measure how far the program's
outputs lie from it.  Nothing here imports ``cosy_tpu_torch``.
"""
