"""cosy_tpu_torch: the PyTorch / CUDA port of cosy_tpu for NVIDIA Hopper.

The package mirrors cosy_tpu's layout (``config``, ``params``, ``ops``, ``data``,
``compat``, ``layers``, ``models``, ``infer``, ``train``) and imports neither
JAX nor cosy_tpu.
Entry points run on CUDA unless the caller passes ``device="cpu"``; on CUDA
tensors the estimator's transformer blocks and attention launch the
hand-written kernels under ``csrc/``, on CPU tensors their plain PyTorch
versions run.
"""

__version__ = "0.1.0"
