"""Ops of the port; the kernel wrappers keep plain-integer launch counts."""

from __future__ import annotations

from typing import Dict


def _wrappers():
    from .flash_attention import flash_attention
    from .fused_block import fused_transformer_block, gemm, layer_norm_rows

    return {"flash_attention": flash_attention,
            "fused_transformer_block": fused_transformer_block,
            "layer_norm_rows": layer_norm_rows, "gemm": gemm}


def launch_counts() -> Dict[str, int]:
    """Kernel launches counted by each wrapper since the last reset (a
    fused_transformer_block launch is one chain of seven kernels)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0
