"""Ops of the port; the kernel wrappers keep plain-integer launch counts."""

from __future__ import annotations

from typing import Dict


def _wrappers():
    from .flash_attention import banded_attention, flash_attention
    from .fused_block import (block_tail, fused_transformer_block, gemm, layer_norm_rows,
                              ln_gemm)

    return {"flash_attention": flash_attention, "banded_attention": banded_attention,
            "fused_transformer_block": fused_transformer_block, "ln_gemm": ln_gemm,
            "block_tail": block_tail, "layer_norm_rows": layer_norm_rows, "gemm": gemm}


def launch_counts() -> Dict[str, int]:
    """Kernel launches counted by each wrapper since the last reset (a
    fused_transformer_block launch is one chain of three kernels, counted
    again under ln_gemm, flash_attention and block_tail)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0
