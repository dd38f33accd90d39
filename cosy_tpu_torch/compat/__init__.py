"""Checkpoint compatibility transforms (the port of the JAX package's
``compat/__init__.py``).

Reference checkpoints load by name (``params.load_torch_checkpoint``); the
weight-norm fold lives beside it (``params.fold_weight_norm``).  This
module holds the Lightning joint checkpoint's prefix handling.
"""

from __future__ import annotations

from typing import Dict


def strip_lightning_prefixes(params: Dict, submodule: str) -> Dict:
    """The ``submodule`` weights of a Lightning joint checkpoint under
    their module names: a ``model.<submodule>.`` or ``<submodule>.`` prefix
    is taken off and LoRA's ``original_layer`` indirection unwrapped
    (reference: merge_joint_weights.py:117-178).  Other keys are dropped."""
    out = {}
    for k, v in params.items():
        for pre in (f"model.{submodule}.", f"{submodule}."):
            if k.startswith(pre):
                out[k[len(pre):].replace(".original_layer.", ".")] = v
                break
    return out
