"""What decides ``correct``: each number compared against its limit.

The numbers come from the comparison of the cell's driver, a module of
its own beside this one named as the driver (``<driver>.py``), whose
``numbers(config, seed, inference, samples, device, control)`` recomputes
on the frozen reference what the window produced and measures how far the
program's samples lie from it.  With ``control`` the same numbers are
those of the reference computed one precision below the configuration's,
put in the program's place: TF32 on in PyTorch's matmuls and cuDNN for
the float32 cells, float8 for the bfloat16 training step.  A number the
limits file does not name is not compared.  A cell with a new driver adds
its module; nothing here changes.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict

import numpy as np
import torch


def numbers(driver: str):
    """The ``numbers`` function of the driver's comparison module."""
    return importlib.import_module(f"{__package__}.{driver}").numbers


def compare(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number the check could not read counts as over it."""
    compared = {k: {"value": numbers.get(k, math.inf), "limit": v} for k, v in limits.items()}
    ok = bool(numbers) and all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared


def set_tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return math.inf
    want = want.astype(np.float64)
    return float(np.linalg.norm(got.astype(np.float64) - want) / max(np.linalg.norm(want), 1e-30))
