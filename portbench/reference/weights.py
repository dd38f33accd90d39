"""Seeded weights made on the device in a few large draws.

The names, shapes and initializers come from the frozen copy's parameter
specs (``frozen/models/*_spec``).  Each initializer is classified once on a
small CPU probe as a constant, a symmetric uniform or a normal; the leaves
of one kind sit side by side in one flat buffer that a single ``rand`` or
``randn`` on the device fills, so a model of hundreds of leaves takes two
draws and one affine map a bound.  The same seed gives the same weights,
which the harness hands to the program and, drawn again after the window,
to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_PROBE = 8192


def classify(init) -> Tuple[str, float]:
    """("const", value), ("uniform", bound) or ("normal", std) of an
    initializer ``init(tensor, generator)``."""
    t = torch.empty(_PROBE)
    init(t, torch.Generator().manual_seed(0))
    lo, hi = float(t.min()), float(t.max())
    if lo == hi:
        return "const", lo
    m, s = float(t.abs().max()), float(t.std())
    if m / s < 2.0:  # a uniform's max / std is sqrt(3); a normal's, over 8192 draws, about 3.8
        return "uniform", m
    return "normal", s


def spec_weights(spec, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A flat ``{name: tensor}`` of ``spec``'s leaves drawn from ``seed``."""
    groups: Dict[Tuple[str, float], list] = {}
    for name, (shape, init) in spec.entries.items():
        groups.setdefault(classify(init), []).append((name, shape))
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for kind in ("uniform", "normal", "const"):
        keys = sorted(k for k in groups if k[0] == kind)
        total = sum(math.prod(s) for k in keys for _, s in groups[k])
        if total == 0:
            continue
        if kind == "uniform":
            flat = torch.rand(total, generator=gen, device=device, dtype=dtype)
        elif kind == "normal":
            flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        else:
            flat = torch.empty(total, device=device, dtype=dtype)
        at = 0
        for key in keys:
            n = sum(math.prod(s) for _, s in groups[key])
            part = flat[at:at + n]
            if kind == "uniform":
                part.mul_(2 * key[1]).sub_(key[1])
            elif kind == "normal":
                part.mul_(key[1])
            else:
                part.fill_(key[1])
            for name, shape in sorted(groups[key]):
                size = math.prod(shape)
                out[name] = flat[at:at + size].view(shape)
                at += size
    return out
