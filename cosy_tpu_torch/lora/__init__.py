"""Functional LoRA: adapter dicts over frozen base params (the port of the
JAX package's ``lora/__init__.py``).

Adapters live in a separate flat dict keyed ``<module path>.lora_A`` /
``.lora_B`` (Linear) or ``<module path>.lora_A.weight`` / ``.lora_B.weight``
(1x1 Conv1d), consumed by ``layers.basic.dense`` / ``conv1d`` through the
``Ctx``.  Every adapter is a leaf tensor with ``requires_grad=True``; the
base parameters stay frozen (``requires_grad=False``), so autograd
differentiates the adapters only.

Reference quirks kept:
- targeting is a *substring* match on the last module-name component;
- lora_B is initialized 0.01 * N(0, 1), not zero: adapters perturb the
  model from step 0 by design.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import LoRAConfig
from ..params import Params, resolve_device


def find_lora_targets(params: Params, target_modules: Sequence[str]) -> List[str]:
    """Module paths (without ``.weight``) eligible for LoRA: a Linear (2-D
    weight) or a 1x1 Conv1d (3-D weight, k == 1) whose last name component
    contains any target substring."""
    out = []
    for k, v in params.items():
        if not k.endswith(".weight"):
            continue
        path = k[: -len(".weight")]
        name = path.rsplit(".", 1)[-1]
        if not any(t in name for t in target_modules):
            continue
        if v.ndim == 2 or (v.ndim == 3 and v.shape[-1] == 1):
            out.append(path)
    return sorted(out)


def init_lora(generator: Optional[torch.Generator], params: Params, cfg: LoRAConfig,
              targets: Optional[List[str]] = None) -> Params:
    """Adapter params for every target module, f32 on the base weights'
    device: A kaiming-uniform (a = sqrt(5)), B 0.01 * N(0, 1).  ``generator``
    lives on that device (None: the device's default generator; ignored for
    ``meta`` weights, which get shapes only)."""
    targets = targets if targets is not None else find_lora_targets(params, cfg.target_modules)
    lora: Params = {}
    for path in targets:
        w = params[path + ".weight"]
        conv = w.ndim == 3
        out_f, in_f = w.shape[0], w.shape[1]
        bound = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / in_f)
        a = torch.empty((cfg.r, in_f) + ((1,) if conv else ()), device=w.device)
        b = torch.empty((out_f, cfg.r) + ((1,) if conv else ()), device=w.device)
        if w.device.type != "meta":
            a.uniform_(-bound, bound, generator=generator)
            b.normal_(generator=generator).mul_(0.01)
        suffix = ".weight" if conv else ""
        lora[path + ".lora_A" + suffix] = a.requires_grad_(True)
        lora[path + ".lora_B" + suffix] = b.requires_grad_(True)
    return lora


def merge_lora(params: Params, lora: Params, scaling: float) -> Params:
    """W' = W + B @ A * scaling for Linears and 1x1 convs, as a new
    original-format flat dict on the weights' device (detached; the inputs
    are not modified)."""
    out = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        for k in lora:
            if k.endswith(".lora_A"):
                path = k[: -len(".lora_A")]
                a, b = lora[k], lora[path + ".lora_B"]
                delta = (b @ a) * scaling
            elif k.endswith(".lora_A.weight"):
                path = k[: -len(".lora_A.weight")]
                a, b = lora[k], lora[path + ".lora_B.weight"]  # (r, in, 1), (out, r, 1)
                delta = torch.einsum("ori,ric->oic", b, a) * scaling
            else:
                continue
            w = out[path + ".weight"]
            out[path + ".weight"] = w + delta.to(device=w.device, dtype=w.dtype)
    return out


def _frozen_tensor(v, device=None) -> torch.Tensor:
    """An f32 tensor that needs no gradient (the kernels refuse one that
    does) from a tensor or an array."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def stack_voice_loras(loras: Sequence[Params], device=None) -> Params:
    """Stack per-voice adapter dicts along a new leading VOICE axis (V, ...)
    for multi-voice serving: every voice must cover the same adapter keys
    with the same shapes (same base model and ``LoRAConfig``).  The result
    feeds ``Ctx(lora=..., lora_vids=per_row_voice_ids)`` and the decode's
    ``lora`` / ``vids``.  Detached: stacked adapters serve, never train.
    ``device`` None keeps the first voice's device."""
    if not loras:
        raise ValueError("no adapter dicts to stack")
    keys = set(loras[0])
    for i, lo in enumerate(loras[1:], 1):
        if set(lo) != keys:
            missing = keys.symmetric_difference(lo)
            raise ValueError(f"voice {i} adapter keys differ: {sorted(missing)[:4]}")
    if device is None:
        first = loras[0][next(iter(sorted(keys)))]
        device = first.device if isinstance(first, torch.Tensor) else "cpu"
    return {k: torch.stack([_frozen_tensor(lo[k], device) for lo in loras])
            for k in sorted(keys)}


def ensure_voice_stacked(lora: Params) -> Params:
    """An adapter dict with a leading voice axis (one voice is wrapped as
    V = 1): dense adapters (``.lora_A`` / ``.lora_B``) are 3-D stacked, 1x1
    conv adapters (``.lora_A.weight`` / ``.lora_B.weight``) 4-D."""
    out: Params = {}
    for k, v in lora.items():
        v = _frozen_tensor(v, v.device if isinstance(v, torch.Tensor) else None)
        want = 4 if k.endswith(".weight") else 3
        out[k] = v if v.ndim == want else v[None]
    return out


def lora_num_params(lora: Params) -> int:
    return int(sum(v.numel() for v in lora.values()))


def export_torch_lora_state(lora: Params) -> Params:
    """Adapter dict in the reference's on-disk naming: the wrapped layers are
    named ``<path>.lora_A`` already, so this detaches and copies nothing else."""
    return {k: v.detach() for k, v in lora.items()}


def lora_from_numpy(flat: Dict[str, np.ndarray], device=None) -> Params:
    """A JAX adapter dict (numpy arrays under the same keys) as the port's:
    f32 leaf tensors that require a gradient."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev).requires_grad_(True)
            for k, v in flat.items()}


def lora_to_numpy(lora: Params) -> Dict[str, np.ndarray]:
    """The port's adapter dict as numpy arrays under the same keys (the JAX
    package's adapter format)."""
    return {k: v.detach().float().cpu().numpy() for k, v in lora.items()}
