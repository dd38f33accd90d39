"""Pretrained CosyVoice-300M checkpoint loading (the port of the JAX
package's ``compat/loader.py``).

The reference loads llm.pt / flow.pt / hift.pt from the model dir
(cosyvoice/cli/cosyvoice.py:51-54, cli/model.py:74-116).  The port's module
trees use the torch names verbatim, so loading is an identity map plus
HiFT's weight-norm folding, then a strict ``load_state_dict``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..config import ModelConfig
from ..models.flow import Flow, init_flow_params
from ..models.hift import HiFT, init_hift_params
from ..models.llm import TransformerLM, init_llm_params
from ..params import Params, fold_weight_norm, load_torch_checkpoint, resolve_device

_MODULES = {"llm": TransformerLM, "flow": Flow, "hift": HiFT}


def load_pretrained(model_dir: str, given: Optional[Dict[str, Params]] = None
                    ) -> Dict[str, Params]:
    """{'llm', 'flow', 'hift'} flat f32 CPU dicts from a CosyVoice model dir,
    HiFT's weight norm folded; a dict of ``given`` takes the place of its
    file.  A missing file raises, as the reference's strict load does
    (inference_joint.py:113-127)."""
    out: Dict[str, Params] = {}
    for name in _MODULES:
        path = os.path.join(model_dir, f"{name}.pt")
        if given and name in given:
            params = given[name]
        elif not os.path.exists(path):
            raise FileNotFoundError(f"missing {path}")
        else:
            params = load_torch_checkpoint(path)
        out[name] = fold_weight_norm(params) if name == "hift" else params
    return out


def load_modules(model_dir: str, classes: Dict[str, tuple], device=None,
                 given: Optional[Dict[str, Params]] = None) -> Dict[str, torch.nn.Module]:
    """{'llm', 'flow', 'hift'} modules on ``device`` (CUDA unless asked) with
    the model dir's checkpoints (or the dicts of ``given``) loaded strictly;
    ``classes`` maps each name to its (module class, config):
    ``TransformerLM`` / ``Flow`` / ``HiFT`` for CosyVoice-300M, ``Qwen2LM`` /
    ``Flow2`` / ``HiFT`` for CosyVoice2."""
    dev = resolve_device(device)
    mods = {}
    for name, params in load_pretrained(model_dir, given).items():
        cls, cfg = classes[name]
        mods[name] = cls(cfg, dev)
        mods[name].load_state_dict(params, strict=True)
    return mods


def load_or_init(model_dir: Optional[str], cfg: ModelConfig, device=None,
                 seed: int = 0) -> Dict[str, torch.nn.Module]:
    """{'llm', 'flow', 'hift'} modules on ``device`` (CUDA unless asked):
    the checkpoints of ``model_dir`` loaded strictly when it holds
    ``flow.pt``, else a random init from ``seed`` (llm ``seed``, flow
    ``seed + 1``, hift ``seed + 2``) with a loud warning: LoRA fine-tuning
    from random weights is only useful as a smoke test."""
    dev = resolve_device(device)
    if model_dir and os.path.exists(os.path.join(model_dir, "flow.pt")):
        return load_modules(model_dir, {n: (_MODULES[n], getattr(cfg, n)) for n in _MODULES},
                            dev)
    print("WARNING: pretrained model dir not found - random initialization "
          "(smoke-test mode; real fine-tuning needs CosyVoice-300M weights)")
    return {"llm": init_llm_params(cfg.llm, dev, seed=seed),
            "flow": init_flow_params(cfg.flow, dev, seed=seed + 1),
            "hift": init_hift_params(cfg.hift, dev, seed=seed + 2)}
