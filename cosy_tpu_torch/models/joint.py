"""Joint LLM + Flow LoRA training forward (the port of the JAX package's
``models/joint.py``): ``llm_loss_weight * llm_ce + flow_loss_weight *
flow_cfm``, both paths in no-prompt mode by default.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import ModelConfig, TrainConfig
from ..ctx import Ctx
from ..params import P, Params
from . import flow as F
from . import llm as L


def joint_forward_train(
    llm_params: Params,
    flow_params: Params,
    loras: Dict[str, Params],
    cfg: ModelConfig,
    tcfg: TrainConfig,
    generator: Optional[torch.Generator],
    batch: Dict[str, torch.Tensor],
    train: bool = True,
) -> Dict[str, torch.Tensor]:
    """Returns {'loss', 'llm_loss', 'flow_loss', 'llm_acc'} for the
    ``training_mode`` (``llm_only`` / ``flow_only`` leave the other model's
    keys out).  ``loras`` maps 'llm' / 'flow' to adapter dicts; either may
    be missing or empty for a frozen submodel.  Every random draw (dropout
    masks, CFM noise, strategy draws) comes from ``generator``."""
    losses: Dict[str, torch.Tensor] = {}
    mode = tcfg.training_mode

    if mode in ("joint", "llm_only"):
        lctx = Ctx(generator, train=train, lora=loras.get("llm") or None,
                   lora_scale=tcfg.llm_lora.scaling, lora_dropout=tcfg.llm_lora.dropout)
        res = L.llm_forward_train(P(llm_params), cfg.llm, batch, lctx)
        losses["llm_loss"] = res["loss"] * tcfg.llm_loss_weight
        losses["llm_acc"] = res["acc"]

    if mode in ("joint", "flow_only"):
        fctx = Ctx(generator, train=train, lora=loras.get("flow") or None,
                   lora_scale=tcfg.flow_lora.scaling, lora_dropout=tcfg.flow_lora.dropout)
        # the full NoPromptConfig travels so mode='mixed' reaches the flow
        # forward; False keeps the anti-leakage strategies
        fl = F.flow_forward_train(
            P(flow_params), cfg.flow, generator, batch, fctx, leak=tcfg.anti_leakage,
            no_prompt=tcfg.no_prompt if tcfg.no_prompt_training else False,
            mel_norm=(cfg.mel_mean, cfg.mel_std))
        losses["flow_loss"] = fl * tcfg.flow_loss_weight

    if mode == "joint":
        losses["loss"] = losses["llm_loss"] + losses["flow_loss"]
    elif mode == "llm_only":
        losses["loss"] = losses["llm_loss"]
    elif mode == "flow_only":
        losses["loss"] = losses["flow_loss"]
    else:
        raise ValueError(f"unknown training_mode {mode!r}")
    return losses
