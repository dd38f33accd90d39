"""Execution context threaded through the layer functions: train/eval mode,
the ``torch.Generator`` (on the tensors' device) every dropout mask is
drawn from, and the LoRA adapters of a training step with their scale and
dropout.  Inference runs in eval mode, where dropout is the identity."""

from __future__ import annotations

from typing import Dict, Optional

import torch


class Ctx:
    __slots__ = ("generator", "train", "lora", "lora_scale", "lora_dropout")

    def __init__(self, generator: Optional[torch.Generator] = None, train: bool = False,
                 lora: Optional[Dict[str, torch.Tensor]] = None, lora_scale: float = 1.0,
                 lora_dropout: float = 0.0):
        self.generator = generator
        self.train = bool(train)
        self.lora = lora
        self.lora_scale = lora_scale
        self.lora_dropout = lora_dropout

    def dropout(self, x: torch.Tensor, rate: float, batched: bool = True) -> torch.Tensor:
        """Inverted dropout; identity in eval mode or when rate == 0."""
        if not self.train or rate <= 0.0:
            return x
        if self.generator is None:
            raise ValueError("Ctx has no generator but a stochastic op requested one")
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


EVAL = Ctx(train=False)
