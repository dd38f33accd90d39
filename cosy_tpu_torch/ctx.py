"""Execution context threaded through the layer functions (the port of the
JAX package's ``ctx.py``).

Carries train/eval mode, the active LoRA adapter dict with its scale and
dropout rate, and an explicit ``torch.Generator`` (on the tensors' device)
that every dropout mask is drawn from, in place of the JAX PRNG key.
Voice-stacked adapters (``lora_vids``) arrive with multi-voice serving.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


class Ctx:
    __slots__ = ("generator", "train", "lora", "lora_scale", "lora_dropout")

    def __init__(
        self,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        lora: Optional[Dict[str, torch.Tensor]] = None,
        lora_scale: float = 1.0,
        lora_dropout: float = 0.0,
    ):
        self.generator = generator
        self.train = bool(train)
        self.lora = lora
        self.lora_scale = lora_scale
        self.lora_dropout = lora_dropout

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Inverted dropout; identity in eval mode or when rate == 0."""
        if not self.train or rate <= 0.0:
            return x
        if self.generator is None:
            raise ValueError("Ctx has no generator but a stochastic op requested one")
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


EVAL = Ctx(train=False)
