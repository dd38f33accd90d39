"""Execution context threaded through the layer functions (the port of the
JAX package's ``ctx.py``).

Carries train/eval mode, the active LoRA adapter dict with its scale and
dropout rate, and an explicit ``torch.Generator`` (on the tensors' device)
that every dropout mask is drawn from, in place of the JAX PRNG key.
Voice-stacked adapters (a leading voice axis, ``lora.stack_voice_loras``)
route each batch row through its own voice's delta: ``lora_vids`` holds the
(B,) long voice index of every row.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .parallel.mesh import draw_rows


class Ctx:
    __slots__ = ("generator", "train", "lora", "lora_scale", "lora_dropout", "lora_vids")

    def __init__(
        self,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        lora: Optional[Dict[str, torch.Tensor]] = None,
        lora_scale: float = 1.0,
        lora_dropout: float = 0.0,
        lora_vids: Optional[torch.Tensor] = None,
    ):
        self.generator = generator
        self.train = bool(train)
        self.lora = lora
        self.lora_scale = lora_scale
        self.lora_dropout = lora_dropout
        self.lora_vids = lora_vids

    def dropout(self, x: torch.Tensor, rate: float, batched: bool = True) -> torch.Tensor:
        """Inverted dropout; identity in eval mode or when rate == 0.  A
        ``batched`` input (axis 0 = the batch) draws its mask through
        ``parallel.mesh.draw_rows``, so a data-parallel rank gets the rows
        of the whole batch's mask; a shared table passes ``batched=False``."""
        if not self.train or rate <= 0.0:
            return x
        if self.generator is None:
            raise ValueError("Ctx has no generator but a stochastic op requested one")
        keep = 1.0 - rate

        def draw(shape):
            return torch.rand(shape, generator=self.generator, device=x.device)

        mask = (draw_rows(draw, x.shape) if batched else draw(x.shape)) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


EVAL = Ctx(train=False)
