"""DPO fine-tuning of the CosyVoice2 speech LLM (the port of the JAX
package's ``train/dpo.py``).

Reference wiring: cosyvoice/bin/train.py ``--dpo`` swaps the forward for
``forward_dpo`` and builds a frozen reference model and ``DPOLoss(beta=0.01)``
(:131-166); train_utils.batch_forward (:238-274) adds the preference loss
to the SFT loss and logs dpo_acc and the mean rewards.  The batch carries
``reject_speech_token`` (processor.padding, processor.py:422-429).

The frozen reference is a detached copy of the initial weights, run in eval
mode under ``torch.no_grad`` with the policy's uni/bistream coin, so both
models pack each pair alike; the loss drops into ``FullTrainer``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ctx import EVAL, Ctx
from ..models.gan import dpo_loss
from ..models.qwen2lm import Qwen2LMConfig, _coin, qwen2lm_forward_dpo
from ..params import P, Params


def make_dpo_loss_fn(cfg: Qwen2LMConfig, ref_params: Params, beta: float = 0.01,
                     label_smoothing: float = 0.0, ipo: bool = False):
    """``loss_fn(params, generator, batch, coin=None) -> (loss, metrics)``
    for ``FullTrainer``; ``coin`` (B,) bool overrides the uni/bistream coin
    drawn from ``generator``."""
    ref = {k: v.detach() for k, v in ref_params.items()}

    def loss_fn(params: Params, generator: Optional[torch.Generator],
                batch: Dict[str, torch.Tensor], coin: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        B = batch["text_token"].shape[0]
        coin = _coin(B, coin, generator, batch["text_token"].device)
        pol = qwen2lm_forward_dpo(P(params), cfg, batch, Ctx(generator=generator, train=True),
                                  coin=coin)
        with torch.no_grad():
            r = qwen2lm_forward_dpo(P(ref), cfg, batch, EVAL, coin=coin)
        pref, chosen_r, reject_r = dpo_loss(
            pol["chosen_logps"], pol["rejected_logps"], r["chosen_logps"],
            r["rejected_logps"], beta=beta, label_smoothing=label_smoothing, ipo=ipo)
        sft = pol["loss"]
        return pref + sft, {  # train_utils.py:268
            "sft_loss": sft.detach(), "dpo_loss": pref.detach(),
            "dpo_acc": (chosen_r > reject_r).float().mean(),
            "chosen_reward": chosen_r.mean(), "reject_reward": reject_r.mean(),
            "acc": pol["acc"]}

    return loss_fn
