"""HiFi-GAN (vocoder) adversarial trainer: alternating discriminator and
generator turns (the port of the JAX package's ``train/gan_trainer.py``).

Reference behavior: cosyvoice/utils/executor.py:88-144 (train_one_epoc_gan:
a discriminator step, then a generator step, per batch; two AdamW
optimizers) driven by cosyvoice/bin/train.py.  Each optimizer is AdamW at
optax's defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4) after a
clip by global norm, as the JAX chains are.

``mesh``: both turns run data-parallel over its ``dp`` axis: each rank
takes its rows of batch axis 0 (whole-batch draws, ``parallel.mesh``),
the gradients are averaged over dp before the clip (the DDP arrangement
the reference trains HiFiGAN under, train_utils.py:94-108), and the
TPR loss's median gathers the whole batch's score maps.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..config import HiFTConfig
from ..models.gan import hifigan_discriminator_loss, hifigan_generator_loss
from ..parallel import mesh as pmesh
from ..utils.distributed import joined_loader
from ..params import Params
from .full_trainer import adamw, clip_by_global_norm, dp_mean_grads, dp_mean_metrics


def _leaves(params) -> Params:
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}


class HiFiGanTrainer:
    def __init__(self, cfg: HiFTConfig, gen_params, disc_params, gen_lr: float = 2e-4,
                 disc_lr: float = 2e-4, mel_weight: float = 45.0,
                 feat_match_weight: float = 2.0, tpr_weight: float = 1.0,
                 tpr_tau: float = 0.04, grad_clip: float = 5.0, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.gen_params = _leaves(gen_params)
        self.disc_params = _leaves(disc_params)
        self.device = next(iter(self.gen_params.values())).device
        self.weights = dict(mel_weight=mel_weight, feat_match_weight=feat_match_weight,
                            tpr_weight=tpr_weight, tpr_tau=tpr_tau)
        self.grad_clip = grad_clip
        self.gen_opt = adamw(gen_lr)(list(self.gen_params.values()))
        self.disc_opt = adamw(disc_lr)(list(self.disc_params.values()))
        self._ckptr = None

    def step(self, batch: Dict[str, np.ndarray], generator: Optional[torch.Generator] = None,
             source_draws: Optional[tuple] = None) -> Dict[str, float]:
        """One discriminator turn, then one generator turn (executor.py:
        100-140).  ``source_draws`` = ((phase, noise) of the discriminator
        turn, (phase, noise) of the generator turn) overrides the sine
        source's draws from ``generator``.  Returns both turns' losses,
        prefixed ``disc/`` and ``gen/``, fetched at once."""
        B = next(iter(batch.values())).shape[0]
        lo, hi = pmesh.dp_rows(self.mesh, B)
        b = {k: torch.as_tensor(np.asarray(v)[lo:hi]).to(self.device) for k, v in batch.items()}
        d_draws, g_draws = ((None, None) if source_draws is None else
                            [None if t is None else tuple(x[lo:hi] for x in t)
                             for t in source_draws])
        w = self.weights
        with pmesh.batch_rows(self.mesh, lo, hi, B):
            self.disc_opt.zero_grad(set_to_none=True)
            d = hifigan_discriminator_loss(self.gen_params, self.disc_params, self.cfg, b,
                                           generator, w["tpr_weight"], w["tpr_tau"],
                                           source_draws=d_draws)
            d["loss"].backward()
            self._update(self.disc_params, self.disc_opt)
            self.gen_opt.zero_grad(set_to_none=True)
            g = hifigan_generator_loss(self.gen_params, self.disc_params, self.cfg, b,
                                       generator, source_draws=g_draws, **w)
            g["loss"].backward()
            self._update(self.gen_params, self.gen_opt)
        names = [f"disc/{k}" for k in sorted(d)] + [f"gen/{k}" for k in sorted(g)]
        vals = torch.stack([d[k].detach().float() for k in sorted(d)]
                           + [g[k].detach().float() for k in sorted(g)])
        return dict(zip(names, dp_mean_metrics(vals, self.mesh).cpu().tolist()))

    def _update(self, params: Params, opt: torch.optim.Optimizer) -> None:
        leaves = list(params.values())
        dp_mean_grads(leaves, self.mesh)
        clip_by_global_norm(leaves, self.grad_clip)
        opt.step()

    # -- checkpoints (the GAN path saves through the same rank-0 save_model,
    # train_utils.py:195-214) ----------------------------------------------

    def _tree(self):
        return {"gen_params": self.gen_params, "disc_params": self.disc_params,
                "gen_opt_state": self.gen_opt.state_dict(),
                "disc_opt_state": self.disc_opt.state_dict()}

    def save_checkpoint(self, directory: str, step: int, keep: int = 3,
                        async_save: bool = True) -> int:
        """The parameters and optimizer states (replicated over dp), written
        by rank 0."""
        from .checkpoint import TrainCheckpointer

        if self._ckptr is None or self._ckptr.directory != os.path.abspath(directory):
            self._ckptr = TrainCheckpointer(directory, keep=keep, async_save=async_save)
        if pmesh.is_main():
            self._ckptr.save(step, self._tree())
        return step

    def load_checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        from .checkpoint import TrainCheckpointer, wait_written

        if self._ckptr is None or self._ckptr.directory != os.path.abspath(directory):
            self._ckptr = TrainCheckpointer(directory)
        wait_written(self._ckptr)
        step = self._ckptr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        tree = self._ckptr.restore(step=step)
        with torch.no_grad():
            for name in ("gen_params", "disc_params"):
                mine = getattr(self, name)
                if set(tree[name]) != set(mine):
                    raise KeyError(f"checkpoint {name} differ from the trainer's")
                for k, p in mine.items():
                    p.copy_(tree[name][k])
        self.gen_opt.load_state_dict(tree["gen_opt_state"])
        self.disc_opt.load_state_dict(tree["disc_opt_state"])
        return int(step)

    def close(self) -> None:
        if self._ckptr is not None:
            self._ckptr.close()

    def fit(self, loader: Iterable, epochs: int, generator: Optional[torch.Generator] = None,
            log_every: int = 10):
        step = 0
        for epoch in range(epochs):
            t0 = time.time()
            for batch in joined_loader(loader):
                m = self.step(batch, generator)
                if step % log_every == 0 and pmesh.is_main():
                    print(f"gan epoch {epoch} step {step}: "
                          + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
                step += 1
            if pmesh.is_main():
                print(f"== gan epoch {epoch} done ({time.time() - t0:.1f}s)")
        return self.gen_params, self.disc_params
