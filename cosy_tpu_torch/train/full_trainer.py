"""Full-parameter trainer (the port of the JAX package's
``train/full_trainer.py``).

Reference behavior: the vendored trainer path (cosyvoice/bin/train.py,
utils/executor.py, utils/train_utils.py): gradient accumulation, clipping
by global norm with the inf/nan skip, a per-step optimizer update.

One process on one device, eager PyTorch: a step is a loop over the
(accum, B, ...) super-batch, each micro-batch's ``backward()`` adding into
``.grad``; the gradient is the mean over the micro-batches, clipped by its
global norm, and a non-finite norm skips the update, leaving the
parameters and the optimizer's moments (and its step count) untouched
(train_utils.py:305-315).  ``zero2`` is the identity here, since the
data-parallel group has one member.  A mesh, tensor, sequence and pipeline
parallelism are ROADMAP A15 (``parallel/``) and raise.

Every trainer here runs the plain differentiable ops: the kernel wrappers
refuse an input that requires a gradient, and the layers' gates keep
``Ctx(train=True)`` off them, as the JAX package's gates keep training off
its Pallas kernels.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..params import Params

LossFn = Callable[[Params, Optional[torch.Generator], Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
OptimizerFn = Callable[[List[torch.Tensor]], torch.optim.Optimizer]

PARALLEL_REFUSAL = ("{what} is not ported yet: one process on one device until ROADMAP "
                    "A15 (parallel/: the mesh, tensor, sequence and pipeline parallelism)")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerFn:
    """``optax.adamw``'s defaults as a factory of ``torch.optim.AdamW``
    (whose own weight decay default is 1e-2)."""
    def make(params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)
    return make


def refuse_parallel(mesh=None, tensor_parallel: bool = False, sequence_parallel: bool = False,
                    pipeline_parallel_microbatches: int = 0) -> None:
    for what, on in (("mesh=", mesh is not None), ("tensor parallelism", tensor_parallel),
                     ("sequence parallelism", sequence_parallel),
                     ("pipeline parallelism", pipeline_parallel_microbatches > 0)):
        if on:
            raise NotImplementedError(PARALLEL_REFUSAL.format(what=what))


def clip_by_global_norm(leaves: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the leaves' ``.grad`` (a missing one counts as zero) to a global
    norm of at most ``max_norm`` (optax.clip_by_global_norm: a non-finite
    norm zeroes the finite gradients and leaves the others non-finite);
    returns the norm before the clip."""
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(p.grad.float())) for p in leaves))
    factor = max_norm / torch.clamp(gnorm, min=max_norm)
    for p in leaves:
        p.grad.mul_(factor.to(p.grad.dtype))
    return gnorm


class FullTrainer:
    """Train all parameters of ``loss_fn(params, generator, micro_batch) ->
    (loss, aux metrics)``, where ``params`` is the flat ``{name: tensor}``
    dict the port's model functions read through ``P``."""

    def __init__(self, loss_fn: LossFn, params, optimizer: OptimizerFn = adamw(1e-4),
                 mesh=None, zero2: bool = True, grad_clip: float = 5.0, accum: int = 1,
                 tensor_parallel: bool = False, sequence_parallel: bool = False,
                 pipeline_parallel_microbatches: int = 0):
        refuse_parallel(mesh, tensor_parallel, sequence_parallel, pipeline_parallel_microbatches)
        if isinstance(params, torch.nn.Module):
            params = dict(params.named_parameters())
        self.loss_fn = loss_fn
        self.zero2 = zero2  # the identity with one data-parallel member
        self.grad_clip = grad_clip
        self.accum = accum
        # the trainer's own leaves: the caller's tensors stay as they were
        self.params: Params = {k: v.detach().clone().requires_grad_(True)
                               for k, v in params.items()}
        self.device = next(iter(self.params.values())).device
        self.optimizer = optimizer(list(self.params.values()))
        self.step_count = 0
        self._ckptr = None

    def _micro(self, super_batch: Dict[str, np.ndarray], a: int) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v[a])).to(self.device)
                for k, v in super_batch.items()}

    def step(self, super_batch: Dict[str, np.ndarray],
             generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        """One update from an (accum, B, ...) super-batch.  Returns the mean
        loss and aux metrics, ``grad_norm`` (before clipping) and
        ``skipped`` (1.0 when the norm was not finite), fetched at once."""
        self.optimizer.zero_grad(set_to_none=True)
        lsum = torch.zeros((), device=self.device)
        asum: Dict[str, torch.Tensor] = {}
        for a in range(self.accum):
            loss, aux = self.loss_fn(self.params, generator, self._micro(super_batch, a))
            (loss / self.accum).backward()
            lsum = lsum + loss.detach().float()
            for k, v in aux.items():
                asum[k] = asum.get(k, 0.0) + torch.as_tensor(v).detach().float()
        leaves = list(self.params.values())
        gnorm = clip_by_global_norm(leaves, self.grad_clip)
        finite = bool(torch.isfinite(gnorm))
        if finite:
            self.optimizer.step()
        self.step_count += 1
        metrics = {"loss": lsum / self.accum, "grad_norm": gnorm,
                   "skipped": torch.tensor(0.0 if finite else 1.0, device=self.device),
                   **{k: v / self.accum for k, v in asum.items()}}
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].to(self.device).float() for k in keys]).cpu().tolist()
        return dict(zip(keys, vals))

    def evaluate_loss(self, batch: Dict[str, np.ndarray], loss_fn: Optional[Callable] = None,
                      generator: Optional[torch.Generator] = None) -> float:
        """The loss of one (B, ...) batch without a gradient (``loss_fn``
        defaults to the training one: pass an eval-mode one for CV)."""
        with torch.no_grad():
            b = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}
            return float((loss_fn or self.loss_fn)(self.params, generator, b)[0])

    # -- checkpoints (train_utils.py:195-214 save_model, bin/train.py:135-153
    # resume) -------------------------------------------------------------

    def _checkpointer(self, directory: str, keep: Optional[int] = None,
                      async_save: Optional[bool] = None):
        from .checkpoint import TrainCheckpointer

        if self._ckptr is None or self._ckptr.directory != os.path.abspath(directory):
            if self._ckptr is not None:
                self._ckptr.close()
            self._ckptr = TrainCheckpointer(directory)
        if keep is not None:
            self._ckptr.keep = keep
        if async_save is not None:
            self._ckptr.async_save = async_save
        return self._ckptr

    def save_checkpoint(self, directory: str, keep: int = 3, async_save: bool = True) -> int:
        """Parameters, optimizer state and step at the current step.  With
        ``async_save`` it returns once the host copy is taken."""
        ck = self._checkpointer(directory, keep=keep, async_save=async_save)
        ck.save(self.step_count, {"params": self.params,
                                  "opt_state": self.optimizer.state_dict()})
        return self.step_count

    def load_checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        """Restore parameters and optimizer state in place and resume the step
        counter; returns the step loaded."""
        ck = self._checkpointer(directory)
        step = ck.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        tree = ck.restore(step=step)
        if set(tree["params"]) != set(self.params):
            raise KeyError("checkpoint parameters differ from the trainer's")
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(tree["params"][k])
        self.optimizer.load_state_dict(tree["opt_state"])
        self.step_count = int(step)
        return self.step_count

    def close(self) -> None:
        """Drain a pending asynchronous save."""
        if self._ckptr is not None:
            self._ckptr.close()

    def save_model(self, path: str, info: Optional[Dict] = None) -> str:
        """Reference-format ``.pt`` + yaml sidecar, loadable by stock
        CosyVoice and by ``params.load_torch_checkpoint``."""
        from .checkpoint import save_model_pt

        return save_model_pt(self.params, path, info={"step": self.step_count, **(info or {})})
