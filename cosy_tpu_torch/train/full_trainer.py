"""Full-parameter trainer with data, tensor, sequence and pipeline
parallelism and ZeRO-2 (the port of the JAX package's
``train/full_trainer.py``).

Reference behavior: the vendored multi-GPU trainer path
(cosyvoice/bin/train.py, utils/executor.py, utils/train_utils.py): DDP
gradient all-reduce, optional DeepSpeed ZeRO-2 optimizer-state sharding,
gradient accumulation, clipping by global norm with the inf/nan skip, a
per-step optimizer update.

Eager PyTorch, one process per device over ``torch.distributed``:

- **data parallelism**: each rank runs its rows of every micro-batch
  (``parallel.mesh.batch_rows``: whole-batch random draws, batch-wide
  denominators) and the gradient is the mean over the ``dp`` group, one
  flat all-reduce a step;
- **ZeRO-2**: the AdamW moments of each leaf split over ``dp`` along the
  axis ``parallel.tp.compose_zero2`` picks; each rank updates its slice
  and the parameters are all-gathered whole (or tp-split) after the step;
- **tensor parallelism**: the transformer products split over ``model`` by
  ``parallel.tp.tp_spec`` (every family's rules); each rank keeps and
  updates its block of those leaves;
- **sequence parallelism**: the estimator's transformer stacks run on each
  ``seq`` rank's frames (``parallel.sp``);
- **pipeline parallelism**: eligible transformer stacks run as a GPipe
  pipeline over ``model`` (``parallel.pp``).

The clip and the inf/nan skip see the global gradient norm, so every rank
takes the same branch.  Without a mesh and a process group every
collective is skipped: a world of one is the one-device trainer.  A
non-finite norm skips the update, leaving the parameters and the
optimizer's moments (and its step count) untouched (train_utils.py:
305-315).

Every trainer here runs the plain differentiable ops: the kernel wrappers
refuse an input that requires a gradient, and the layers' gates keep
``Ctx(train=True)`` off them, as the JAX package's gates keep training off
its Pallas kernels.
"""

from __future__ import annotations

import os
from contextlib import ExitStack
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel import comm
from ..parallel import mesh as pmesh
from ..parallel import tp as TP
from ..params import Params

LossFn = Callable[[Params, Optional[torch.Generator], Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
OptimizerFn = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerFn:
    """``optax.adamw``'s defaults as a factory of ``torch.optim.AdamW``
    (whose own weight decay default is 1e-2)."""
    def make(params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)
    return make


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """Step ``step``'s own generator (JAX folds the step into its key)."""
    return torch.Generator(device=device).manual_seed(seed * 100_003 + step)


def zero2_sharding(mesh, tree: Dict[str, torch.Tensor]) -> Dict[str, TP.Spec]:
    """Per-leaf ZeRO-2 layouts: the first axis that divides by the dp size
    splits over ``dp``; scalars and indivisible leaves stay whole."""
    return TP.compose_zero2(mesh, tree)


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


def dp_mean_grads(leaves: List[torch.Tensor], mesh) -> None:
    """Average the leaves' ``.grad`` (a missing one counts as zero) over the
    mesh's dp group: one flat all-reduce (the DDP all-reduce)."""
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    group = None if mesh is None else mesh.group("dp")
    if group is None:
        return
    flat = torch.cat([p.grad.reshape(-1).float() for p in leaves])
    comm.all_reduce_(flat, group)
    flat /= mesh.size("dp")
    i = 0
    for p in leaves:
        n = p.numel()
        p.grad.copy_(flat[i:i + n].view_as(p.grad))
        i += n


def dp_mean_metrics(values: torch.Tensor, mesh) -> torch.Tensor:
    """A vector of per-rank metrics averaged over dp (each rank's is the
    mean over its rows)."""
    group = None if mesh is None else mesh.group("dp")
    if group is None:
        return values
    return comm.all_reduce_(values.clone(), group) / mesh.size("dp")


class FullTrainer:
    """Train all parameters of ``loss_fn(params, generator, micro_batch) ->
    (loss, aux metrics)``, where ``params`` is the flat ``{name: tensor}``
    dict the port's model functions read through ``P`` (under tensor
    parallelism its split leaves hold this rank's block)."""

    def __init__(self, loss_fn: LossFn, params, optimizer: OptimizerFn = adamw(1e-4),
                 mesh=None, zero2: bool = True, grad_clip: float = 5.0, accum: int = 1,
                 tensor_parallel: bool = False, sequence_parallel: bool = False,
                 pipeline_parallel_microbatches: int = 0):
        """``mesh`` defaults to ``make_mesh()`` over the world (a mesh of
        one without a process group).  ``tensor_parallel`` splits the
        transformer products over its ``model`` axis; ``sequence_parallel``
        the estimator's frames over ``seq``; ``pipeline_parallel_
        microbatches`` = M > 0 runs eligible transformer stacks as a
        pipeline of M microbatches over ``model``."""
        if isinstance(params, torch.nn.Module):
            params = dict(params.named_parameters())
        self.device = next(iter(params.values())).device
        self.mesh = mesh if mesh is not None else pmesh.make_mesh(device=self.device)
        self.loss_fn = loss_fn
        self.zero2 = zero2
        self.grad_clip = grad_clip
        self.accum = accum
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = sequence_parallel
        self.pp_micro = pipeline_parallel_microbatches
        whole = {k: v.detach() for k, v in params.items()}
        self._shapes = {k: v.shape for k, v in whole.items()}
        self.param_specs: Dict[str, TP.Spec] = (
            TP.tp_param_shardings(self.mesh, whole) if tensor_parallel
            else {k: () for k in whole})
        self.tp_layout = {k: TP.spec_axis(s, "model") for k, s in self.param_specs.items()}
        self.opt_specs = (TP.compose_zero2(self.mesh, whole, self.param_specs) if zero2
                          else dict(self.param_specs))
        # the trainer's own leaves (this rank's block of split ones); the
        # caller's tensors stay as they were
        self.params: Params = {
            k: TP.local_shard(v, self.param_specs[k], self.mesh).clone().requires_grad_(True)
            for k, v in whole.items()}
        # what the optimizer updates: a leaf itself, or under ZeRO-2 this
        # rank's dp slice of it
        self._zaxis = {k: TP.spec_axis(s, "dp") for k, s in self.opt_specs.items()}
        self.masters: Params = {}
        for k, p in self.params.items():
            a = self._zaxis[k]
            self.masters[k] = p if a is None else comm.local_slice(
                p.detach(), a, self.mesh.coord("dp"), self.mesh.size("dp")).clone() \
                .requires_grad_(True)
        self.optimizer = optimizer(list(self.masters.values()))
        self.step_count = 0
        self._ckptr = None

    # -- the step -------------------------------------------------------

    def _contexts(self, stack: ExitStack, rows: Tuple[int, int, int]) -> None:
        stack.enter_context(pmesh.batch_rows(self.mesh, *rows))
        if self.tensor_parallel:
            stack.enter_context(TP.tensor_parallel(self.mesh, self.tp_layout))
        if self.sequence_parallel:
            from ..parallel.sp import sequence_sharding

            stack.enter_context(sequence_sharding(self.mesh))
        if self.pp_micro > 0:
            from ..parallel.pp import pipeline_context

            stack.enter_context(pipeline_context(self.mesh, self.pp_micro))

    def _micro(self, super_batch: Dict[str, np.ndarray], a: int, lo: int, hi: int
               ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v[a][lo:hi])).to(self.device)
                for k, v in super_batch.items()}

    def _global_norm(self) -> torch.Tensor:
        """The norm of the whole gradient: a split leaf's squares sum over
        the ranks that hold its blocks."""
        whole = torch.zeros((), device=self.device)
        split = torch.zeros((), device=self.device)
        for k, p in self.params.items():
            s = torch.sum(torch.square(p.grad.float()))
            if self.tp_layout[k] is None:
                whole = whole + s
            else:
                split = split + s
        comm.all_reduce_(split, self.mesh.group("model"))
        return torch.sqrt(whole + split)

    def step(self, super_batch: Dict[str, np.ndarray],
             generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        """One update from an (accum, B, ...) super-batch (every rank passes
        the whole of it and runs its dp rows).  Returns the mean loss and
        aux metrics, ``grad_norm`` (before clipping) and ``skipped`` (1.0
        when the norm was not finite), fetched at once."""
        for p in self.params.values():
            p.grad = None
        B = next(iter(super_batch.values())).shape[1]
        lo, hi = pmesh.dp_rows(self.mesh, B)
        lsum = torch.zeros((), device=self.device)
        asum: Dict[str, torch.Tensor] = {}
        for a in range(self.accum):
            with ExitStack() as stack:
                self._contexts(stack, (lo, hi, B))
                loss, aux = self.loss_fn(self.params, generator,
                                         self._micro(super_batch, a, lo, hi))
                (loss / self.accum).backward()
            lsum = lsum + loss.detach().float()
            for k, v in aux.items():
                asum[k] = asum.get(k, 0.0) + torch.as_tensor(v).detach().float()
        leaves = list(self.params.values())
        dp_mean_grads(leaves, self.mesh)
        gnorm = self._global_norm()
        factor = self.grad_clip / torch.clamp(gnorm, min=self.grad_clip)
        finite = bool(torch.isfinite(gnorm))
        if finite:
            for k, p in self.params.items():
                g = p.grad * factor.to(p.grad.dtype)
                m, a = self.masters[k], self._zaxis[k]
                m.grad = g if a is None else comm.local_slice(
                    g, a, self.mesh.coord("dp"), self.mesh.size("dp")).contiguous()
            self.optimizer.step()
            self._gather_masters()
        self.step_count += 1
        keys = ["loss"] + sorted(asum)
        vals = torch.stack([lsum / self.accum] + [asum[k].reshape(-1).mean() / self.accum
                                                  for k in keys[1:]])
        vals = dp_mean_metrics(vals.to(self.device), self.mesh)
        metrics = dict(zip(keys, vals.cpu().tolist()))
        metrics["grad_norm"] = float(gnorm)
        metrics["skipped"] = 0.0 if finite else 1.0
        return metrics

    def _gather_masters(self) -> None:
        """ZeRO-2: every leaf whole (or its tp block) again from the dp
        ranks' updated slices."""
        with torch.no_grad():
            for k, a in self._zaxis.items():
                if a is not None:
                    self.params[k].copy_(comm.all_gather_cat(
                        self.masters[k].detach(), a, self.mesh.group("dp")))

    def evaluate_loss(self, batch: Dict[str, np.ndarray], loss_fn: Optional[Callable] = None,
                      generator: Optional[torch.Generator] = None) -> float:
        """The loss of one (B, ...) batch without a gradient (``loss_fn``
        defaults to the training one: pass an eval-mode one for CV), over
        the dp ranks' rows like a step."""
        B = next(iter(batch.values())).shape[0]
        lo, hi = pmesh.dp_rows(self.mesh, B)
        with torch.no_grad(), ExitStack() as stack:
            self._contexts(stack, (lo, hi, B))
            b = {k: torch.as_tensor(np.asarray(v)[lo:hi]).to(self.device)
                 for k, v in batch.items()}
            loss = (loss_fn or self.loss_fn)(self.params, generator, b)[0]
            return float(dp_mean_metrics(loss.detach().float().reshape(1), self.mesh)[0])

    # -- checkpoints (train_utils.py:195-214 save_model, bin/train.py:135-153
    # resume).  Rank 0 writes whole tensors; every rank reads them back into
    # its own layout, so a checkpoint crosses mesh layouts --------------

    def whole_params(self) -> Params:
        """Every leaf whole (tp blocks gathered; every rank takes part)."""
        return {k: TP.gather_whole(p.detach(), self.param_specs[k], self.mesh)
                for k, p in self.params.items()}

    def _whole_opt_state(self) -> dict:
        """The optimizer state keyed by parameter name with whole moments."""
        sd = self.optimizer.state_dict()
        names = list(self.masters)
        state = {}
        for i, st in sd["state"].items():
            k = names[i]
            state[k] = {n: (TP.gather_whole(v, self.opt_specs[k], self.mesh)
                            if torch.is_tensor(v) and v.shape == self.masters[k].shape
                            and v.dim() > 0 else v)
                        for n, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def _load_opt_state(self, whole: dict) -> None:
        """Load a name-keyed state of whole moments into this rank's slices."""
        names = list(self.masters)
        state = {}
        for i, k in enumerate(names):
            if k in whole["state"]:
                state[i] = {n: (TP.local_shard(v, self.opt_specs[k], self.mesh).clone()
                                if torch.is_tensor(v) and v.shape == self._shapes[k]
                                and v.dim() > 0 else v)
                            for n, v in whole["state"][k].items()}
        self.optimizer.load_state_dict({"state": state, "param_groups": whole["param_groups"]})

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
        """Parameters, optimizer state and step at the current step, whole
        tensors written by rank 0.  With ``async_save`` it returns once the
        host copy is taken."""
        tree = {"params": self.whole_params(), "opt_state": self._whole_opt_state()}
        if pmesh.is_main():
            self._checkpointer(directory, keep=keep, async_save=async_save).save(
                self.step_count, tree)
        return self.step_count

    def load_checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        """Restore parameters and optimizer state into this rank's layout
        and resume the step counter; returns the step loaded."""
        from .checkpoint import wait_written

        ck = self._checkpointer(directory)
        wait_written(ck)
        step = ck.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        tree = ck.restore(step=step)
        if set(tree["params"]) != set(self.params):
            raise KeyError("checkpoint parameters differ from the trainer's")
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(TP.local_shard(tree["params"][k], self.param_specs[k], self.mesh))
                a = self._zaxis[k]
                if a is not None:
                    self.masters[k].copy_(comm.local_slice(
                        p, a, self.mesh.coord("dp"), self.mesh.size("dp")))
        self._load_opt_state(tree["opt_state"])
        self.step_count = int(step)
        return self.step_count

    def close(self) -> None:
        """Drain a pending asynchronous save."""
        if self._ckptr is not None:
            self._ckptr.close()

    def save_model(self, path: str, info: Optional[Dict] = None) -> str:
        """Reference-format ``.pt`` + yaml sidecar, loadable by stock
        CosyVoice and by ``params.load_torch_checkpoint``; whole tensors,
        written by rank 0."""
        from .checkpoint import save_model_pt

        whole = self.whole_params()
        if pmesh.is_main():
            save_model_pt(whole, path, info={"step": self.step_count, **(info or {})})
        return path
