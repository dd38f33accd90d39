"""Joint LLM + Flow LoRA trainer (the port of the JAX package's
``train/trainer.py``): AdamW on the adapters only, gradient accumulation
over an (accum, B, ...) super-batch, clipping by global norm, a step -> lr
schedule, loss-threshold and early-stop rules, top-k checkpoints and the
merged-weight export the serving path loads.

One device, eager PyTorch: a step is a Python loop of micro-batches, each
``backward()`` adding into the adapters' ``.grad``.  The base weights are
frozen (``requires_grad=False``) and never enter a hand-written kernel here:
the gates in ``layers`` keep training on differentiable torch ops.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..lora import init_lora, merge_lora
from ..models.joint import joint_forward_train
from ..params import Params
from .schedules import make_schedule

_METRIC_KEYS = {"joint": ("loss", "llm_loss", "llm_acc", "flow_loss"),
                "llm_only": ("loss", "llm_loss", "llm_acc"),
                "flow_only": ("loss", "flow_loss")}


def _leaves(loras: Dict[str, Params]) -> List[torch.Tensor]:
    """The adapter tensors in one fixed order (the optimizer's)."""
    return [t for name in sorted(loras) for _, t in sorted(loras[name].items())]


@dataclass
class TrainState:
    loras: Dict[str, Params]  # 'llm' / 'flow' -> f32 adapter leaves
    optimizer: torch.optim.AdamW  # f32 moments over those leaves
    step: int = 0

    def leaves(self) -> List[torch.Tensor]:
        return _leaves(self.loras)


def _frozen(module) -> Params:
    return {} if module is None else {k: v.detach() for k, v in module.named_parameters()}


def save_weight_meta(path: str, **meta):
    """Write the ``<path>.meta.json`` provenance sidecar of a weight file
    (the state dict itself stays a plain ``.pt``): e.g. whether a flow
    checkpoint works in normalized mel space."""
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=0, sort_keys=True)


class JointTrainer:
    """``llm`` / ``flow`` are the port's ``TransformerLM`` / ``Flow`` modules
    (either may be None for a mode that does not train it), all on one
    device.  With ``TrainConfig.bf16`` the step computes on a bf16 copy of
    the base weights and bf16 activations, while the adapters and the
    optimizer state stay f32 and there is no loss scaler; the merge always
    goes into the f32 weights."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig, llm, flow,
                 out_dir: str = "output", total_steps: int = 10_000):
        if train_cfg.training_mode not in _METRIC_KEYS:
            raise ValueError(f"unknown training_mode {train_cfg.training_mode!r}")
        self.cfg = model_cfg
        self.tcfg = train_cfg
        self.llm_master, self.flow_master = _frozen(llm), _frozen(flow)
        if train_cfg.bf16:
            self.llm_params = {k: v.to(torch.bfloat16) for k, v in self.llm_master.items()}
            self.flow_params = {k: v.to(torch.bfloat16) for k, v in self.flow_master.items()}
        else:
            self.llm_params, self.flow_params = self.llm_master, self.flow_master
        self.device = next(iter((self.llm_master or self.flow_master).values())).device
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.schedule = make_schedule(train_cfg, total_steps)
        self._metrics_log: List[dict] = []
        self._best: List[Tuple[float, str]] = []  # (loss, path) top-k

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _optimizer(self, loras: Dict[str, Params]) -> torch.optim.AdamW:
        return torch.optim.AdamW(_leaves(loras), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.tcfg.weight_decay)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   loras: Optional[Dict[str, Params]] = None) -> TrainState:
        """Fresh adapters drawn from ``generator`` (on the trainer's
        device), or the given ones (e.g. carried over with
        ``lora.lora_from_numpy``), with a zeroed optimizer."""
        if loras is None:
            loras = {}
            if self.tcfg.training_mode in ("joint", "llm_only"):
                loras["llm"] = init_lora(generator, self.llm_master, self.tcfg.llm_lora)
            if self.tcfg.training_mode in ("joint", "flow_only"):
                loras["flow"] = init_lora(generator, self.flow_master, self.tcfg.flow_lora)
        return TrainState(loras=loras, optimizer=self._optimizer(loras), step=0)

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    def _micro(self, super_batch: Dict[str, np.ndarray], a: int) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in super_batch.items():
            t = torch.as_tensor(v[a]).to(self.device)
            if self.tcfg.bf16 and t.dtype == torch.float32:
                t = t.to(torch.bfloat16)
            out[k] = t
        return out

    def _forward(self, state: TrainState, micro, generator, train: bool):
        return joint_forward_train(self.llm_params, self.flow_params, state.loras,
                                   self.cfg, self.tcfg, generator, micro, train=train)

    def step(self, state: TrainState, super_batch: Dict[str, np.ndarray],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One optimizer update from an (accum, B, ...) super-batch: the mean
        gradient over the micro-batches, clipped to ``gradient_clip_val`` by
        its global norm, then AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled
        weight decay) at ``schedule(state.step)``.  Returns the mean metrics
        with ``grad_norm`` (before clipping) and ``lr`` as 0-d tensors on the
        device; nothing here waits for the device."""
        accum = self.tcfg.accumulate_grad_batches
        leaves = state.leaves()
        state.optimizer.zero_grad(set_to_none=True)
        msum = {k: torch.zeros((), dtype=torch.float32, device=self.device)
                for k in _METRIC_KEYS[self.tcfg.training_mode]}
        for a in range(accum):
            losses = self._forward(state, self._micro(super_batch, a), generator, True)
            (losses["loss"].float() / accum).backward()
            for k in msum:
                msum[k] += losses[k].detach().float()
        metrics = {k: v / accum for k, v in msum.items()}

        grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        clip = self.tcfg.gradient_clip_val
        factor = clip / torch.clamp(gnorm, min=clip)  # 1 below the threshold
        for t, g in zip(leaves, grads):
            t.grad = g * factor
        lr = self.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics["grad_norm"] = gnorm
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32, device=self.device)
        return metrics

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------

    def evaluate(self, loader: Iterable, state: TrainState,
                 generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        """Mean eval-mode losses over a loader of super-batches (dropout off,
        no update), as ``cv_<metric>`` floats."""
        keys = _METRIC_KEYS[self.tcfg.training_mode]
        rows = []
        with torch.no_grad():
            for super_batch in loader:
                per = [self._forward(state, self._micro(super_batch, a), generator, False)
                       for a in range(self.tcfg.accumulate_grad_batches)]
                rows.append(torch.stack([torch.stack([m[k].float() for m in per]).mean()
                                         for k in keys]))
        if not rows:
            return {}
        avg = torch.stack(rows).mean(dim=0).cpu().tolist()  # one fetch
        return {"cv_" + k: float(v) for k, v in zip(keys, avg)}

    # ------------------------------------------------------------------
    # fit loop
    # ------------------------------------------------------------------

    def fit(self, loader: Iterable, state: Optional[TrainState] = None,
            generator: Optional[torch.Generator] = None,
            max_epochs: Optional[int] = None, resume: Optional[str] = None,
            log_every: int = 10) -> TrainState:
        """Epochs over ``loader`` (super-batches) with per-epoch top-k and
        ``last`` checkpoints, the loss-threshold stop and early stopping.
        Metrics stay on the device until a print point or the epoch's end."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        if state is None:
            state = self.init_state(generator)
        if resume:
            state = self.load_checkpoint(resume, state)
            print(f"Resumed from {resume} at step {state.step}")

        max_epochs = max_epochs or self.tcfg.max_epochs
        best_epoch_loss = float("inf")
        epochs_no_improve = 0
        metrics_path = os.path.join(self.out_dir, "metrics.jsonl")
        for epoch in range(max_epochs):
            t0 = time.time()
            mkeys: Optional[List[str]] = None
            packed: List[torch.Tensor] = []
            step_ids: List[int] = []
            for super_batch in loader:
                m = self.step(state, super_batch, generator)
                if mkeys is None:
                    mkeys = sorted(m)
                packed.append(torch.stack([m[k].float() for k in mkeys]))
                step_ids.append(state.step)
                if state.step % log_every == 0:
                    line = " ".join(f"{k}={v:.4f}" for k, v in zip(mkeys, packed[-1].tolist()))
                    print(f"epoch {epoch} step {state.step}: {line}")
            if not packed:
                print("empty epoch - no data")
                break

            rows = torch.stack(packed).cpu().tolist()  # one fetch for the epoch
            epoch_metrics = [dict(zip(mkeys, row)) for row in rows]
            for sid, m_host in zip(step_ids, epoch_metrics):
                self._metrics_log.append({"epoch": epoch, "step": sid, **m_host})
            avg = {k: float(np.mean([m[k] for m in epoch_metrics])) for k in mkeys}
            print(f"== epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(avg.items()))
                  + f" ({time.time() - t0:.1f}s, {len(epoch_metrics)} steps)")
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, **avg}) + "\n")

            self._save_topk(state, epoch, avg["loss"])
            self.save_checkpoint(os.path.join(
                self.out_dir, f"joint_{self.tcfg.training_mode}_last.ckpt"), state)

            stop_reason = None
            llm_loss, flow_loss = avg.get("llm_loss"), avg.get("flow_loss")
            if llm_loss is not None and llm_loss <= self.tcfg.llm_loss_threshold:
                stop_reason = f"llm_loss {llm_loss:.4f} <= {self.tcfg.llm_loss_threshold}"
            elif flow_loss is not None and flow_loss <= self.tcfg.flow_loss_threshold:
                stop_reason = f"flow_loss {flow_loss:.4f} <= {self.tcfg.flow_loss_threshold}"

            if avg["loss"] < best_epoch_loss - self.tcfg.early_stop_min_delta:
                best_epoch_loss = avg["loss"]
                epochs_no_improve = 0
            else:
                epochs_no_improve += 1
                if epochs_no_improve >= self.tcfg.early_stop_patience:
                    stop_reason = f"early stop: no improvement for {epochs_no_improve} epochs"
            if stop_reason:
                print(f"Stopping: {stop_reason}")
                break
        return state

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _save_topk(self, state: TrainState, epoch: int, loss: float, k: int = 3):
        path = self.save_checkpoint(os.path.join(
            self.out_dir, f"joint_{self.tcfg.training_mode}_{epoch:02d}_{loss:.4f}.ckpt"), state)
        self._best.append((loss, path))
        self._best.sort(key=lambda x: x[0])
        for _, stale in self._best[k:]:
            if os.path.exists(stale):
                os.remove(stale)
        self._best = self._best[:k]

    def save_checkpoint(self, path: str, state: TrainState) -> str:
        """Adapters, optimizer state and step as one ``.pt`` of tensors."""
        if not path.endswith(".pt"):
            path = path + ".pt"
        torch.save({"loras": {n: {k: v.detach().cpu() for k, v in d.items()}
                              for n, d in state.loras.items()},
                    "optimizer": state.optimizer.state_dict(), "step": state.step}, path)
        return path

    def load_checkpoint(self, path: str, template: TrainState) -> TrainState:
        """Restore a checkpoint into the structure of ``template`` (a state
        from ``init_state`` of the same config)."""
        if not os.path.exists(path) and os.path.exists(path + ".pt"):
            path = path + ".pt"
        blob = torch.load(path, map_location="cpu", weights_only=True)
        loras = {}
        for name, d in template.loras.items():
            if set(blob["loras"].get(name, ())) != set(d):
                raise ValueError(f"checkpoint {path} does not hold the {name} adapters "
                                 "of this configuration")
            loras[name] = {k: blob["loras"][name][k].to(self.device, torch.float32)
                           .requires_grad_(True) for k in d}
        optimizer = self._optimizer(loras)
        optimizer.load_state_dict(blob["optimizer"])
        return TrainState(loras=loras, optimizer=optimizer, step=int(blob["step"]))

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------

    def export_merged(self, state: TrainState, save: bool = True) -> Dict[str, Params]:
        """W' = W + BA * scale over the f32 base weights, per trained model;
        with ``save`` writes ``<name>_merged_<mode>.pt`` (plain state dicts
        the serving path loads) and, for the flow, the sidecar that records
        the normalized mel space the fine-tune works in."""
        out: Dict[str, Params] = {}
        if "llm" in state.loras:
            out["llm"] = merge_lora(self.llm_master, state.loras["llm"],
                                    self.tcfg.llm_lora.scaling)
        if "flow" in state.loras:
            out["flow"] = merge_lora(self.flow_master, state.loras["flow"],
                                     self.tcfg.flow_lora.scaling)
        if save:
            for name, params in out.items():
                path = os.path.join(self.out_dir,
                                    f"{name}_merged_{self.tcfg.training_mode}.pt")
                torch.save({k: v.cpu() for k, v in params.items()}, path)
                if name == "flow":
                    save_weight_meta(path, mel_space="normalized",
                                     producer="cosy_tpu_torch.export_merged")
                print(f"saved merged {name} weights -> {path}")
        return out

    def export_adapters(self, state: TrainState, path: Optional[str] = None) -> Params:
        """Adapter-only export: flat keys ``llm.<param path>.lora_A/B`` /
        ``flow.<...>`` plus ``<name>._scaling`` scalars (alpha / r)."""
        out: Params = {}
        for name, cfg in (("llm", self.tcfg.llm_lora), ("flow", self.tcfg.flow_lora)):
            if name in state.loras:
                out.update({f"{name}.{k}": v.detach().float().cpu()
                            for k, v in state.loras[name].items()})
                out[f"{name}._scaling"] = torch.tensor(cfg.scaling, dtype=torch.float32)
        if path is not None:
            torch.save(out, path)
            print(f"saved LoRA adapters -> {path}")
        return out
