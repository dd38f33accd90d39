"""Whole ``JointTrainer.step`` optimizer steps over a small fine-tune set:
the product's own job, a voice fine-tuned on a few tens of clips.

The clips (the mix's quantile table of durations, each drawn once in an
order from the seed) hold speech tokens at the model's token rate, a mel
at its frame rate, text ids at ``text_ids_per_s`` and a speaker
embedding, all drawn from the seed; they reach the trainer through the
port's ``DataLoader`` (its shuffle from the seed, ``collate_static`` and
the ``prefetch`` thread), one super-batch a step.  The adapters are drawn
from the seed by the port's initializer rule.  Step k takes a generator
seeded for it.

Set-up builds the trainer and its state once and drives it through the
first ``check_steps`` steps, which read rows that all differ and warm
every shape (the collation is static); it keeps each step's loss, the
optimizer's first moments after the first step and the adapters after the
last for the reference.  The window then goes on with the same object and
feed: whole steps until ``seconds`` have passed, synchronised at the end.
The rate counts the unpadded audio of every row in the window's steps.
With tracing, the profile spans ``trace_steps`` steps after the window.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import spec, traffic
from ..record import Record
from ..trace import WINDOW_SPAN
from ..yardstick import costs as C

MEL_HOP = 256


def lora_targets(weights: Dict[str, torch.Tensor], target_modules) -> List[str]:
    """Module paths that take adapters: a Linear (2-D weight) or a 1x1
    conv whose last name component contains a target substring (the
    port's documented rule)."""
    out = []
    for k, v in weights.items():
        if not k.endswith(".weight"):
            continue
        path = k[: -len(".weight")]
        if not any(t in path.rsplit(".", 1)[-1] for t in target_modules):
            continue
        if v.ndim == 2 or (v.ndim == 3 and v.shape[-1] == 1):
            out.append(path)
    return sorted(out)


def adapters(weights: Dict[str, torch.Tensor], lora, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 adapters for every target of ``weights``, drawn from ``seed`` in
    two draws: A uniform within 1/sqrt(fan_in) (kaiming-uniform, a = sqrt 5),
    B 0.01 N(0, 1)."""
    shapes = {}
    for path in lora_targets(weights, lora.target_modules):
        w = weights[path + ".weight"]
        conv = (1,) if w.ndim == 3 else ()
        suffix = ".weight" if conv else ""
        shapes[path + ".lora_A" + suffix] = ((lora.r, w.shape[1]) + conv, 1 / math.sqrt(w.shape[1]))
        shapes[path + ".lora_B" + suffix] = ((w.shape[0], lora.r) + conv, None)
    g = torch.Generator(device=device).manual_seed(seed)
    n_a = sum(math.prod(s) for s, b in shapes.values() if b is not None)
    n_b = sum(math.prod(s) for s, b in shapes.values() if b is None)
    flat_a = torch.rand(n_a, generator=g, device=device) * 2 - 1
    flat_b = torch.randn(n_b, generator=g, device=device) * 0.01
    out, ia, ib = {}, 0, 0
    for name in sorted(shapes):
        shape, bound = shapes[name]
        n = math.prod(shape)
        if bound is not None:
            out[name] = (flat_a[ia:ia + n] * bound).view(shape)
            ia += n
        else:
            out[name] = flat_b[ib:ib + n].view(shape)
            ib += n
    return out


def clips(seed: int, t: Dict[str, Any], model) -> List[Dict[str, np.ndarray]]:
    """The fine-tune set: clip i's tokens, mel, text ids and embedding."""
    sizes = traffic.Sizes(t["clip_s"], t["clips"], seed)
    fr = model.flow.input_frame_rate
    out = []
    for i in range(t["clips"]):
        g = traffic.rng(seed, "inputs", i)
        n_tok = max(1, int(round(sizes[i] * fr)))
        n_mel = int(n_tok / fr * model.sample_rate / MEL_HOP)
        n_text = max(1, int(round(sizes[i] * t["text_ids_per_s"])))
        out.append({
            "speech_token": g.integers(0, model.llm.speech_token_size, n_tok).astype(np.int64),
            "speech_feat": (g.standard_normal((n_mel, 80)) * 2.0 - 6.0).astype(np.float32),
            "embedding": g.standard_normal(model.flow.spk_embed_dim).astype(np.float32),
            "text_token": g.integers(0, model.llm.text_token_size, n_text).astype(np.int64),
            "cross_sample_mel": None,
        })
    return out


class Clips:
    """The clips as the map-style dataset the port's loader reads."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


def step_seed(seed: int, k: int) -> int:
    return int(traffic.rng(seed, "seeds", 1_000_000 + k).integers(0, 1 << 62))


class Driver:
    def __init__(self, cell, mods, seed: int, plain):
        from cosy_tpu_torch import config as PC
        from cosy_tpu_torch.data.dataset import DataLoader
        from cosy_tpu_torch.train.trainer import JointTrainer

        t = cell.traffic
        self.cell, self.seed, self.plain, self.t = cell, seed, plain, t
        self.device = next(mods["flow"].parameters()).device
        self.mcfg = spec.build(PC.ModelConfig, cell.config["model"])
        self.tcfg = spec.build(PC.TrainConfig, cell.config["train"])
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench-train-")
        self.trainer = JointTrainer(self.mcfg, self.tcfg, mods["llm"], mods["flow"],
                                    out_dir=self._tmp.name, total_steps=t["total_steps"])
        weights = {k: dict(mods[k].named_parameters()) for k in ("llm", "flow")}
        lcfg = {"llm": self.tcfg.llm_lora, "flow": self.tcfg.flow_lora}
        self.loras0 = {k: adapters(weights[k], lcfg[k], step_seed(seed, -1 - i), self.device)
                       for i, k in enumerate(("llm", "flow"))}
        self.state = self.trainer.init_state(loras={
            k: {n: v.clone().requires_grad_(True) for n, v in d.items()}
            for k, d in self.loras0.items()})
        self.clips = clips(seed, t, plain.model)
        self.loader_seed = step_seed(seed, -3)
        self.loader = DataLoader(Clips(self.clips), self.tcfg, seed=self.loader_seed,
                                 max_text_len=t["max_text_len"],
                                 prefetch_depth=t["prefetch_depth"])
        self._feed = self._epochs()
        self.k = 0
        self.readings: Dict[str, Any] = {}

    @staticmethod
    def inference(cell) -> Dict[str, Any]:
        return {}

    @staticmethod
    def dtype(cell) -> str:
        """The type the step computes in: bfloat16 base weights and
        activations where the training config says ``bf16``."""
        return "bfloat16" if cell.config["train"]["bf16"] else cell.config["dtype"]

    @staticmethod
    def build(config, seed, device, inference):
        from .. import system

        return system.modules(config, seed, device)

    def _epochs(self):
        while True:
            yield from self.loader

    def _step(self):
        """One optimizer step on the next super-batch; (metrics, seconds
        waited for the batch, seconds of unpadded audio in it)."""
        t0 = time.perf_counter()
        batch = next(self._feed)
        waited = time.perf_counter() - t0
        gen = torch.Generator(device=self.device).manual_seed(step_seed(self.seed, self.k))
        metrics = self.trainer.step(self.state, batch, gen)
        self.k += 1
        audio = float(np.sum(batch["speech_feat_len"])) * MEL_HOP / self.mcfg.sample_rate
        return metrics, waited, audio

    def warm(self):
        losses = []
        for k in range(self.t["check_steps"]):
            metrics, _, _ = self._step()
            losses.append(float(metrics["loss"]))
            if k == 0:
                opt = self.state.optimizer
                self.readings["first_moments"] = {
                    n: opt.state[v]["exp_avg"].detach().clone()
                    for n, v in self._named_leaves().items()}
        self.readings["losses"] = losses
        self.readings["adapters"] = {n: v.detach().clone()
                                     for n, v in self._named_leaves().items()}

    def _named_leaves(self) -> Dict[str, torch.Tensor]:
        return {f"{k}/{n}": v for k in sorted(self.state.loras)
                for n, v in sorted(self.state.loras[k].items())}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def measure(self, seconds: float, tracer) -> Record:
        self._sync()
        t_open = time.perf_counter()
        waits, audio, steps = [], 0.0, 0
        while steps == 0 or time.perf_counter() < t_open + seconds:
            _, waited, a = self._step()
            waits.append(waited)
            audio += a
            steps += 1
        self._sync()
        rec = Record(window_s=time.perf_counter() - t_open, attempted=steps, failed=0)
        rec.audio_s, rec.loader_wait_s = audio, waits
        if tracer.on:  # the traced steps follow the measured window
            tracer.start()
            with torch.profiler.record_function(WINDOW_SPAN):
                for _ in range(self.t["trace_steps"]):
                    self._step()
                self._sync()
            tracer.stop()
            rec.traced_steps = self.t["trace_steps"]
            tc = self.plain.model
            f = C.joint_step_flops(tc, self.tcfg, self.tcfg.batch_size,
                                   self.tcfg.accumulate_grad_batches, self.t["max_text_len"],
                                   self.tcfg.max_token_len, self.tcfg.max_feat_len)
            rec.traced_flops = f * rec.traced_steps
        return rec

    def close(self):
        self._feed.close()
        self._tmp.cleanup()
        self.trainer = self.state = None

    def samples(self, check_seed: int) -> List[Dict[str, Any]]:
        """The set-up's first steps as the reference follows them: their
        inputs (the clips, the loader's and the steps' seeds, the initial
        adapters) and the program's readings."""
        return [dict(self.readings, clips=self.clips, loader_seed=self.loader_seed,
                     step_seeds=[step_seed(self.seed, k) for k in range(self.t["check_steps"])],
                     initial=self.loras0, total_steps=self.t["total_steps"],
                     max_text_len=self.t["max_text_len"])]
