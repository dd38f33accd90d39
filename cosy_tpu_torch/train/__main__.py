"""Joint LLM + Flow LoRA training from the command line (the port's
counterpart of ``train_joint.py``).

    python -m cosy_tpu_torch.train --data-dir data [--mode joint]
        [--resume CKPT] [--pretrained pretrained_models/CosyVoice-300M]
        [--epochs N] [--batch-size N] [--lr LR] [--output output]
        [--max-feat-len N] [--accum N] [--no-augmentation] [--tiny]
        [--batched-micro | --reference-layout] [--device cuda|cpu]

    torchrun --nproc-per-node G -m cosy_tpu_torch.train ...

The flags, their conflicts and the batch folding are ``train_joint.py``'s.
``main()`` parses them and reads the parquet records of ``--data-dir``
(``data.list`` or every ``*.parquet`` below it) into a
``FlowFinetuneDataset``; :func:`run` does the rest: the base weights
(``--pretrained`` loaded strictly, else a seeded random init), the
prefetching ``DataLoader`` of (accum, batch, ...) super-batches,
``JointTrainer.fit`` with ``--resume``, then the merged weights
(``<name>_merged_<mode>.pt``) and the adapters (``adapters_<mode>.pt``) in
``--output``.

Under ``torchrun`` each rank drives one GPU (``cuda:LOCAL_RANK`` over
NCCL; with ``--device cpu`` the CPU over gloo) and the world is the
data-parallel mesh: ``--batch-size`` (the global batch) is rounded up to
the dp size, as ``train_joint.py`` does, and each rank reads its shard of
the records (``DataLoader(num_shards=world, shard_index=rank)``) at
``batch_size / dp`` rows a micro-batch.  Rank 0 logs and writes the
checkpoints and exports.  Without a launcher the run is a world of one.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Iterator, Optional

from ..compat.loader import load_or_init
from ..config import ModelConfig, TrainConfig, replace, tiny_model_config
from ..data.dataset import DataLoader, FlowFinetuneDataset
from ..parallel.mesh import (finish_distributed, init_distributed, is_main, make_mesh,
                             world_rank, world_size)
from .trainer import JointTrainer, TrainState


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Joint LLM+Flow LoRA training (PyTorch port)",
        epilog="Under torchrun --nproc-per-node G every rank trains data-parallel on "
               "its shard of the records.")
    ap.add_argument("--mode", default="joint", choices=["joint", "llm_only", "flow_only"])
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--pretrained", default="pretrained_models/CosyVoice-300M")
    ap.add_argument("--output", default="output")
    ap.add_argument("--max-feat-len", type=int, default=None)
    ap.add_argument("--accum", type=int, default=None, help="gradient accumulation steps")
    ap.add_argument("--no-augmentation", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test topology (toy widths; not checkpoint-compatible)")
    ap.add_argument("--batched-micro", action="store_true",
                    help="fold accumulation into the batch dim at the same effective "
                         "batch (a no-op at the bs8 x accum2 default)")
    ap.add_argument("--reference-layout", action="store_true",
                    help="the reference's bs1 x grad-accum-16 layout instead of the "
                         "default bs8 x accum2 (same effective batch)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train_config(args: argparse.Namespace) -> TrainConfig:
    """``train_joint.py``'s TrainConfig of the flags, with its conflict
    rule and its power-of-two batch folding."""
    tcfg = TrainConfig(training_mode=args.mode)
    if args.epochs:
        tcfg = replace(tcfg, max_epochs=args.epochs)
    if args.batch_size:
        tcfg = replace(tcfg, batch_size=args.batch_size)
    if args.lr:
        tcfg = replace(tcfg, learning_rate=args.lr)
    if args.max_feat_len:
        tcfg = replace(tcfg, max_feat_len=args.max_feat_len)
    if args.accum:
        tcfg = replace(tcfg, accumulate_grad_batches=args.accum)
    if args.reference_layout:
        if args.batch_size or args.accum:
            raise SystemExit("--reference-layout conflicts with explicit "
                             "--batch-size/--accum")
        tcfg = replace(tcfg, batch_size=1, accumulate_grad_batches=16)
    elif args.batched_micro and tcfg.accumulate_grad_batches > 1:
        # fold micro-batches into the batch dim only by powers of two that
        # divide accum exactly, so the effective batch is unchanged
        accum = tcfg.accumulate_grad_batches
        shift = min(3, (accum & -accum).bit_length() - 1)
        tcfg = replace(tcfg, batch_size=tcfg.batch_size * (1 << shift),
                       accumulate_grad_batches=accum >> shift)
    return tcfg


class _TimedLoader:
    """Iterates a loader and adds up the seconds its consumer waited for
    each super-batch (the prefetch thread's lag behind the steps)."""

    def __init__(self, loader: DataLoader):
        self.loader = loader
        self.wait = 0.0
        self.batches = 0

    def __iter__(self) -> Iterator:
        it = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.wait += time.perf_counter() - t0
                self.batches += 1
                yield batch
        finally:
            it.close()


@dataclass
class RunResult:
    trainer: JointTrainer
    state: TrainState
    steps: int  # optimizer steps taken by this run
    seconds: float  # wall seconds of fit()
    loader_wait: float  # seconds fit() waited for batches


def run(dataset: FlowFinetuneDataset, model_cfg: ModelConfig, tcfg: TrainConfig,
        pretrained: Optional[str], output: str, device="cuda",
        resume: Optional[str] = None) -> RunResult:
    """Everything after the dataset: the process group under a launcher,
    base weights, this rank's loader, ``fit`` (from ``resume`` when given),
    the merged and adapter exports.  Prints the seconds a step and the
    loader's wait a step."""
    dev = init_distributed(device)
    mesh = make_mesh(device=dev)
    dp = mesh.size("dp")
    if tcfg.batch_size % dp != 0:
        tcfg = replace(tcfg, batch_size=((tcfg.batch_size + dp - 1) // dp) * dp)
        _print(f"batch_size rounded up to {tcfg.batch_size} for the {dp}-way dp mesh")
    loaded = load_or_init(pretrained, model_cfg, dev, tcfg.seed)
    loader = _TimedLoader(DataLoader(dataset, tcfg, batch_size=tcfg.batch_size // dp,
                                     seed=tcfg.seed, num_shards=world_size(),
                                     shard_index=world_rank()))
    total_steps = max(1, loader.loader.steps_per_epoch()) * tcfg.max_epochs
    trainer = JointTrainer(model_cfg, tcfg, loaded["llm"], loaded["flow"], out_dir=output,
                           total_steps=total_steps, mesh=mesh)
    t0 = time.perf_counter()
    state = trainer.fit(loader, resume=resume, sharded=True)
    seconds = time.perf_counter() - t0
    steps = loader.batches  # one optimizer step a super-batch
    per = max(steps, 1)
    _print(f"{steps} steps in {seconds:.3f} s: {seconds / per:.4f} s/step, loader wait "
           f"{loader.wait / per:.4f} s/step")

    _print("\nsaving merged weights...")
    trainer.export_merged(state, save=True)
    trainer.export_adapters(state, os.path.join(output, f"adapters_{tcfg.training_mode}.pt"))
    _print("done; next: python -m cosy_tpu_torch.infer --llm ... --flow ... --text '...'")
    return RunResult(trainer, state, steps, seconds, loader.wait)


def _print(msg: str) -> None:
    if is_main():
        print(msg, flush=True)


def main(argv=None) -> Optional[RunResult]:
    args = parse_args(argv)
    model_cfg = tiny_model_config() if args.tiny else ModelConfig()
    tcfg = train_config(args)
    _print("=" * 60)
    _print("cosy_tpu_torch joint LLM + Flow LoRA training")
    _print("=" * 60)
    _print(f"mode={tcfg.training_mode} lr={tcfg.learning_rate} "
           f"bs={tcfg.batch_size} x accum={tcfg.accumulate_grad_batches} "
           f"max_feat_len={tcfg.max_feat_len} device={args.device}")
    _print(f"stop: llm_loss<={tcfg.llm_loss_threshold} flow_loss<={tcfg.flow_loss_threshold} "
           f"early-stop patience {tcfg.early_stop_patience}")
    dataset = FlowFinetuneDataset(args.data_dir, augmentation=not args.no_augmentation,
                                  leak=tcfg.anti_leakage, seed=tcfg.seed)
    if len(dataset) == 0:
        _print(f"no data in {args.data_dir}; run prepare_joint_data.py first")
        return None
    res = run(dataset, model_cfg, tcfg, args.pretrained, args.output, args.device,
              args.resume)
    finish_distributed()
    return res


if __name__ == "__main__":
    main()
