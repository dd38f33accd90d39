"""Merge the LoRA adapters of a training checkpoint into original-format
weights (the port's counterpart of ``merge_joint_weights.py``).

    python -m cosy_tpu_torch.merge [--mode joint] [--ckpt PATH]
        [--pretrained pretrained_models/CosyVoice-300M] [--output output]
        [--device cuda|cpu] [--tiny] [--adapters-out PATH]

Finds the latest checkpoint of the mode in ``--output`` (by mtime) unless
``--ckpt`` names one, merges W' = W + BA * scale, and writes
``llm_merged_<mode>.pt`` / ``flow_merged_<mode>.pt``, which
``python -m cosy_tpu_torch.infer --llm ... --flow ...`` loads.
"""

from __future__ import annotations

import argparse
import glob
import os

from .config import ModelConfig, TrainConfig, tiny_model_config
from .infer.__main__ import load_models
from .train.trainer import JointTrainer


def find_latest_checkpoint(output_dir: str, mode: str) -> str:
    """Latest checkpoint by mtime for the mode."""
    cands = sorted(glob.glob(os.path.join(output_dir, f"joint_{mode}_*.ckpt.pt")),
                   key=os.path.getmtime, reverse=True)
    if not cands:
        raise FileNotFoundError(f"no checkpoint for mode {mode} in {output_dir}")
    return cands[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description="merge LoRA adapters (PyTorch port)")
    ap.add_argument("--mode", default="joint", choices=["joint", "llm_only", "flow_only"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--pretrained", default="pretrained_models/CosyVoice-300M")
    ap.add_argument("--output", default="output")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test topology (toy widths; not checkpoint-compatible)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random base weights when --pretrained is absent")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--adapters-out", default=None, metavar="PATH",
                    help="also write the raw (un-merged) LoRA adapters")
    args = ap.parse_args(argv)

    cfg = tiny_model_config() if args.tiny else ModelConfig()
    llm, flow, _ = load_models(cfg, args.pretrained, None, None, args.device, args.seed)
    ckpt = args.ckpt or find_latest_checkpoint(args.output, args.mode)
    print(f"merging from checkpoint: {ckpt}")
    trainer = JointTrainer(cfg, TrainConfig(training_mode=args.mode, bf16=False),
                           llm, flow, out_dir=args.output)
    state = trainer.load_checkpoint(ckpt, trainer.init_state())
    trainer.export_merged(state, save=True)
    if args.adapters_out:
        trainer.export_adapters(state, args.adapters_out)


if __name__ == "__main__":
    main()
