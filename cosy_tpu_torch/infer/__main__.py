"""Prompt-free TTS from the command line (the port's counterpart of
``inference_joint.py``).

    python -m cosy_tpu_torch.infer --text "..." [--device cuda|cpu]
        [--pretrained DIR] [--llm PATH] [--flow PATH] [--output out.wav]
        [--speed 1.0] [--seed 0] [--tiny] [--attn-window N] [--stream]
        [--meanflow [--meanflow-steps 2]]

Weights load from ``DIR/{llm,flow,hift}.pt`` (``--llm`` / ``--flow``
override with merged fine-tuned weights); without them every model is
randomly initialized from ``--seed`` (smoke mode: noise out, the whole path
runs).  No BPE vocabulary ships with the port yet, so the text enters as its
utf-8 byte ids.  ``--attn-window N`` restricts the estimator's attention to
the +-N-frame local band (halved per U-Net level; banded-attention kernel C
on the GPU): a speed/quality trade for long utterances, off by default.  An
utterance whose mel length is odd is padded and masked, and a level with a
mask keeps full attention.  ``--stream`` synthesizes window by window as
the decode goes (the first chunk after 120 tokens), writes the chunks
concatenated and prints the time to the first chunk.  On CUDA the
estimator must have the widths the kernels are built for (the full
configuration's); ``--tiny`` runs with ``--device cpu``, and with CUDA exits
with one message naming those widths before any weight is built.
``--meanflow`` synthesizes with the few-step sampler of MeanFlow-distilled
flow weights (``python -m cosy_tpu_torch.train.distill``; ``--flow``
points at them): ``--meanflow-steps`` single estimator calls instead of the
CFG-batched Euler solve.  Distilled weights without ``--meanflow``, and
``--meanflow`` without them, are refused.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..compat.loader import load_or_init
from ..config import InferenceConfig, ModelConfig, replace, tiny_model_config
from ..ops.fused_block import require_kernel_widths
from ..params import load_torch_checkpoint
from .pipeline import TTSPipeline


def save_wav(path: str, wav: np.ndarray, sr: int = 22050):
    import wave

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())


def load_models(cfg: ModelConfig, pretrained: str, llm_path, flow_path, device, seed: int):
    """(llm, flow, hift) modules on ``device``: checkpoints where present,
    random init (with a warning) otherwise (``compat.loader.load_or_init``),
    then the merged weights of ``llm_path`` / ``flow_path``."""
    loaded = load_or_init(pretrained, cfg, device, seed)
    mods = (loaded["llm"], loaded["flow"], loaded["hift"])
    for path, mod in ((llm_path, mods[0]), (flow_path, mods[1])):
        if path and os.path.exists(path):
            print(f"loading merged weights: {path}")
            mod.load_state_dict(load_torch_checkpoint(path), strict=True)
        elif path:
            print(f"[WARN] {path} not found - keeping the base weights")
    return mods


def main(argv=None):
    ap = argparse.ArgumentParser(description="prompt-free TTS (PyTorch port)")
    ap.add_argument("--text", "-t", required=True)
    ap.add_argument("--llm", default=None, help="merged LLM weights (.pt)")
    ap.add_argument("--flow", default=None, help="merged flow weights (.pt)")
    ap.add_argument("--pretrained", default="pretrained_models/CosyVoice-300M")
    ap.add_argument("--output", "-o", default="output/inference/joint_output.wav")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test topology (toy widths; not checkpoint-compatible)")
    ap.add_argument("--speed", "-s", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--attn-window", type=int, default=None, metavar="N",
                    help="local-band estimator attention, +-N mel frames "
                         "(default: full attention)")
    ap.add_argument("--stream", action="store_true",
                    help="streamed synthesis; prints the time to the first chunk")
    ap.add_argument("--meanflow", action="store_true",
                    help="few-step distilled sampler (flow weights from "
                         "python -m cosy_tpu_torch.train.distill)")
    ap.add_argument("--meanflow-steps", type=int, default=2)
    args = ap.parse_args(argv)

    cfg = tiny_model_config() if args.tiny else ModelConfig()
    if args.attn_window:
        est = replace(cfg.flow.estimator, attn_window=args.attn_window)
        cfg = replace(cfg, flow=replace(cfg.flow, estimator=est))
    try:
        require_kernel_widths(cfg.flow.estimator, args.device)
    except ValueError as e:
        sys.exit(f"error: {e}")
    llm, flow, hift = load_models(cfg, args.pretrained, args.llm, args.flow,
                                  args.device, args.seed)
    icfg = InferenceConfig()
    if args.meanflow:
        icfg = replace(icfg, sampler="meanflow", meanflow_steps=args.meanflow_steps)
    try:  # the sampler against the flow weights
        pipe = TTSPipeline(cfg, llm, flow, hift, icfg, finetuned_norm=True)
    except ValueError as e:
        sys.exit(f"error: {e}")
    ids = np.asarray([list(args.text.encode("utf-8"))], np.int64)
    print(f"text: {args.text!r} -> {ids.shape[1]} byte ids")
    t0 = time.perf_counter()
    chunks = []
    spk = np.zeros((1, cfg.llm.spk_embed_dim), np.float32)  # prompt-free
    for out in pipe.synthesize(ids, spk_embedding=spk, speed=args.speed, seed=args.seed,
                               stream=args.stream):
        chunks.append(out["tts_speech"][0])
        if len(chunks) == 1 and args.stream:
            print(f"first chunk after {time.perf_counter() - t0:.3f} s "
                  f"({len(chunks[0]) / cfg.sample_rate:.2f} s of audio)")
    wav = np.concatenate(chunks)
    if args.stream:
        print(f"{len(chunks)} chunks in {time.perf_counter() - t0:.3f} s")
    save_wav(args.output, wav, cfg.sample_rate)
    print(f"saved {len(wav) / cfg.sample_rate:.2f}s -> {args.output}")


if __name__ == "__main__":
    main()
