"""Prompt-free TTS from the command line (the port's counterpart of
``inference_joint.py``).

    python -m cosy_tpu_torch.infer --text "..." [--device cuda|cpu]
        [--pretrained DIR] [--llm PATH] [--flow PATH] [--output out.wav]
        [--speed 1.0] [--seed 0] [--tiny] [--attn-window N] [--stream]

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
concatenated and prints the time to the first chunk.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..config import ModelConfig, replace, tiny_model_config
from ..models.flow import Flow, init_flow_params
from ..models.hift import HiFT, init_hift_params
from ..models.llm import TransformerLM, init_llm_params
from ..params import fold_weight_norm, load_torch_checkpoint, resolve_device
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
    random init (with a warning) otherwise."""
    dev = resolve_device(device)
    if pretrained and os.path.exists(os.path.join(pretrained, "flow.pt")):
        mods = (TransformerLM(cfg.llm, dev), Flow(cfg.flow, dev), HiFT(cfg.hift, dev))
        for name, mod in zip(("llm", "flow", "hift"), mods):
            state = load_torch_checkpoint(os.path.join(pretrained, f"{name}.pt"))
            mod.load_state_dict(fold_weight_norm(state) if name == "hift" else state,
                                strict=True)
    else:
        print("WARNING: pretrained model dir not found - random initialization "
              "(smoke mode)")
        mods = (init_llm_params(cfg.llm, dev, seed=seed),
                init_flow_params(cfg.flow, dev, seed=seed + 1),
                init_hift_params(cfg.hift, dev, seed=seed + 2))
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
    args = ap.parse_args(argv)

    cfg = tiny_model_config() if args.tiny else ModelConfig()
    if args.attn_window:
        est = replace(cfg.flow.estimator, attn_window=args.attn_window)
        cfg = replace(cfg, flow=replace(cfg.flow, estimator=est))
    llm, flow, hift = load_models(cfg, args.pretrained, args.llm, args.flow,
                                  args.device, args.seed)
    pipe = TTSPipeline(cfg, llm, flow, hift, finetuned_norm=True)
    ids = np.asarray([list(args.text.encode("utf-8"))], np.int64)
    print(f"text: {args.text!r} -> {ids.shape[1]} byte ids")
    t0 = time.perf_counter()
    chunks = []
    for out in pipe.synthesize(ids, speed=args.speed, seed=args.seed, stream=args.stream):
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
