"""Weight-only int8 quantization of inference weights (the port of the JAX
package's ``quant.py``).

Symmetric per-output-channel int8: row ``o`` of a 2-D ``(out, in)`` weight
becomes ``round(w / s_o)`` clipped to +-127, with ``s_o = max(max|w_o| /
127, 1e-12)`` kept in f32 under the sibling name ``<weight>@scale``.
``layers.basic.dense`` dequantizes when it finds that sibling: the product
runs on the int8 weight cast to the activation dtype and is scaled per
output channel afterwards.

The CosyVoice-300M decode quantizes only its per-token step
(``models.llm.quantize_decode_step``); CosyVoice2's Qwen2 backbone
quantizes the flat dict by suffix (``QWEN2_PROJ_SUFFIXES``).
``validate_int8_voice`` measures what the rounding does to one voice's
tokens and audio.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

# the large projection matrices of a Qwen2 block; embeddings, norms and
# the head stay in their dtype
QWEN2_PROJ_SUFFIXES: Tuple[str, ...] = (
    "q_proj.weight", "k_proj.weight", "v_proj.weight", "o_proj.weight",
    "gate_proj.weight", "up_proj.weight", "down_proj.weight",
)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 weight, (out,) f32 scales) of one (out, in) weight."""
    w32 = w.detach().float()
    # a true division on every device: CUDA multiplies by the reciprocal of
    # a Python-number divisor, which can move a scale by one ulp
    sc = torch.clamp(w32.abs().amax(dim=1, keepdim=True)
                     / torch.full((), 127.0, device=w32.device), min=1e-12)
    return torch.clamp(torch.round(w32 / sc), -127, 127).to(torch.int8), sc[:, 0]


def quantize_int8(params: Dict[str, torch.Tensor],
                  suffixes: Iterable[str] = QWEN2_PROJ_SUFFIXES,
                  prefix: str = "") -> Dict[str, torch.Tensor]:
    """A copy of ``params`` with every 2-D weight whose name starts with
    ``prefix`` and ends with one of ``suffixes`` replaced by its int8
    values, plus its f32 ``@scale`` sibling."""
    suffixes = tuple(suffixes)
    out = dict(params)
    for name, w in params.items():
        if name.startswith(prefix) and name.endswith(suffixes) and w.ndim == 2:
            out[name], out[name + "@scale"] = quantize_weight(w)
    return out


def count_quantized(params: Dict[str, torch.Tensor]) -> int:
    return sum(1 for v in params.values() if v.dtype == torch.int8)


def validate_int8_voice(model_cfg, llm, flow, hift, infer_cfg=None, text_token_list=(),
                        seeds: Iterable[int] = (0, 1, 2), finetuned_norm: bool = True,
                        max_len_cap: int = 2048) -> Dict:
    """Decode every prompt with and without int8 decode weights (the same
    decode generator) and measure the divergence for this voice.

    Per prompt and seed: ``agreement``, the share of positions where the
    two token streams match over the longer one (1.0: identical), and
    ``mcd_db``, the DTW-aligned mel-cepstral distortion between the two
    waveforms, both synthesized by the full-precision pipeline's
    ``token2wav`` from the same generator seed (so the audio difference is
    the decode's alone).  ``llm`` / ``flow`` / ``hift`` are the port's
    modules.  Returns ``{"prompts": [...], "agreement_min",
    "agreement_mean", "mcd_db_max"}``."""
    from .config import InferenceConfig, replace
    from .infer.pipeline import TTSPipeline
    from .ops.audio import mel_spectrogram
    from .ops.mcd import mcd

    icfg = infer_cfg or InferenceConfig()
    pipes = {tag: TTSPipeline(model_cfg, llm, flow, hift, replace(icfg, int8_decode=q),
                              finetuned_norm=finetuned_norm)
             for tag, q in (("full", False), ("int8", True))}
    spk = np.zeros((1, model_cfg.flow.spk_embed_dim), np.float32)
    rows = []
    for pi, text in enumerate(text_token_list):
        for seed in seeds:
            toks = {tag: pipe.generate_tokens(np.asarray(text), spk, max_len_cap,
                                              TTSPipeline._decode_generator(seed, 0))[0]
                    for tag, pipe in pipes.items()}
            a, b = toks["full"], toks["int8"]
            m = min(len(a), len(b))
            agreement = float((a[:m] == b[:m]).sum() / max(len(a), len(b), 1))
            mcd_db = 0.0  # identical tokens give identical audio
            if agreement != 1.0:
                pipe = pipes["full"]
                mels = {}
                for tag, tk in toks.items():
                    wav = pipe.token2wav(tk[None], spk,
                                         generator=pipe._wav_generator(seed, 0, 0))
                    mels[tag] = mel_spectrogram(torch.as_tensor(wav, device=pipe.device)
                                                )[0].T.cpu().numpy()  # (T, 80)
                mcd_db = mcd(mels["int8"], mels["full"], align=True)
            rows.append({"prompt": pi, "seed": seed, "tokens_full": int(len(a)),
                         "tokens_int8": int(len(b)), "agreement": round(agreement, 4),
                         "mcd_db": round(float(mcd_db), 4)})
    return {"prompts": rows,
            "agreement_min": min(r["agreement"] for r in rows),
            "agreement_mean": float(sum(r["agreement"] for r in rows) / len(rows)),
            "mcd_db_max": max(r["mcd_db"] for r in rows)}
