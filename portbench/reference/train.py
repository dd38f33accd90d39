"""The training cells' comparison on the frozen reference.

The reference follows the set-up's first steps from the same inputs: the
clips collated again by the loader's documented rules in the order its
seed shuffles them, the same initial adapters and step seeds, float32
throughout (``frozen/train.py``).  Three numbers, each a relative gap:

- ``loss_gap``: the widest over the steps of |program's loss - reference's|
  over the reference's (read, not compared: the control reads as low);
- ``grad_norm_gap``: the worst leaf's gap between the norms of the first
  step's clipped gradient, the program's worked out from its optimizer's
  first moments (m = (1 - beta1) g after one step), against the
  reference's norm of that leaf or of the median leaf, the larger;
- ``update_norm_gap``: the same for the norm of each leaf's change over
  the steps, among the leaves whose first gradient in the reference is at
  least a thousandth of the median leaf's (a leaf the loss does not reach
  moves by weight decay and round-off alone).

The control is the reference with the base weights and the micro-batches'
float inputs in float8 (e4m3), the type below the program's bfloat16.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .. import spec, system
from .check import set_tf32

MEL_PADDING_VALUE = -11.5
N_MELS = 80


def collate(batch: List[Dict[str, np.ndarray]], max_feat_len: int, max_token_len: int,
            max_text_len: int) -> Dict[str, np.ndarray]:
    """Pad or truncate every clip to the fixed maxima of the loader's
    static collation: a mel past ``max_feat_len`` frames is cut there and
    its tokens and text in proportion."""
    B = len(batch)
    out = {"speech_token": np.zeros((B, max_token_len), np.int32),
           "speech_token_len": np.zeros((B,), np.int32),
           "speech_feat": np.full((B, max_feat_len, N_MELS), MEL_PADDING_VALUE, np.float32),
           "speech_feat_len": np.zeros((B,), np.int32),
           "embedding": np.zeros((B, 192), np.float32),
           "text_token": np.zeros((B, max_text_len), np.int32),
           "text_token_len": np.zeros((B,), np.int32)}
    for i, b in enumerate(batch):
        feat, token, text = b["speech_feat"], b["speech_token"], b["text_token"]
        fl = feat.shape[0]
        if fl > max_feat_len:
            token = token[: int(token.shape[0] * max_feat_len / fl)]
            text = text[: max(1, int(text.shape[0] * max_feat_len / fl))]
            feat, fl = feat[:max_feat_len], max_feat_len
        token, text = token[:max_token_len], text[:max_text_len]
        out["speech_feat"][i, :fl] = feat
        out["speech_feat_len"][i] = fl
        out["speech_token"][i, :token.shape[0]] = token
        out["speech_token_len"][i] = token.shape[0]
        out["embedding"][i] = b["embedding"][:192]
        out["text_token"][i, :text.shape[0]] = text
        out["text_token_len"][i] = text.shape[0]
    return out


def super_batches(clips, tcfg, loader_seed: int, steps: int, max_text_len: int, device):
    """The first ``steps`` super-batches, (accum, B, ...) tensors: the clips
    in the order the loader's seed shuffles them."""
    idx = np.arange(len(clips))
    np.random.default_rng(loader_seed).shuffle(idx)
    accum, B = tcfg.accumulate_grad_batches, tcfg.batch_size
    out = []
    for k in range(steps):
        chunk = [clips[int(i)] for i in idx[k * accum * B:(k + 1) * accum * B]]
        b = collate(chunk, tcfg.max_feat_len, tcfg.max_token_len, max_text_len)
        out.append({n: torch.as_tensor(v.reshape(accum, B, *v.shape[1:])).to(device)
                    for n, v in b.items()})
    return out


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).to(t.dtype) if t.is_floating_point() else t


def _gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor], keep):
    """Each kept leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's:
    (the worst leaf's gap, the median of the leaves' gaps)."""
    norms = {n: float(torch.linalg.vector_norm(v.double())) for n, v in reference.items()}
    median = float(np.median(list(norms.values())))
    gaps = [abs(float(torch.linalg.vector_norm(program[n].double())) - norms[n])
            / max(norms[n], median, 1e-30) for n in reference if keep(n)]
    return max(gaps), float(np.median(gaps))


def numbers(config: Dict[str, Any], seed: int, inference: Dict[str, Any],
            samples: List[Dict[str, Any]], device, control: bool) -> Dict[str, float]:
    """``{loss_gap, grad_norm_gap, update_norm_gap}`` of the program's first
    steps, or with ``control`` those of the float8 reference, and the two
    norm gaps' medians over the leaves (``..._median``)."""
    from .frozen import config as FC
    from .frozen import train as T

    set_tf32(False)
    s = samples[0]
    cfg = spec.build(FC.ModelConfig, config["model"])
    tcfg = spec.build(FC.TrainConfig, config["train"])
    mods = system.modules(config, seed, device, reference=True)
    llm_p = {k: v.detach() for k, v in mods["llm"].named_parameters()}
    flow_p = {k: v.detach() for k, v in mods["flow"].named_parameters()}
    steps = len(s["losses"])
    batches = super_batches(s["clips"], tcfg, s["loader_seed"], steps, s["max_text_len"], device)
    gens = [torch.Generator(device=device).manual_seed(x) for x in s["step_seeds"]]
    losses, first, after = T.train_steps(llm_p, flow_p, s["initial"], cfg, tcfg, batches, gens,
                                         s["total_steps"])
    initial = {f"{k}/{n}": v for k in sorted(s["initial"]) for n, v in s["initial"][k].items()}
    g_norms = {n: float(torch.linalg.vector_norm(g.double())) for n, g in first.items()}
    g_median = float(np.median(list(g_norms.values())))

    def reached(n):
        return g_norms[n] >= 1e-3 * g_median

    if control:
        low = lambda d: {k: _fp8(v) for k, v in d.items()}  # noqa: E731
        p_losses, p_first, p_after = T.train_steps(
            low(llm_p), low(flow_p), s["initial"], cfg, tcfg, batches,
            [torch.Generator(device=device).manual_seed(x) for x in s["step_seeds"]],
            s["total_steps"], cast=low)
    else:
        beta1 = 0.9
        p_losses = s["losses"]
        p_first = {n: m / (1.0 - beta1) for n, m in s["first_moments"].items()}
        p_after = s["adapters"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(p_losses, losses))
    grad, grad_median = _gaps(p_first, first, lambda n: True)
    update, update_median = _gaps({n: p_after[n] - initial[n] for n in initial},
                                  {n: after[n] - initial[n] for n in initial}, reached)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad, "update_norm_gap": update,
            "grad_norm_gap_median": grad_median, "update_norm_gap_median": update_median}

