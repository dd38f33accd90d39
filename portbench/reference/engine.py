"""The engine cells' comparison on the frozen reference.

For each sampled request: the reference's logits over the request's
prefix and its served tokens (one causal forward pass, no cache) and the
request's own uniforms give ``token_cdf_miss`` (the widest gap, in
probability mass, between a served token and the draw the rule gives);
the reference's stream of the served tokens with the request's seeds gives
``wav_rel_err`` (the relative L2 error of the served wav).  The control's
tokens are the draws that its own logits and the same uniforms give.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .. import system
from .check import rel_err, set_tf32
from .sampling import Rule, log_probs

F = "portbench.reference.frozen"


class Served:
    """The reference's view of one served model: its logits over a prefix
    and fed tokens, its stream of a request's tokens."""

    def __init__(self, pipe, family: str):
        import importlib

        self.pipe, self.family = pipe, family
        self.m = {k: importlib.import_module(f"{F}.{k}") for k in (
            "models.llm", "layers.conformer", "layers.posenc",
            "layers.basic", "layers.qwen2", "ops.masks", "infer.pipeline", "infer.pipeline2")}
        if family == "cosyvoice":
            self.eos = pipe.cfg.llm.speech_token_size
        else:
            self.eos = pipe.lcfg.speech_token_size
        ic = pipe.icfg
        self.rule = Rule(ic.sampling_top_p, ic.sampling_top_k, ic.ras_win_size, ic.ras_tau_r)

    def prefix(self, text: np.ndarray, cap: int) -> torch.Tensor:
        if self.family == "cosyvoice":
            return self.pipe._build_prefix(text, None, None, self.pipe._spk(None), cap)[0]
        return self.pipe._build_prefix(text, None, None, cap)[0]

    def logits(self, prefix: torch.Tensor, fed: Sequence[int]) -> torch.Tensor:
        """(len(fed) + 1, V) next-token logits after the prefix and each fed
        token: one causal pass over the whole sequence."""
        p, dev = self.pipe.llm_p, prefix.device
        ids = torch.tensor(list(fed), dtype=torch.long, device=dev)[None]
        L0 = prefix.shape[1]
        if self.family == "cosyvoice":
            L, C, PE, B = (self.m["models.llm"], self.m["layers.conformer"],
                           self.m["layers.posenc"], self.m["layers.basic"])
            ecfg = self.pipe.cfg.llm.llm
            x = torch.cat([prefix, B.embedding(p, "speech_embedding", ids)], 1)
            p_llm = p.sub("llm")
            h = L._token_embed_legacy(p_llm, x)
            S = h.shape[1]
            pe = PE.rel_pos_table(S, ecfg.output_size, dev).to(h.dtype)
            bias = self._causal(S, dev, h.dtype)
            for i in range(ecfg.num_blocks):
                h = C.transformer_layer(p_llm, f"encoders.{i}", ecfg, h, bias, pe)
            h = B.layer_norm(p_llm, "after_norm", h, eps=1e-5)
            return B.dense(p, "llm_decoder", h[0, L0 - 1:])
        B, Qw = self.m["layers.basic"], self.m["layers.qwen2"]
        q = self.pipe.lcfg.qwen
        x = torch.cat([prefix, B.embedding(p, "speech_embedding", ids).to(prefix.dtype)], 1)
        h = Qw.qwen2_forward(p.sub("llm.model.model"), q, x,
                             torch.tensor([x.shape[1]], device=dev))
        return B.dense(p, "llm_decoder", h[0, L0 - 1:])

    def _causal(self, S: int, dev, dtype) -> torch.Tensor:
        k = torch.arange(S, device=dev)
        return torch.where(k[None, None, :] <= k[None, :, None], 0.0,
                           self.m["ops.masks"].NEG_BIAS).to(dtype)

    def stream(self, tokens: np.ndarray, seed: int) -> np.ndarray:
        pl = self.pipe
        if self.family == "cosyvoice":
            cur = self.m["infer.pipeline"].StreamCursor(pl._spk(None), seed, 0,
                                                        pl.token_min_hop_len)
        else:
            cur = self.m["infer.pipeline2"].Stream2Cursor(pl._spk(None), seed, 0,
                                                          pl.token_hop_len)
        wavs = list(pl.stream_chunks(cur, np.asarray(tokens, np.int64)[None], True))
        return np.concatenate([w.reshape(-1) for w in wavs])


def _walk(sv: Served, prefix, served: List[int], cap: int, u: List[List[float]]):
    """Follow the program's ``cap`` attempts against the reference.  At each
    attempt the served token is compared with the reference's draw; a fill
    id (Qwen2LM's ids above EOS, which an attempt may sample without
    emitting, feeding the last token again) is taken where it lies nearer
    the uniforms than the next served token.  Returns (the worst miss, the
    tokens fed after the prefix, one an attempt, and each attempt's count
    of tokens emitted before it)."""
    fill_ids = sv.family == "cosyvoice2"
    n = len(served)
    fed: List[int] = []
    before: List[int] = []
    j, worst = 0, 0.0
    lg = sv.logits(prefix, served[:-1])
    for k in range(cap):
        if k >= lg.shape[0]:
            lg = sv.logits(prefix, fed)
        logp = log_probs(lg[k], k, cap, sv.eos, fill_ids)
        hist = served[:j]
        m_tok = sv.rule.miss(logp, served[j], u[k], hist) if j < n else math.inf
        m_fill = math.inf
        if fill_ids and j > 0 and cap - k > n - j:
            m_fill = min(sv.rule.miss(logp, f, u[k], hist) for f in range(sv.eos + 1, logp.shape[0]))
        before.append(j)
        if m_fill < m_tok:
            worst = max(worst, m_fill)
            fed.append(served[j - 1])
            lg = sv.logits(prefix, fed + served[j:-1])
        else:
            worst = max(worst, m_tok)
            fed.append(served[min(j, n - 1)])
            j += 1
    if j != n:
        worst = math.inf
    return worst, fed[:cap - 1], before


def numbers(config: Dict[str, Any], seed: int, inference: Dict[str, Any],
                   samples: List[Dict[str, Any]], device, control: bool) -> Dict[str, float]:
    """``{token_cdf_miss, wav_rel_err}`` of the program's samples, or with
    ``control`` those of the TF32 reference in the program's place."""
    set_tf32(False)
    pipe = system.build(config, seed, device, inference, reference=True)
    sv = Served(pipe, config["family"])
    out = {"token_cdf_miss": 0.0, "wav_rel_err": 0.0}
    with torch.inference_mode():
        for s in samples:
            served = [int(t) for t in s["tokens"]]
            prefix = sv.prefix(s["text"], s["cap"])
            u = torch.rand((s["cap"], 2), generator=torch.Generator().manual_seed(s["seed"]))
            u = u.double().tolist()
            miss, fed, marks = _walk(sv, prefix, served, s["cap"], u)
            wav_ref = sv.stream(np.asarray(served), s["seed"])
            if not control:
                out["token_cdf_miss"] = max(out["token_cdf_miss"], miss)
                out["wav_rel_err"] = max(out["wav_rel_err"], rel_err(s["wav"], wav_ref))
                continue
            lg = sv.logits(prefix, fed)
            set_tf32(True)
            lc = sv.logits(prefix, fed)
            wav_c = sv.stream(np.asarray(served), s["seed"])
            set_tf32(False)
            fill = sv.family == "cosyvoice2"
            for k, j in enumerate(marks):
                hist = served[:j]
                choice = sv.rule.choose(log_probs(lc[k], k, s["cap"], sv.eos, fill), u[k], hist)
                m = sv.rule.miss(log_probs(lg[k], k, s["cap"], sv.eos, fill), choice, u[k], hist)
                out["token_cdf_miss"] = max(out["token_cdf_miss"], m)
            out["wav_rel_err"] = max(out["wav_rel_err"], rel_err(wav_c, wav_ref))
    return out
