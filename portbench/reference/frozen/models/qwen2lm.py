"""Qwen2LM, CosyVoice2's speech-token LLM over the Qwen2 backbone (the port
of the JAX package's ``models/qwen2lm.py``), the parts the benchmark's
reference runs: its configuration, the prefix pack [sos, text, task, prompt
speech] and the parameter spec.  The reference's own causal pass over a
prefix and its tokens is in ``portbench/reference/engine.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from ..layers.basic import embedding
from ..layers.qwen2 import Qwen2Config, qwen2_spec
from ..params import P, ParamTree, Spec


@dataclass(frozen=True)
class Qwen2LMConfig:
    llm_input_size: int = 896
    llm_output_size: int = 896
    speech_token_size: int = 6561  # CosyVoice2 FSQ speech tokens
    sos_eos: int = 0
    task_id: int = 1
    fill_token: int = 2
    mix_ratio: Tuple[int, int] = (5, 15)
    length_normalized_loss: bool = True
    lsm_weight: float = 0.0
    qwen: Qwen2Config = field(default_factory=Qwen2Config)


def qwen2lm_prefix(p: P, cfg: Qwen2LMConfig, text_tokens: torch.Tensor,
                   prompt_speech_token: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1, L0, D) decode prefix [sos, text, task, prompt speech] (no speaker
    row in CosyVoice2; llm.py:427-462)."""
    emb = p["llm_embedding.weight"]
    parts = [emb[cfg.sos_eos][None, None],
             embedding(p.sub("llm.model.model"), "embed_tokens", text_tokens),
             emb[cfg.task_id][None, None]]
    if prompt_speech_token is not None and prompt_speech_token.numel():
        parts.append(embedding(p, "speech_embedding", prompt_speech_token)
                     .reshape(1, -1, cfg.llm_input_size))
    return torch.cat(parts, dim=1)


class Qwen2LM(ParamTree):
    """Qwen2LM weights (CosyVoice2 llm.pt names)."""

    def __init__(self, cfg: Qwen2LMConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(qwen2lm_spec(cfg), device, dtype, generator)
        self.cfg = cfg


def qwen2lm_spec(cfg: Qwen2LMConfig) -> Spec:
    """Names and shapes of the JAX package's ``init_qwen2lm_params``."""
    spec = qwen2_spec(Spec(), cfg.qwen, prefix="llm.model.model")
    spec.embedding("llm_embedding", 2, cfg.llm_input_size)
    spec.linear("llm_decoder", cfg.llm_output_size, cfg.speech_token_size + 3)
    spec.embedding("speech_embedding", cfg.speech_token_size + 3, cfg.llm_input_size)
    return spec


