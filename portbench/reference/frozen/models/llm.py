"""Speech-token LLM (TransformerLM, the port of the JAX package's
``models/llm.py``), the parts the benchmark's reference runs: the text
encoder and the token embedding of the backbone, and the parameter spec.
The reference's own causal pass over a prefix and its tokens is in
``portbench/reference/engine.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..config import LLMConfig
from ..ctx import EVAL, Ctx
from ..layers.basic import dense, embedding, layer_norm
from ..layers.conformer import encoder_forward, init_encoder
from ..params import P, ParamTree, Spec


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def _token_embed_legacy(p_llm: P, x: torch.Tensor) -> torch.Tensor:
    """linear_legacy input embed of the LLM backbone: Linear + LayerNorm +
    ReLU, then x * sqrt(D)."""
    sp = p_llm.sub("embed")
    x = F.relu(layer_norm(sp, "out.1", dense(sp, "out.0", x), eps=1e-5))
    return x * math.sqrt(x.shape[-1])


def llm_encode_text(p: P, cfg: LLMConfig, text_token: torch.Tensor,
                    text_len: torch.Tensor, ctx: Ctx = EVAL) -> torch.Tensor:
    """text_embedding -> causal conformer -> affine."""
    emb = embedding(p, "text_embedding", text_token)
    h, _ = encoder_forward(p.sub("text_encoder"), cfg.text_encoder, emb, text_len, ctx,
                           decoding_chunk_size=1, num_decoding_left_chunks=-1,
                           conformer=True)
    return dense(p, "text_encoder_affine_layer", h, ctx)


class TransformerLM(ParamTree):
    """TransformerLM weights (llm.pt names)."""

    def __init__(self, cfg: LLMConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(llm_spec(cfg), device, dtype, generator)
        self.cfg = cfg


def llm_spec(cfg: LLMConfig) -> Spec:
    spec = Spec()
    spec.embedding("text_embedding", cfg.text_token_size, cfg.text_encoder_input_size)
    init_encoder(spec, "text_encoder", cfg.text_encoder, conformer=True)
    spec.linear("text_encoder_affine_layer", cfg.text_encoder.output_size,
                cfg.llm_input_size)
    spec.embedding("llm_embedding", 2, cfg.llm_input_size)
    init_encoder(spec, "llm", cfg.llm, conformer=False)
    spec.linear("llm_decoder", cfg.llm_output_size, cfg.speech_token_size + 1)
    spec.embedding("speech_embedding", cfg.speech_token_size, cfg.llm_input_size)
    spec.linear("spk_embed_affine_layer", cfg.spk_embed_dim, cfg.llm_input_size)
    return spec


