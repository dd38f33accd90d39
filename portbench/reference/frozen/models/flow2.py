"""CosyVoice2 flow: CausalMaskedDiffWithXvec + CausalConditionalCFM (the port
of the JAX package's ``models/flow2.py``): inference with the Euler
sampler.

Reference behavior: cosyvoice/flow/flow.py:151-281 and
flow_matching.py:196-227.  The encoder is the UpsampleConformerEncoder
(token rate -> 2x mel rate), the estimator the causal U-Net, and the
inference noise the reference's fixed seeded buffer (``fixed_noise``), so a
streamed window and the whole utterance start from the same noise.  The
estimator runs at CFG batch 2; streaming windows carry the static-chunk
(2, T, T) bias.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..config import CFMConfig, EncoderConfig, EstimatorConfig
from ..ctx import EVAL, Ctx
from ..layers.basic import dense, embedding
from ..layers.unet import conditional_decoder, init_conditional_decoder
from ..layers.upsample_encoder import init_upsample_encoder, upsample_encoder_forward
from ..ops import masks as M
from ..params import P, ParamTree, Spec
from .flow import cfm_t_span, check_sampler
from .llm import _l2_normalize


@dataclass(frozen=True)
class Flow2Config:
    """CausalMaskedDiffWithXvec topology (flow.py:151-188 + CosyVoice2 yaml)."""

    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    input_frame_rate: int = 25
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    encoder: EncoderConfig = field(
        default_factory=lambda: EncoderConfig(
            input_size=512, output_size=512, attention_heads=8, linear_units=2048,
            num_blocks=6, attention_dropout_rate=0.1, macaron_style=False,
            use_cnn_module=False, static_chunk_size=25,
        )
    )
    num_up_blocks: int = 4
    estimator: EstimatorConfig = field(
        default_factory=lambda: EstimatorConfig(
            in_channels=320, out_channels=80, channels=(256, 256),
            attention_head_dim=64, n_blocks=4, num_mid_blocks=12, num_heads=8,
            act_fn="gelu",
        )
    )
    cfm: CFMConfig = field(default_factory=CFMConfig)
    decoder_static_chunk_size: int = 50  # mel frames (2 x 25-token chunks)


NOISE_FRAMES = 50 * 300
_noise_cache: Dict[tuple, torch.Tensor] = {}


def fixed_noise(device=None, dtype=torch.float32, n_mels: int = 80,
                length: int = NOISE_FRAMES) -> torch.Tensor:
    """The reference's streaming noise buffer (flow_matching.py:198-199:
    ``torch.manual_seed(0); randn(1, 80, 15000)``), drawn from a CPU
    generator (a CUDA ``randn`` gives other numbers), moved to ``device``
    once and cached there."""
    dev = torch.device("cpu" if device is None else device)
    key = (str(dev), dtype, n_mels, length)
    if key not in _noise_cache:
        g = torch.Generator().manual_seed(0)
        _noise_cache[key] = torch.randn(1, n_mels, length, generator=g).to(dev, dtype)
    return _noise_cache[key]


def flow2_encode(p: P, cfg: Flow2Config, token: torch.Tensor, token_len: torch.Tensor,
                 streaming: bool = False, context: Optional[torch.Tensor] = None,
                 mask_pads_exact: bool = False, ctx: Ctx = EVAL) -> torch.Tensor:
    """Token ids (B, T_tok) -> encoder_proj(upsampled encoder) (B, 2 T_tok, 80);
    ``context``: the lookahead token ids a non-final window feeds as context."""
    tok_mask = M.make_non_pad_mask(token_len, token.shape[1])[:, :, None]
    emb = embedding(p, "input_embedding", token, clamp_min=0)
    emb = emb * tok_mask.to(emb.dtype)
    ctx_emb = None
    if context is not None and context.shape[1] != 0:
        ctx_emb = embedding(p, "input_embedding", context, clamp_min=0)
    h, _ = upsample_encoder_forward(
        p.sub("encoder"), cfg.encoder, emb, token_len, ctx, streaming=streaming,
        context=ctx_emb, num_up_blocks=cfg.num_up_blocks, up_stride=cfg.token_mel_ratio,
        pre_lookahead_len=cfg.pre_lookahead_len,
        token_chunk_size=cfg.encoder.static_chunk_size, mask_pads_exact=mask_pads_exact)
    return dense(p, "encoder_proj", h, ctx)


def flow2_inference(
    p: P,
    cfg: Flow2Config,
    token: torch.Tensor,  # (1, T_tok) long
    prompt_token: torch.Tensor,  # (1, T_ptok) long
    prompt_feat: torch.Tensor,  # (1, T_pmel, 80)
    spk_embedding: torch.Tensor,  # (1, 192)
    streaming: bool = False,
    finalize: bool = True,
    n_timesteps: int = 10,
    token_valid: Optional[int] = None,
    sampler: str = "euler",
) -> torch.Tensor:
    """Chunked / streaming inference (flow.py:235-281) -> (1, 80, T_out) f32,
    T_out = token_mel_ratio x the target tokens (less the lookahead when
    not ``finalize``: the last ``pre_lookahead_len`` tokens then enter as the
    encoder's context only).

    ``token_valid`` (finalize, prompt-free): ``token`` is padded to a bucket
    and only its first ``token_valid`` ids are real; the first
    ``token_valid * token_mel_ratio`` frames equal the unpadded solve's
    (causal convs, key-masked attention, the fixed noise's common prefix)
    and the rest are zero."""
    check_sampler(sampler)
    dev = token.device
    spk = dense(p, "spk_embed_affine_layer", _l2_normalize(spk_embedding, dim=1))
    full = torch.cat([prompt_token, token], dim=1)
    T_all = full.shape[1]
    if token_valid is not None and not (finalize and prompt_token.shape[1] == 0
                                        and prompt_feat.shape[1] == 0):
        raise ValueError("the length-masked bucket is finalize-only and prompt-free")
    if finalize:
        token_in, context, n_in = full, None, T_all
    else:
        L = cfg.pre_lookahead_len
        token_in, context, n_in = full[:, :-L], full[:, -L:], T_all - L
    token_len = torch.tensor([n_in if token_valid is None else token_valid], device=dev)
    h = flow2_encode(p, cfg, token_in, token_len, streaming=streaming, context=context,
                     mask_pads_exact=token_valid is not None)
    mel_len1 = prompt_feat.shape[1]
    T = h.shape[1]
    conds = torch.zeros((1, T, cfg.output_size), dtype=h.dtype, device=dev)
    if mel_len1 > 0:
        conds[:, :mel_len1] = prompt_feat.to(h.dtype)
    # an even T (token_mel_ratio 2 gives one whenever the prompt's mel length
    # is even) takes the mask-free dense path
    T_pad = T + T % 2
    mel_valid = None if token_valid is None else token_valid * cfg.token_mel_ratio
    if token_valid is not None:
        mask = (torch.arange(T_pad, device=dev) < mel_valid).to(h.dtype)[None, None]
    elif T_pad == T:
        mask = None
    else:
        mask = torch.zeros((1, 1, T_pad), dtype=h.dtype, device=dev)
        mask[:, :, :T] = 1.0
    mu = F.pad(h.transpose(1, 2), (0, T_pad - T))
    conds = F.pad(conds.transpose(1, 2), (0, T_pad - T))
    x = fixed_noise(dev, h.dtype, cfg.output_size)[:, :, :T_pad]
    est = p.sub("decoder.estimator")
    r = cfg.cfm.inference_cfg_rate
    t_span = cfm_t_span(n_timesteps, cfg.cfm.t_scheduler, dev)
    mask2 = None if mask is None else torch.cat([mask, mask])
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spk2 = torch.cat([spk, torch.zeros_like(spk)])
    cond2 = torch.cat([conds, torch.zeros_like(conds)])
    for i in range(n_timesteps):
        t, dt = t_span[i], t_span[i + 1] - t_span[i]
        dphi = conditional_decoder(est, cfg.estimator, torch.cat([x, x]), mask2, mu2,
                                   t.expand(2).to(x.dtype), spk2, cond2, causal=True,
                                   streaming=streaming,
                                   static_chunk_size=cfg.decoder_static_chunk_size)
        x = (x + dt * ((1.0 + r) * dphi[:1] - r * dphi[1:])).to(x.dtype)
    return _finish(x, mel_len1, T, mel_valid)


def _finish(x: torch.Tensor, mel_len1: int, T: int, mel_valid: Optional[int]) -> torch.Tensor:
    """The solved mel without the prompt region, f32; a bucketed window's
    pad region (which still holds the fixed noise) zeroed for the masked
    HiFT of the final chunk."""
    out = x[:, :, mel_len1:T].float()
    if mel_valid is not None:
        out = out * (torch.arange(out.shape[2], device=x.device) < mel_valid)
    return out


class Flow2(ParamTree):
    """CausalMaskedDiffWithXvec weights (CosyVoice2 flow.pt names)."""

    def __init__(self, cfg: Flow2Config, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(flow2_spec(cfg), device, dtype, generator)
        self.cfg = cfg


def flow2_spec(cfg: Flow2Config) -> Spec:
    """Names and shapes of the JAX package's ``init_flow2_params``."""
    spec = Spec()
    spec.embedding("input_embedding", cfg.vocab_size, cfg.input_size)
    spec.linear("spk_embed_affine_layer", cfg.spk_embed_dim, cfg.output_size)
    init_upsample_encoder(spec, "encoder", cfg.encoder, num_up_blocks=cfg.num_up_blocks,
                          pre_lookahead_len=cfg.pre_lookahead_len,
                          up_stride=cfg.token_mel_ratio)
    spec.linear("encoder_proj", cfg.encoder.output_size, cfg.output_size)
    init_conditional_decoder(spec, "decoder.estimator", cfg.estimator, causal=True)
    return spec


