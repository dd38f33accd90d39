"""Conditional flow-matching mel decoder, inference (the port of the JAX
package's ``models/flow.py``): token encoder, length regulator and the
fixed-step Euler CFM solve with its classifier-free-guidance batch of 2."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import FlowConfig
from ..layers.basic import conv1d, dense, embedding, group_norm, mish
from ..layers.conformer import encoder_forward, init_encoder
from ..layers.unet import conditional_decoder, init_conditional_decoder
from ..ops import masks as M
from ..params import P, ParamTree, Spec, resolve_device
from .llm import _l2_normalize

PI = 3.14159265359  # the reference's truncation


def interpolate_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """(B, C, T) -> (B, C, out_len), half-pixel linear interpolation
    (torch F.interpolate(mode='linear', align_corners=False) semantics)."""
    T = x.shape[-1]
    pos = (torch.arange(out_len, dtype=torch.float32, device=x.device) + 0.5) \
        * (T / out_len) - 0.5
    pos = torch.clamp(pos, 0.0, T - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=T - 1)
    w = (pos - lo).to(x.dtype)
    return x[..., lo] * (1.0 - w) + x[..., hi] * w


def regulator_stack(p: P, x: torch.Tensor, stages: int) -> torch.Tensor:
    """Conv3 + GroupNorm(1) + Mish, ``stages`` times, then a 1x1 conv; x (B, C, T)."""
    for s in range(stages):
        x = conv1d(p, f"model.{3 * s}", x, padding=1)
        x = mish(group_norm(p, f"model.{3 * s + 1}", x, num_groups=1))
    return conv1d(p, f"model.{3 * stages}", x)


def length_regulator_inference(p: P, x1: torch.Tensor, x2: torch.Tensor,
                               mel_len1: int, mel_len2: int, stages: int,
                               input_frame_rate: int = 50) -> torch.Tensor:
    """Seam-preserving interpolation of prompt (x1, may be width 0) and
    target (x2) token encodings, (1, T_tok, C) each -> (1, T_mel, C).  Over
    40 target tokens, the first and last 20 are interpolated on their own."""
    if x2.shape[1] > 40:
        edge = int(20 / input_frame_rate * 22050 / 256)
        h2 = torch.cat([
            interpolate_linear(x2[:, :20].transpose(1, 2), edge),
            interpolate_linear(x2[:, 20:-20].transpose(1, 2), mel_len2 - 2 * edge),
            interpolate_linear(x2[:, -20:].transpose(1, 2), edge)], dim=2)
    else:
        h2 = interpolate_linear(x2.transpose(1, 2), mel_len2)
    if x1.shape[1] != 0:
        h = torch.cat([interpolate_linear(x1.transpose(1, 2), mel_len1), h2], dim=2)
    else:
        h = h2
    return regulator_stack(p, h, stages).transpose(1, 2)


def cfm_t_span(n_timesteps: int, scheduler: str = "cosine", device=None) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n_timesteps + 1, device=device)
    if scheduler == "cosine":
        t = 1.0 - torch.cos(t * 0.5 * PI)
    return t


def cfm_solve_euler(p: P, cfg: FlowConfig, z: torch.Tensor, mask, mu: torch.Tensor,
                    spks: torch.Tensor, cond: torch.Tensor,
                    n_timesteps: int) -> torch.Tensor:
    """Fixed-step Euler ODE solve with the CFG pair batched: each step runs
    the estimator once on [x, x] with [mu, 0] / [spks, 0] / [cond, 0] and
    mixes (1 + r) * d_cond - r * d_uncond, r = inference_cfg_rate."""
    B = z.shape[0]
    r = cfg.cfm.inference_cfg_rate
    t_span = cfm_t_span(n_timesteps, cfg.cfm.t_scheduler, z.device)
    mask2 = None if mask is None else torch.cat([mask, mask])
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spks2 = torch.cat([spks, torch.zeros_like(spks)])
    cond2 = torch.cat([cond, torch.zeros_like(cond)])
    x = z
    for i in range(n_timesteps):
        t, dt = t_span[i], t_span[i + 1] - t_span[i]
        dphi = conditional_decoder(p, cfg.estimator, torch.cat([x, x]), mask2, mu2,
                                   t.expand(2 * B).to(x.dtype), spks2, cond2)
        dphi = (1.0 + r) * dphi[:B] - r * dphi[B:]
        x = (x + dt * dphi).to(x.dtype)
    return x.float()


def flow_encode(p: P, cfg: FlowConfig, token: torch.Tensor,
                token_len: torch.Tensor) -> torch.Tensor:
    """input_embedding -> conformer encoder -> encoder_proj."""
    tok_mask = M.make_non_pad_mask(token_len, token.shape[1])[:, :, None]
    emb = embedding(p, "input_embedding", token, clamp_min=0)
    emb = emb * tok_mask.to(emb.dtype)
    h, _ = encoder_forward(p.sub("encoder"), cfg.encoder, emb, token_len,
                           xscale=cfg.encoder_xscale, conformer=True)
    return dense(p, "encoder_proj", h)


def flow_inference(
    p: P,
    cfg: FlowConfig,
    token: torch.Tensor,  # (1, T_tok) target speech tokens
    prompt_token: torch.Tensor,  # (1, T_ptok), may be width 0
    prompt_feat: torch.Tensor,  # (1, T_pmel, 80) raw prompt mel, may be width 0
    spk_embedding: torch.Tensor,  # (1, 192)
    n_timesteps: Optional[int] = None,
    finetuned_norm: bool = False,
    mel_norm=(-6.0, 2.0),
    generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None,  # (1, 80, T_pad) injected initial noise
) -> torch.Tensor:
    """Non-streaming inference -> mel (1, 80, T_mel) (prompt region dropped).

    An odd mel length is padded to even for the U-Net, with a valid-frame
    mask (and so a (B, T, T) attention bias) that drops the pad frame.  The
    initial noise ``z`` is drawn from ``generator`` unless given.
    ``finetuned_norm`` applies the merged fine-tune's mel normalize /
    denormalize around the solve."""
    mean, std = mel_norm
    dev = token.device
    T_ptok = prompt_token.shape[1]
    T_tok = token.shape[1]
    spk = dense(p, "spk_embed_affine_layer", _l2_normalize(spk_embedding, dim=1))
    full_token = torch.cat([prompt_token, token], dim=1)
    h = flow_encode(p, cfg, full_token,
                    torch.tensor([T_ptok + T_tok], dtype=torch.int32, device=dev))

    mel_len1 = prompt_feat.shape[1]
    mel_len2 = int(T_tok / cfg.input_frame_rate * 22050 / 256)
    T = mel_len1 + mel_len2
    h = length_regulator_inference(p.sub("length_regulator"), h[:, :T_ptok],
                                   h[:, T_ptok:], mel_len1, mel_len2,
                                   cfg.regulator_stages, cfg.input_frame_rate)
    if finetuned_norm:
        prompt_feat = (prompt_feat - mean) / std
    conds = torch.zeros((1, T, cfg.output_size), dtype=h.dtype, device=dev)
    if mel_len1 > 0:
        conds[:, :mel_len1] = prompt_feat.to(h.dtype)
    conds = conds.transpose(1, 2)

    if n_timesteps is None:
        n_timesteps = 20 if T > 500 else (15 if T > 300 else 10)

    T_pad = T + (T % 2)
    mask = None
    if T_pad != T:
        mask = torch.zeros((1, 1, T_pad), dtype=h.dtype, device=dev)
        mask[:, :, :T] = 1.0
    mu = torch.nn.functional.pad(h.transpose(1, 2), (0, T_pad - T))
    conds = torch.nn.functional.pad(conds, (0, T_pad - T))
    if z is None:
        z = torch.randn((1, cfg.output_size, T_pad), generator=generator,
                        device=dev, dtype=torch.float32).to(h.dtype)
    elif z.shape != (1, cfg.output_size, T_pad):
        raise ValueError(f"z must be (1, {cfg.output_size}, {T_pad}), got {tuple(z.shape)}")

    feat = cfm_solve_euler(p.sub("decoder.estimator"), cfg, z.to(h.dtype), mask, mu,
                           spk, conds, n_timesteps)
    feat = feat[:, :, mel_len1:T]
    if finetuned_norm:
        feat = feat * std + mean
    return feat


class Flow(ParamTree):
    """MaskedDiffWithXvec weights (flow.pt names)."""

    def __init__(self, cfg: FlowConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(flow_spec(cfg), device, dtype, generator)
        self.cfg = cfg


def flow_spec(cfg: FlowConfig) -> Spec:
    spec = Spec()
    spec.embedding("input_embedding", cfg.vocab_size, cfg.input_size)
    spec.linear("spk_embed_affine_layer", cfg.spk_embed_dim, cfg.output_size)
    init_encoder(spec, "encoder", cfg.encoder, conformer=True)
    spec.linear("encoder_proj", cfg.encoder.output_size, cfg.output_size)
    for s in range(cfg.regulator_stages):
        spec.conv1d(f"length_regulator.model.{3 * s}", cfg.output_size,
                    cfg.output_size, 3)
        spec.norm(f"length_regulator.model.{3 * s + 1}", cfg.output_size)
    spec.conv1d(f"length_regulator.model.{3 * cfg.regulator_stages}",
                cfg.output_size, cfg.output_size, 1)
    init_conditional_decoder(spec, "decoder.estimator", cfg.estimator)
    return spec


def init_flow_params(cfg: FlowConfig, device=None, dtype=torch.float32,
                     seed: int = 0) -> Flow:
    """A randomly initialized :class:`Flow` built directly on ``device``."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    return Flow(cfg, dev, dtype, gen)
