"""Conditional flow-matching mel decoder (the port of the JAX package's
``models/flow.py``): token encoder, length regulator, the fixed-step Euler
CFM solve with its classifier-free-guidance batch of 2, and the training
forward (OT-CFM loss, no-prompt modes, anti-leakage strategies).

Training draws every random number from an explicit ``torch.Generator`` on
the tensors' device; each draw can also be passed in (``noise=``,
``draws=``), so a test can feed both packages the same numbers."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..config import AntiLeakageConfig, FlowConfig, NoPromptConfig
from ..ctx import EVAL, Ctx
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


def interpolate_linear_valid(x: torch.Tensor, out_len: int, in_valid: int,
                             out_valid: int) -> torch.Tensor:
    """Length-masked :func:`interpolate_linear`: the first ``in_valid``
    input frames of (B, C, T) onto the first ``out_valid`` of ``out_len``
    output frames, zero beyond; the valid region equals
    ``interpolate_linear(x[..., :in_valid], out_valid)`` to f32 rounding."""
    scale = (torch.tensor(float(in_valid), device=x.device)
             / torch.tensor(float(max(out_valid, 1)), device=x.device))  # in f32, as JAX
    pos = (torch.arange(out_len, dtype=torch.float32, device=x.device) + 0.5) * scale - 0.5
    pos = torch.clamp(pos, 0.0, float(in_valid) - 1.0)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=in_valid - 1)
    w = (pos - lo).to(x.dtype)
    out = x[..., lo] * (1.0 - w) + x[..., hi] * w
    return out * (torch.arange(out_len, device=x.device) < out_valid).to(x.dtype)


def regulator_stack(p: P, x: torch.Tensor, stages: int, ctx: Ctx = EVAL,
                    frames_valid: Optional[int] = None) -> torch.Tensor:
    """Conv3 + GroupNorm(1) + Mish, ``stages`` times, then a 1x1 conv; x (B, C, T).

    ``frames_valid``: the bucket-padded variant; pad frames are re-zeroed
    after every op and the GroupNorm statistics cover the valid frames, so
    the valid region equals the unpadded computation."""
    mask = None
    if frames_valid is not None:
        mask = (torch.arange(x.shape[-1], device=x.device) < frames_valid).to(x.dtype)
        x = x * mask
    for s in range(stages):
        x = conv1d(p, f"model.{3 * s}", x, padding=1, ctx=ctx)
        if mask is not None:
            x = x * mask
        x = mish(group_norm(p, f"model.{3 * s + 1}", x, num_groups=1,
                            frames_valid=frames_valid))
        if mask is not None:
            x = x * mask
    out = conv1d(p, f"model.{3 * stages}", x, ctx=ctx)
    return out if mask is None else out * mask


def length_regulator(p: P, x: torch.Tensor, ylens: torch.Tensor, out_len: int,
                     stages: int, ctx: Ctx = EVAL) -> torch.Tensor:
    """Training regulator: (B, T_tok, C) -> (B, out_len, C), masked by ylens."""
    mask = M.make_non_pad_mask(ylens, out_len)[:, :, None].to(x.dtype)
    h = interpolate_linear(x.transpose(1, 2), out_len)
    return regulator_stack(p, h, stages, ctx).transpose(1, 2) * mask


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


def length_regulator_inference_valid(p: P, x2: torch.Tensor, tok_valid: int, mel_len2: int,
                                     mel_valid: int, stages: int,
                                     input_frame_rate: int = 50) -> torch.Tensor:
    """Length-masked prompt-free :func:`length_regulator_inference`: x2
    (1, T_tok, C) is padded to a token bucket with ``tok_valid`` real rows;
    the output (1, mel_len2, C) holds the unpadded result in its first
    ``mel_valid`` frames and zeros beyond.  Over 40 valid tokens, the first
    and last 20 are interpolated on their own, as in the unpadded form."""
    xt = x2.transpose(1, 2)  # (1, C, T_tok)
    edge = int(20 / input_frame_rate * 22050 / 256)
    if xt.shape[-1] > 40 and tok_valid > 40:
        h = torch.zeros((xt.shape[0], xt.shape[1], mel_len2), dtype=xt.dtype, device=xt.device)
        h[:, :, :edge] = interpolate_linear(xt[:, :, :20], edge)
        h[:, :, edge:mel_len2 - edge] = interpolate_linear_valid(
            xt[:, :, 20:], mel_len2 - 2 * edge, tok_valid - 40, mel_valid - 2 * edge)
        tail = max(mel_valid - edge, 0)
        h[:, :, tail:tail + edge] = interpolate_linear(
            xt[:, :, tok_valid - 20:tok_valid], edge)
    else:
        h = interpolate_linear_valid(xt, mel_len2, tok_valid, mel_valid)
    h = h * (torch.arange(mel_len2, device=h.device) < mel_valid).to(h.dtype)
    return regulator_stack(p, h, stages, frames_valid=mel_valid).transpose(1, 2)


def cfm_t_span(n_timesteps: int, scheduler: str = "cosine", device=None) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n_timesteps + 1, device=device)
    if scheduler == "cosine":
        t = 1.0 - torch.cos(t * 0.5 * PI)
    return t


def cfm_solve_euler(p: P, cfg: FlowConfig, z: torch.Tensor, mask, mu: torch.Tensor,
                    spks: torch.Tensor, cond: torch.Tensor, n_timesteps: int,
                    frames_valid: Optional[int] = None) -> torch.Tensor:
    """Fixed-step Euler ODE solve with the CFG pair batched: each step runs
    the estimator once on [x, x] with [mu, 0] / [spks, 0] / [cond, 0] and
    mixes (1 + r) * d_cond - r * d_uncond, r = inference_cfg_rate.
    ``frames_valid``: the estimator's GroupNorm statistics over the valid
    frames of a bucket-padded solve."""
    B = z.shape[0]
    r = cfg.cfm.inference_cfg_rate
    t_span = cfm_t_span(n_timesteps, cfg.cfm.t_scheduler, z.device)
    mask2 = None if mask is None else torch.cat([mask, mask])
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spks2 = torch.cat([spks, torch.zeros_like(spks)])
    cond2 = torch.cat([cond, torch.zeros_like(cond)])
    fv2 = None if frames_valid is None else torch.full((2 * B,), frames_valid, device=z.device)
    x = z
    for i in range(n_timesteps):
        t, dt = t_span[i], t_span[i + 1] - t_span[i]
        dphi = conditional_decoder(p, cfg.estimator, torch.cat([x, x]), mask2, mu2,
                                   t.expand(2 * B).to(x.dtype), spks2, cond2,
                                   frames_valid=fv2)
        dphi = (1.0 + r) * dphi[:B] - r * dphi[B:]
        x = (x + dt * dphi).to(x.dtype)
    return x.float()


def cfm_compute_loss(
    p: P,
    cfg: FlowConfig,
    generator: Optional[torch.Generator],
    x1: torch.Tensor,  # (B, 80, T) target mel (normalized)
    mask: torch.Tensor,  # (B, 1, T) valid mask
    mu: torch.Tensor,  # (B, 80, T) encoder output
    spks: torch.Tensor,  # (B, 80)
    cond: torch.Tensor,  # (B, 80, T)
    ctx: Ctx,
    prompt_lens: Optional[torch.Tensor] = None,  # (B,) int
    leak: Optional[AntiLeakageConfig] = None,
    noise: Optional[tuple] = None,  # (t_uniform (B,1,1), z (B,80,T), cfg_uniform (B,))
) -> torch.Tensor:
    """OT-CFM loss with prompt masking and boundary weighting.  ``noise``
    overrides the three random draws (pre-scheduler t uniform, z and the
    CFG-dropout uniform), which otherwise come from ``generator``."""
    B, _, T = x1.shape
    dev = x1.device
    leak = leak or AntiLeakageConfig()
    if noise is not None:
        t, z, cfg_u = (torch.as_tensor(a, device=dev).to(x1.dtype) for a in noise)
    else:
        t = torch.rand((B, 1, 1), generator=generator, device=dev).to(x1.dtype)
        z = torch.randn(x1.shape, generator=generator, device=dev).to(x1.dtype)
        cfg_u = torch.rand((B,), generator=generator, device=dev)
    if cfg.cfm.t_scheduler == "cosine":
        t = 1.0 - torch.cos(t * 0.5 * PI)

    sigma = cfg.cfm.sigma_min
    y = (1.0 - (1.0 - sigma) * t) * z + t * x1
    u = x1 - (1.0 - sigma) * z

    if cfg.cfm.training_cfg_rate > 0:
        keep = (cfg_u > cfg.cfm.training_cfg_rate).to(x1.dtype)
        mu = mu * keep[:, None, None]
        spks = spks * keep[:, None]
        cond = cond * keep[:, None, None]

    pred = conditional_decoder(p, cfg.estimator, y, mask, mu, t[:, 0, 0], spks, cond,
                               ctx, prompt_lens=prompt_lens)

    loss_mask = mask
    if prompt_lens is not None:
        idx = torch.arange(T, device=dev)[None, :]
        pl = prompt_lens[:, None]
        w = torch.where(idx < pl, 0.0, 1.0)
        if leak.boundary_loss_enabled:
            in_boundary = (idx >= pl) & (idx < pl + leak.boundary_frames) & (pl > 0)
            w = torch.where(in_boundary, leak.boundary_loss_weight, w)
        loss_mask = loss_mask * w[:, None, :].to(mask.dtype)

    # the weight rides INSIDE the square while the denominator is linear:
    # boundary frames get weight^2 / weight = weight times the emphasis.
    # That is the reference's formula, kept for loss-curve parity.
    diff = (pred - u) * loss_mask
    valid = loss_mask.sum() * u.shape[1]
    return torch.square(diff).sum() / torch.clamp(valid, min=1.0)


def normalize_mel(cfg, mel):
    return (mel - cfg.mel_mean) / cfg.mel_std


def denormalize_mel(cfg, mel):
    return mel * cfg.mel_std + cfg.mel_mean


def flow_encode(p: P, cfg: FlowConfig, token: torch.Tensor,
                token_len: torch.Tensor, ctx: Ctx = EVAL) -> torch.Tensor:
    """input_embedding -> conformer encoder -> encoder_proj."""
    tok_mask = M.make_non_pad_mask(token_len, token.shape[1])[:, :, None]
    emb = embedding(p, "input_embedding", token, clamp_min=0)
    emb = emb * tok_mask.to(emb.dtype)
    h, _ = encoder_forward(p.sub("encoder"), cfg.encoder, emb, token_len, ctx,
                           xscale=cfg.encoder_xscale, conformer=True)
    return dense(p, "encoder_proj", h, ctx)


def _draw(draws: Optional[dict], key: str, B: int, generator, device) -> torch.Tensor:
    """The (B,) uniform draw ``key``: the caller's, or a fresh one."""
    if draws is not None and key in draws:
        return torch.as_tensor(draws[key], device=device)
    return torch.rand((B,), generator=generator, device=device)


def flow_forward_train(
    p: P,
    cfg: FlowConfig,
    generator: Optional[torch.Generator],
    batch: Dict[str, torch.Tensor],
    ctx: Ctx,
    leak: AntiLeakageConfig = AntiLeakageConfig(),
    no_prompt: Union[bool, NoPromptConfig] = False,
    mel_norm: Optional[Tuple[float, float]] = (-6.0, 2.0),
    vendored_style: bool = False,
    noise: Optional[tuple] = None,  # override of cfm_compute_loss's draws
    draws: Optional[dict] = None,  # override of the strategy draws, by name
) -> torch.Tensor:
    """Training forward with the anti-leakage strategies; returns the scalar
    flow loss.

    batch keys: speech_token (B, T_tok), speech_token_len (B,), speech_feat
    (B, T, 80), speech_feat_len (B,), embedding (B, 192), optional
    cross_sample_mel (B, Tc, 80) + cross_sample_mel_len (B,).

    ``no_prompt``: the promptless fine-tune ('full': no prompt at all;
    'mixed': a short own-mel prompt with probability 1 - no_prompt_ratio).
    ``vendored_style`` reproduces the stock CosyVoice training instead: no
    mel normalization, 50% prompt dropout with a prompt of U{0..0.3 len}
    frames, no prompt-loss masking, boundary weighting or isolation.
    Otherwise strategies 1 (silence band), 2 (dynamic prompt length), 3
    (prompt dropout), 5 (cross-sample prompt) and 6 (text blinding) apply.

    ``draws`` names: mixed ``bare_u``, ``plen_u``; vendored ``drop``
    (bool), ``plen_u``; strategies ``dropout_u``, ``prompt_u``, ``blind_u``,
    ``sil_tok`` (ints): (B,) each, uniforms in [0, 1)."""
    if vendored_style:
        mel_norm = None
    mean, std = mel_norm if mel_norm is not None else (0.0, 1.0)
    token = batch["speech_token"].long()
    token_len = batch["speech_token_len"]
    feat = (batch["speech_feat"] - mean) / std  # online mel normalization
    feat_len = batch["speech_feat_len"]
    B, T, _ = feat.shape
    dev = feat.device

    spk = dense(p, "spk_embed_affine_layer",
                _l2_normalize(batch["embedding"].to(feat.dtype), dim=1), ctx)
    h = flow_encode(p, cfg, token, token_len, ctx)
    h = length_regulator(p.sub("length_regulator"), h, feat_len, T, cfg.regulator_stages, ctx)

    feat_bc = feat.transpose(1, 2)  # (B, 80, T)
    mask = M.make_non_pad_mask(feat_len, T)[:, None, :].to(h.dtype)
    idx = torch.arange(T, device=dev)[None, :]
    j = feat_len.long()
    est = p.sub("decoder.estimator")

    def floor_mul(ratio: float) -> torch.Tensor:
        """int(ratio * j) in f32, the reference's arithmetic."""
        return (ratio * j.float()).long()

    def loss(conds, prompt_lens):
        return cfm_compute_loss(est, cfg, generator, feat_bc, mask, h.transpose(1, 2), spk,
                                conds.transpose(1, 2), ctx, prompt_lens=prompt_lens,
                                leak=leak, noise=noise)

    if no_prompt:
        np_cfg = no_prompt if isinstance(no_prompt, NoPromptConfig) else NoPromptConfig()
        if np_cfg.mode == "mixed":
            # per sample: no prompt with probability no_prompt_ratio, else a
            # short prompt ~ randint(1, max(2, 0.1 * len)) of its own mel
            bare = _draw(draws, "bare_u", B, generator, dev) < np_cfg.no_prompt_ratio
            top = torch.clamp(floor_mul(0.1), min=2)
            plen = 1 + (_draw(draws, "plen_u", B, generator, dev) * top).long()
            plen = torch.where(bare, 0, torch.minimum(plen, top))
            conds = torch.where((idx < plen[:, None])[:, :, None], feat, 0.0)
        else:  # 'full': 100% promptless
            conds = torch.zeros_like(feat)
            plen = torch.zeros((B,), dtype=torch.long, device=dev)
        return loss(conds, plen)

    if vendored_style:
        drop = (torch.as_tensor(draws["drop"], device=dev).bool()
                if draws is not None and "drop" in draws
                else torch.rand((B,), generator=generator, device=dev) < 0.5)
        # randint(0, int(0.3 * len)) is inclusive: uniform over {0..K}
        k_top = floor_mul(0.3)
        plen = torch.minimum(
            (_draw(draws, "plen_u", B, generator, dev) * (k_top + 1)).long(), k_top)
        plen = torch.where(drop, 0, plen)
        conds = torch.where((idx < plen[:, None])[:, :, None], feat, 0.0)
        return loss(conds, None)

    # strategy 3: prompt dropout
    if leak.prompt_dropout_enabled:
        dropped = _draw(draws, "dropout_u", B, generator, dev) < leak.prompt_dropout_prob
    else:
        dropped = torch.zeros((B,), dtype=torch.bool, device=dev)

    # strategy 2: dynamic prompt length ~ randint[min_idx, max_idx] inclusive
    if leak.dynamic_prompt_enabled:
        min_idx = torch.clamp(floor_mul(leak.prompt_min_ratio), min=1)
        max_idx = torch.maximum(min_idx + 1, floor_mul(leak.prompt_max_ratio))
        span = max_idx - min_idx + 1
        prompt_lens = min_idx + (_draw(draws, "prompt_u", B, generator, dev) * span).long()
    else:
        prompt_lens = torch.clamp(floor_mul(0.3), min=1)

    # strategy 5: cross-sample prompt source
    cross_mel = batch.get("cross_sample_mel")
    if leak.cross_sample_enabled and cross_mel is not None:
        cross_mel = (cross_mel - mean) / std
        # the collate pads cross_sample_mel to its own bucket: align it to the
        # feat length (frames beyond cross_len are never read)
        Tc = cross_mel.shape[1]
        if Tc < T:
            cross_mel = torch.nn.functional.pad(cross_mel, (0, 0, 0, T - Tc))
        elif Tc > T:
            cross_mel = cross_mel[:, :T]
        cross_len = batch["cross_sample_mel_len"].long()
        use_cross = cross_len > 0
        prompt_lens = torch.where(use_cross, torch.minimum(prompt_lens, cross_len),
                                  prompt_lens)
        prompt_src = torch.where(use_cross[:, None, None], cross_mel.to(feat.dtype), feat)
    else:
        prompt_src = feat

    prompt_lens = torch.where(dropped, 0, prompt_lens)
    in_prompt = idx < prompt_lens[:, None]  # (B, T)
    conds = torch.where(in_prompt[:, :, None], prompt_src, 0.0)
    # text blinding (strategy 6) covers the ORIGINAL prompt region only, even
    # when the recorded prompt_lens gains the silence band
    in_blind = in_prompt

    # strategy 1: silence isolation band (off by default)
    if leak.silence_padding_enabled:
        if draws is not None and "sil_tok" in draws:
            sil_tok = torch.as_tensor(draws["sil_tok"], device=dev).long()
        else:
            sil_tok = torch.randint(leak.silence_min_tokens, leak.silence_max_tokens + 1,
                                    (B,), generator=generator, device=dev)
        sil_frames = torch.clamp(sil_tok * 22050 // 256 // cfg.input_frame_rate, 3, 20)
        fits = (prompt_lens + sil_frames < j) & (prompt_lens > 0)
        sil_val = (leak.silence_mel_value - mean) / std
        in_sil = ((idx >= prompt_lens[:, None])
                  & (idx < (prompt_lens + sil_frames)[:, None]) & fits[:, None])
        conds = torch.where(in_sil[:, :, None], sil_val, conds)
        prompt_lens = torch.where(fits, prompt_lens + sil_frames, prompt_lens)

    # strategy 6: text blinding, zero encoder output in the prompt region
    if leak.text_blinding_enabled:
        blind = _draw(draws, "blind_u", B, generator, dev) < leak.text_blinding_prob
        h = torch.where((blind[:, None] & in_blind)[:, :, None], 0.0, h)

    return loss(conds, prompt_lens)


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
    flow_cache: Optional[torch.Tensor] = None,  # (1, 80, C, 2) z / mu carry
    return_cache: bool = False,
    token_valid: Optional[int] = None,  # true token count of a bucket-padded window
    mel_valid: Optional[int] = None,  # true mel frames of that window
):
    """Inference -> mel (1, 80, T_mel) (prompt region dropped).

    An odd mel length is padded to even for the U-Net, with a valid-frame
    mask (and so a (B, T, T) attention bias) that drops the pad frame.  The
    initial noise ``z`` is drawn at the padded length from ``generator``
    unless given.  ``finetuned_norm`` applies the merged fine-tune's mel
    normalize / denormalize around the solve.

    Streaming: ``flow_cache`` overwrites the head of z and mu with the
    previous window's carry, so consecutive windows share noise; with
    ``return_cache`` the result is (mel, new carry), the carry holding the
    prompt region and frames ``[T-34, T)`` of the UNPADDED length T.

    ``token_valid`` / ``mel_valid`` (prompt-free only): the bucketed final
    chunk.  ``token`` is padded to a bucket; the first ``mel_valid`` output
    frames equal the unpadded solve's (masked regulator, estimator
    statistics and attention) and the rest are zero.  Pass ``n_timesteps``
    chosen from the true length."""
    mean, std = mel_norm
    dev = token.device
    T_ptok = prompt_token.shape[1]
    T_tok = token.shape[1]
    if token_valid is not None and (T_ptok or prompt_feat.shape[1] or return_cache
                                    or mel_valid is None or n_timesteps is None):
        raise ValueError("the bucketed window is prompt-free, returns no cache and needs "
                         "mel_valid and n_timesteps")
    spk = dense(p, "spk_embed_affine_layer", _l2_normalize(spk_embedding, dim=1))
    full_token = torch.cat([prompt_token, token], dim=1)
    token_len = T_ptok + T_tok if token_valid is None else token_valid
    h = flow_encode(p, cfg, full_token, torch.tensor([token_len], dtype=torch.int32, device=dev))

    mel_len1 = prompt_feat.shape[1]
    mel_len2 = int(T_tok / cfg.input_frame_rate * 22050 / 256)
    T = mel_len1 + mel_len2
    if token_valid is not None:
        h = length_regulator_inference_valid(p.sub("length_regulator"), h, token_valid,
                                             mel_len2, mel_valid, cfg.regulator_stages,
                                             cfg.input_frame_rate)
    else:
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
    if token_valid is not None:
        mask = (torch.arange(T_pad, device=dev) < mel_valid).to(h.dtype)[None, None]
    elif T_pad != T:
        mask = torch.zeros((1, 1, T_pad), dtype=h.dtype, device=dev)
        mask[:, :, :T] = 1.0
    mu = torch.nn.functional.pad(h.transpose(1, 2), (0, T_pad - T))
    conds = torch.nn.functional.pad(conds, (0, T_pad - T))
    if z is None:
        z = torch.randn((1, cfg.output_size, T_pad), generator=generator,
                        device=dev, dtype=torch.float32)
    elif z.shape != (1, cfg.output_size, T_pad):
        raise ValueError(f"z must be (1, {cfg.output_size}, {T_pad}), got {tuple(z.shape)}")
    z = z.to(h.dtype)
    if flow_cache is not None and flow_cache.shape[2]:
        cs = min(flow_cache.shape[2], T_pad)
        z = z.clone()
        z[:, :, :cs] = flow_cache[:, :, :cs, 0].to(z.dtype)
        mu[:, :, :cs] = flow_cache[:, :, :cs, 1].to(mu.dtype)
    if return_cache:
        new_cache = torch.stack([torch.cat([x[:, :, :mel_len1], x[:, :, T - 34:T]], dim=2)
                                 for x in (z, mu)], dim=-1)

    feat = cfm_solve_euler(p.sub("decoder.estimator"), cfg, z, mask, mu, spk, conds,
                           n_timesteps, frames_valid=mel_valid)
    feat = feat[:, :, mel_len1:T]
    if finetuned_norm:
        feat = feat * std + mean
    if token_valid is not None:
        # the pad frames keep z's noise through the solve; the masked
        # vocoder needs exact zeros there
        feat = feat * (torch.arange(feat.shape[2], device=dev) < mel_valid)
    return (feat, new_cache) if return_cache else feat


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
