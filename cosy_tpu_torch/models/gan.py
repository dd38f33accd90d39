"""HiFi-GAN adversarial training: the discriminators, the GAN losses and the
DPO preference loss (the port of the JAX package's ``models/gan.py``).

Reference behavior: cosyvoice/hifigan/hifigan.py (the generator and
discriminator turns), cosyvoice/hifigan/discriminator.py
(MultipleDiscriminator = MPD + MRD), matcha/hifigan/models.py:209-368
(DiscriminatorP and the feature, generator and discriminator losses) and
cosyvoice/utils/losses.py (tpr_loss, mel_loss, DPOLoss).

Functions over flat torch-named dicts.  The discriminators keep torch's
weight-norm factorization (``weight_g`` / ``weight_v``), computed on the fly
by ``layers.basic.conv2d``, so the adversarial optimization moves g and v as
torch training does.  The generator's sine-source draws (initial phases and
additive noise) can be passed in, so a test feeds both packages JAX's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import HiFTConfig
from ..layers.basic import conv2d, leaky_relu
from ..ops import audio as A
from ..parallel.mesh import gather_rows
from ..params import P, Params, resolve_device
from . import hift as H

LRELU_SLOPE = 0.1

MPD_PERIODS = (2, 3, 5, 7, 11)
MRD_FFT_SIZES = (2048, 1024, 512)
MRD_BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))


# ---------------------------------------------------------------------------
# Discriminators
# ---------------------------------------------------------------------------


def discriminator_p(p: P, x: torch.Tensor, period: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Period discriminator (matcha models.py:209-244): x (B, 1, T) ->
    (score map (B, -1), feature maps)."""
    B, C, T = x.shape
    if T % period:
        pad = period - T % period
        x = F.pad(x, (0, pad), mode="reflect")
        T += pad
    x = x.reshape(B, C, T // period, period)
    fmap = []
    for i in range(5):
        x = leaky_relu(conv2d(p, f"convs.{i}", x, stride=(3, 1) if i < 4 else (1, 1),
                              padding=(2, 0)), LRELU_SLOPE)
        fmap.append(x)
    x = conv2d(p, "conv_post", x, padding=(1, 0))
    fmap.append(x)
    return x.reshape(B, -1), fmap


def _spectrogram_2ch(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """DC-removed, peak-normalized complex STFT as two channels
    (discriminator.py:118-129): (B, T) -> (B, 2, frames, F)."""
    x = x - x.mean(dim=-1, keepdim=True)
    x = 0.8 * x / (x.abs().amax(dim=-1, keepdim=True) + 1e-9)
    re, im = A.stft_center(x, n_fft, hop)  # (B, F, T) each
    return torch.stack([re, im], dim=1).transpose(2, 3)


def discriminator_r(p: P, x: torch.Tensor, window_length: int
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Multi-band resolution discriminator (discriminator.py:81-152): x (B, T)
    -> (score map, feature maps)."""
    spec = _spectrogram_2ch(x, window_length, int(window_length * 0.25))
    n_bins = window_length // 2 + 1
    fmap, outs = [], []
    for bi, (lo, hi) in enumerate(MRD_BANDS):
        band = spec[..., int(lo * n_bins):int(hi * n_bins)]
        for i in range(5):
            band = leaky_relu(conv2d(p.sub(f"band_convs.{bi}"), f"{i}", band,
                                     stride=(1, 1) if i in (0, 4) else (1, 2),
                                     padding=(1, 4) if i < 4 else (1, 1)), 0.1)
            if i > 0:
                fmap.append(band)
        outs.append(band)
    x = conv2d(p, "conv_post", torch.cat(outs, dim=-1), padding=(1, 1))
    fmap.append(x)
    return x, fmap


def multiple_discriminator(p: P, y: torch.Tensor, y_hat: torch.Tensor):
    """MPD + MRD over (real, generated) (discriminator.py:15-38); y, y_hat
    (B, T) -> (real scores, generated scores, real fmaps, generated fmaps)."""
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
    for i, period in enumerate(MPD_PERIODS):
        sp = p.sub(f"mpd.discriminators.{i}")
        for out, fm, x in ((y_d_rs, fmap_rs, y), (y_d_gs, fmap_gs, y_hat)):
            score, f = discriminator_p(sp, x[:, None, :], period)
            out.append(score)
            fm.append(f)
    for i, w in enumerate(MRD_FFT_SIZES):
        sp = p.sub(f"mrd.discriminators.{i}")
        for out, fm, x in ((y_d_rs, fmap_rs, y), (y_d_gs, fmap_gs, y_hat)):
            score, f = discriminator_r(sp, x, w)
            out.append(score)
            fm.append(f)
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def generator_adv_loss(disc_outputs: List[torch.Tensor]) -> torch.Tensor:
    """sum mean((1 - dg)^2) (matcha models.py:360-368)."""
    return sum(torch.mean(torch.square(1.0 - dg.float())) for dg in disc_outputs)


def discriminator_adv_loss(real: List[torch.Tensor], gen: List[torch.Tensor]) -> torch.Tensor:
    """sum mean((1 - dr)^2) + mean(dg^2) (matcha models.py:346-357)."""
    return sum(torch.mean(torch.square(1.0 - dr.float())) + torch.mean(torch.square(dg.float()))
               for dr, dg in zip(real, gen))


def feature_match_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 * sum mean |fr - fg| (matcha models.py:337-343)."""
    return 2.0 * sum(torch.mean(torch.abs(rl.float() - gl.float()))
                     for dr, dg in zip(fmap_r, fmap_g) for rl, gl in zip(dr, dg))


def tpr_loss(disc_real: List[torch.Tensor], disc_gen: List[torch.Tensor],
             tau: float) -> torch.Tensor:
    """Truncated pointwise relativistic loss (losses.py:6-12): per score map,
    the mean of (d - median)^2 over the entries d = dr - dg below the
    median, truncated at ``tau``.  The median of an even count is the mean
    of the two middle values, as ``jnp.median`` takes it."""
    loss = 0.0
    for dr, dg in zip(disc_real, disc_gen):
        # the median is over the whole batch: data-parallel ranks gather it
        diff = gather_rows((dr - dg).float()).reshape(-1)
        m = torch.quantile(diff, 0.5)
        sel = diff < m
        l_rel = torch.where(sel, torch.square(diff - m), 0.0).sum() / torch.clamp(sel.sum(), min=1)
        loss = loss + tau - F.relu(tau - l_rel)
    return loss


def multi_mel_loss(real: torch.Tensor, gen: torch.Tensor, mel_configs=None) -> torch.Tensor:
    """sum_i L1(mel_i(gen), mel_i(real)) (losses.py:15-21); by default one
    transform at the model's mel configuration."""
    mel_configs = mel_configs or [dict(n_fft=1024, n_mels=80, sr=22050, hop=256, win=1024)]
    return sum(torch.mean(torch.abs(A.mel_spectrogram(gen, **c) - A.mel_spectrogram(real, **c)))
               for c in mel_configs)


def dpo_loss(policy_chosen_logps: torch.Tensor, policy_rejected_logps: torch.Tensor,
             reference_chosen_logps: torch.Tensor, reference_rejected_logps: torch.Tensor,
             beta: float = 0.01, label_smoothing: float = 0.0, ipo: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DPO preference loss (losses.py:24-68) -> (loss, chosen rewards,
    rejected rewards), the rewards detached."""
    logits = (policy_chosen_logps - policy_rejected_logps) - (
        reference_chosen_logps - reference_rejected_logps)
    if ipo:
        losses = torch.square(logits - 1.0 / (2.0 * beta))
    else:
        losses = (-F.logsigmoid(beta * logits) * (1 - label_smoothing)
                  - F.logsigmoid(-beta * logits) * label_smoothing)
    chosen_r = (beta * (policy_chosen_logps - reference_chosen_logps)).detach()
    rejected_r = (beta * (policy_rejected_logps - reference_rejected_logps)).detach()
    return losses.mean(), chosen_r, rejected_r


# ---------------------------------------------------------------------------
# HiFi-GAN turns (hifigan.py:22-74)
# ---------------------------------------------------------------------------


def hift_forward_train(gen: P, cfg: HiFTConfig, mel: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       phase: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training generator forward: mel (B, 80, T) -> (wav (B, T * hop),
    f0 (B, T)); the sine source's ``phase`` (B, H, 1) and ``noise``
    (B, H, L) are drawn from ``generator`` unless given."""
    up_total = int(np.prod(cfg.upsample_rates)) * cfg.istft_hop_len
    f0 = H.f0_predict(gen.sub("f0_predictor"), mel)
    f0_up = f0[:, None, :, None].expand(-1, 1, -1, up_total).reshape(f0.shape[0], 1, -1)
    s = H.sine_source(gen.sub("m_source"), cfg, f0_up, generator, phase, noise)
    return H.hift_decode(gen, cfg, mel, s), f0


def _real_gen(batch, gen_wav):
    real = batch["speech"]
    n = min(real.shape[-1], gen_wav.shape[-1])
    return real[:, :n], gen_wav[:, :n]


def hifigan_generator_loss(gen_params: Params, disc_params: Params, cfg: HiFTConfig,
                           batch: Dict[str, torch.Tensor],
                           generator: Optional[torch.Generator] = None,
                           mel_weight: float = 45.0, feat_match_weight: float = 2.0,
                           tpr_weight: float = 1.0, tpr_tau: float = 0.04,
                           source_draws: Optional[tuple] = None) -> Dict[str, torch.Tensor]:
    """The generator turn's losses.  batch: speech (B, T * hop), speech_feat
    (B, T, 80), pitch_feat (B, T); ``source_draws`` = (phase, noise)."""
    phase, noise = source_draws or (None, None)
    wav, f0 = hift_forward_train(P(gen_params), cfg, batch["speech_feat"].transpose(1, 2),
                                 generator, phase, noise)
    real, wav = _real_gen(batch, wav)
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = multiple_discriminator(P(disc_params), real, wav)
    loss_gen = generator_adv_loss(y_d_gs)
    loss_fm = feature_match_loss(fmap_rs, fmap_gs)
    loss_mel = multi_mel_loss(real, wav)
    loss_tpr = tpr_loss(y_d_gs, y_d_rs, tpr_tau) if tpr_weight != 0 else \
        torch.zeros((), device=wav.device)
    loss_f0 = torch.mean(torch.abs(f0 - batch["pitch_feat"]))
    loss = (loss_gen + feat_match_weight * loss_fm + mel_weight * loss_mel
            + tpr_weight * loss_tpr + loss_f0)
    return {"loss": loss, "loss_gen": loss_gen, "loss_fm": loss_fm, "loss_mel": loss_mel,
            "loss_tpr": loss_tpr, "loss_f0": loss_f0}


def hifigan_discriminator_loss(gen_params: Params, disc_params: Params, cfg: HiFTConfig,
                               batch: Dict[str, torch.Tensor],
                               generator: Optional[torch.Generator] = None,
                               tpr_weight: float = 1.0, tpr_tau: float = 0.04,
                               source_draws: Optional[tuple] = None
                               ) -> Dict[str, torch.Tensor]:
    """The discriminator turn's losses on a generated wav without a
    gradient to the generator."""
    phase, noise = source_draws or (None, None)
    with torch.no_grad():
        wav, _ = hift_forward_train(P(gen_params), cfg, batch["speech_feat"].transpose(1, 2),
                                    generator, phase, noise)
    real, wav = _real_gen(batch, wav)
    y_d_rs, y_d_gs, _, _ = multiple_discriminator(P(disc_params), real, wav)
    loss_disc = discriminator_adv_loss(y_d_rs, y_d_gs)
    loss_tpr = tpr_loss(y_d_rs, y_d_gs, tpr_tau) if tpr_weight != 0 else \
        torch.zeros((), device=wav.device)
    return {"loss": loss_disc + tpr_weight * loss_tpr, "loss_disc": loss_disc,
            "loss_tpr": loss_tpr}


# ---------------------------------------------------------------------------
# Initialization (weight-norm factorization: weight_g / weight_v)
# ---------------------------------------------------------------------------


def _wn_conv2d(d: Params, g: torch.Generator, name: str, in_c: int, out_c: int, kh: int,
               kw: int, device):
    bound = math.sqrt(1.0 / (in_c * kh * kw))
    v = torch.empty((out_c, in_c, kh, kw), device=device).uniform_(-bound, bound, generator=g)
    d[name + ".weight_v"] = v
    d[name + ".weight_g"] = torch.sqrt(torch.sum(torch.square(v), dim=(1, 2, 3), keepdim=True))
    d[name + ".bias"] = torch.empty((out_c,), device=device).uniform_(-bound, bound, generator=g)


def init_discriminator_params(device=None, seed: int = 0, channels: int = 32,
                              mpd_channels=(1, 32, 128, 512, 1024, 1024)) -> Params:
    """MultipleDiscriminator weights (MPD over 5 periods, MRD over 3
    resolutions) with the JAX package's names, shapes and uniform bounds,
    drawn from a generator seeded by ``seed`` on ``device`` (CUDA unless
    asked).  ``mpd_channels`` / ``channels`` narrow them for tests."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d: Params = {}
    chs = mpd_channels
    for i in range(len(MPD_PERIODS)):
        pre = f"mpd.discriminators.{i}"
        for j in range(5):
            _wn_conv2d(d, g, f"{pre}.convs.{j}", chs[j], chs[j + 1], 5, 1, dev)
        _wn_conv2d(d, g, f"{pre}.conv_post", chs[5], 1, 3, 1, dev)
    for i in range(len(MRD_FFT_SIZES)):
        pre = f"mrd.discriminators.{i}"
        for b in range(len(MRD_BANDS)):
            _wn_conv2d(d, g, f"{pre}.band_convs.{b}.0", 2, channels, 3, 9, dev)
            for j in range(1, 4):
                _wn_conv2d(d, g, f"{pre}.band_convs.{b}.{j}", channels, channels, 3, 9, dev)
            _wn_conv2d(d, g, f"{pre}.band_convs.{b}.4", channels, channels, 3, 3, dev)
        _wn_conv2d(d, g, f"{pre}.conv_post", channels, 1, 3, 3, dev)
    return d
