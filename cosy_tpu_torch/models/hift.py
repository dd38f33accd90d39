"""HiFT NSF-iSTFT vocoder: mel (B, 80, T) -> waveform (B, T * 256) (the port
of the JAX package's ``models/hift.py``), with the streaming source carry
and the bucket-padded (``mel_valid``) variant of the final chunk.

Weight norm is folded into plain ``.weight`` keys at load
(``params.fold_weight_norm``).  The sine source's random initial phases and
additive noise come from an explicit ``torch.Generator`` or are injected.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import HiFTConfig
from ..layers.basic import conv1d, conv_transpose1d, dense, leaky_relu, snake
from ..ops.audio import istft, stft_center
from ..params import P, ParamTree, Spec, resolve_device


def _get_padding(kernel: int, dilation: int = 1) -> int:
    return (kernel * dilation - dilation) // 2


def _vmask(length: int, valid: int, like: torch.Tensor) -> torch.Tensor:
    """(1, 1, length) mask of the first ``valid`` frames."""
    return (torch.arange(length, device=like.device) < valid).to(like.dtype)[None, None]


def f0_predict(p: P, mel: torch.Tensor, mel_valid: Optional[int] = None) -> torch.Tensor:
    """(B, 80, T) -> (B, T) f0 in Hz (ConvRNNF0Predictor).  ``mel_valid``:
    pad frames are re-zeroed after every conv (elu(bias) is nonzero there
    and the next conv's window would carry it into the valid tail)."""
    mask = None if mel_valid is None else _vmask(mel.shape[-1], mel_valid, mel)
    x = mel if mask is None else mel * mask
    for i in range(5):
        x = F.elu(conv1d(p, f"condnet.{2 * i}", x, padding=1))
        if mask is not None:
            x = x * mask
    return torch.abs(dense(p, "classifier", x.transpose(1, 2)))[:, :, 0]


def sine_source(
    p: P,
    cfg: HiFTConfig,
    f0_up: torch.Tensor,  # (B, 1, L) upsampled f0 in Hz
    generator: Optional[torch.Generator] = None,
    phase: Optional[torch.Tensor] = None,  # (B, H, 1) uniform in [-pi, pi)
    noise: Optional[torch.Tensor] = None,  # (B, H, L) standard normal
) -> torch.Tensor:
    """(B, 1, L) harmonic excitation: per-harmonic phase accumulation with
    random initial phases (the fundamental's fixed at 0), voiced/unvoiced
    gating and additive noise, merged by tanh(linear(harmonics))."""
    B, _, L = f0_up.shape
    H = cfg.nb_harmonics + 1
    dev = f0_up.device
    if phase is None:
        phase = torch.rand((B, H, 1), generator=generator, device=dev) * (2 * math.pi) - math.pi
    if noise is None:
        noise = torch.randn((B, H, L), generator=generator, device=dev)
    harmonics = torch.arange(1, H + 1, dtype=torch.float32, device=dev)[None, :, None]
    f_mat = f0_up * harmonics / cfg.sampling_rate  # (B, H, L)
    theta = 2.0 * math.pi * torch.remainder(torch.cumsum(f_mat, dim=-1), 1.0)
    phase = phase.clone()
    phase[:, 0, :] = 0.0
    sine = cfg.nsf_alpha * torch.sin(theta + phase)
    uv = (f0_up > cfg.nsf_voiced_threshold).float()
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    sine = sine * uv + noise_amp * noise
    return torch.tanh(dense(p, "l_linear", sine.transpose(1, 2))).transpose(1, 2)


def resblock(p: P, name: str, x: torch.Tensor, kernel: int,
             dilations: Tuple[int, ...], mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Snake-activated dilated residual block; ``mask`` re-zeroes the conv
    outputs' pad frames (snake(0) = 0 keeps them zero)."""
    sp = p.sub(name)
    for i, d in enumerate(dilations):
        xt = snake(x, p[f"{name}.activations1.{i}.alpha"].float())
        xt = conv1d(sp, f"convs1.{i}", xt, padding=_get_padding(kernel, d), dilation=d)
        if mask is not None:
            xt = xt * mask
        xt = snake(xt, p[f"{name}.activations2.{i}.alpha"].float())
        xt = conv1d(sp, f"convs2.{i}", xt, padding=_get_padding(kernel, 1))
        if mask is not None:
            xt = xt * mask
        x = xt + x
    return x


def hift_decode(p: P, cfg: HiFTConfig, mel: torch.Tensor, source: torch.Tensor,
                mel_valid: Optional[int] = None) -> torch.Tensor:
    """Deterministic decode given an excitation source (B, 1, T * 256).

    ``mel_valid``: the bucket-padded variant.  Every conv output is
    re-zeroed beyond its level's valid length and the iSTFT runs over the
    valid frames, so samples below ``mel_valid * 256`` equal the unpadded
    decode's and the rest are zero.  ``mel`` and ``source`` must be zero
    beyond the valid region, the source carrying the STFT's reflect pad at
    the true boundary (see hift_inference)."""
    n_fft, hop = cfg.istft_n_fft, cfg.istft_hop_len
    s_re, s_im = stft_center(source[:, 0, :], n_fft, hop)
    s_stft = torch.cat([s_re, s_im], dim=1)  # (B, n_fft + 2, Ts)
    lvl_valid = mel_valid
    if mel_valid is not None:
        # one STFT frame per hop of the valid source, plus one (centred)
        s_stft = s_stft * _vmask(s_stft.shape[-1],
                                 mel_valid * int(np.prod(cfg.upsample_rates)) + 1, mel)

    x = conv1d(p, "conv_pre", mel, padding=3)
    if mel_valid is not None:
        x = x * _vmask(x.shape[-1], mel_valid, x)
    num_up = len(cfg.upsample_rates)
    nk = len(cfg.resblock_kernel_sizes)
    down_cum = list(np.cumprod([1] + list(cfg.upsample_rates)[::-1][:-1])[::-1])
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = leaky_relu(x, cfg.lrelu_slope)
        x = conv_transpose1d(p, f"ups.{i}", x, stride=u, padding=(k - u) // 2)
        if i == num_up - 1:
            x = F.pad(x, (1, 0), mode="reflect")
        m = None
        if lvl_valid is not None:
            lvl_valid = lvl_valid * u + (1 if i == num_up - 1 else 0)
            m = _vmask(x.shape[-1], lvl_valid, x)
            x = x * m
        du = int(down_cum[i])
        if du == 1:
            si = conv1d(p, f"source_downs.{i}", s_stft)
        else:
            si = conv1d(p, f"source_downs.{i}", s_stft, stride=du, padding=du // 2)
        ms = None if m is None else m[:, :, :si.shape[-1]]
        if ms is not None:
            si = si * ms
        si = resblock(p, f"source_resblocks.{i}", si, cfg.source_resblock_kernel_sizes[i],
                      cfg.source_resblock_dilation_sizes[i], ms)
        x = x + si
        xs = None
        for j in range(nk):
            r = resblock(p, f"resblocks.{i * nk + j}", x, cfg.resblock_kernel_sizes[j],
                         cfg.resblock_dilation_sizes[j], m)
            xs = r if xs is None else xs + r
        x = xs / nk

    x = conv1d(p, "conv_post", leaky_relu(x), padding=3)
    magnitude = torch.clamp(torch.exp(x[:, : n_fft // 2 + 1, :]), max=1e2)
    phase = torch.sin(x[:, n_fft // 2 + 1:, :])
    wav = istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase), n_fft, hop,
                valid_frames=lvl_valid)
    return torch.clamp(wav, -cfg.audio_limit, cfg.audio_limit)


def hift_inference(
    p: P,
    cfg: HiFTConfig,
    mel: torch.Tensor,  # (B, 80, T)
    generator: Optional[torch.Generator] = None,
    phase: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    cache_source: Optional[torch.Tensor] = None,  # (B, 1, L_cache) streaming carry
    mel_valid: Optional[int] = None,  # true frames of a bucket-padded mel
):
    """mel -> (wav (B, T * 256), source (B, 1, T * 256)).

    The sine source is built at the full length (its noise draw keeps that
    shape), then ``mel_valid`` zeroes it beyond the true end and writes the
    STFT's end reflect pad at the true boundary, and ``cache_source``
    overwrites its head with the previous chunk's tail."""
    up_total = int(np.prod(cfg.upsample_rates)) * cfg.istft_hop_len
    f0 = f0_predict(p.sub("f0_predictor"), mel, mel_valid)
    f0_up = torch.repeat_interleave(f0, up_total, dim=1)[:, None, :]  # nearest
    s = sine_source(p.sub("m_source"), cfg, f0_up, generator, phase, noise)
    if mel_valid is not None:
        L, Lv, pad = s.shape[-1], mel_valid * up_total, cfg.istft_n_fft // 2
        s = s * _vmask(L, Lv, s)
        # where the buffer ends at the true boundary, the STFT's own reflect
        # pad applies
        if Lv + pad <= L:
            s[:, :, Lv:Lv + pad] = torch.flip(s[:, :, Lv - pad - 1:Lv - 1], dims=(2,))
    if cache_source is not None and cache_source.shape[2]:
        s = s.clone()
        s[:, :, :cache_source.shape[2]] = cache_source
    return hift_decode(p, cfg, mel, s, mel_valid), s


class HiFT(ParamTree):
    """HiFTGenerator weights (hift.pt names, weight norm folded)."""

    def __init__(self, cfg: HiFTConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hift_spec(cfg), device, dtype, generator)
        self.cfg = cfg


def hift_spec(cfg: HiFTConfig) -> Spec:
    spec = Spec()
    spec.linear("m_source.l_linear", cfg.nb_harmonics + 1, 1)
    spec.conv1d("conv_pre", cfg.in_channels, cfg.base_channels, 7)
    ch = cfg.base_channels
    nk = len(cfg.resblock_kernel_sizes)
    down_cum = list(np.cumprod([1] + list(cfg.upsample_rates)[::-1][:-1])[::-1])
    ones = lambda t, g: t.fill_(1.0)  # noqa: E731
    c = ch
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        spec.conv_transpose1d(f"ups.{i}", ch // (2 ** i), ch // (2 ** (i + 1)), k)
        c = ch // (2 ** (i + 1))
        du = int(down_cum[i])
        spec.conv1d(f"source_downs.{i}", cfg.istft_n_fft + 2, c, 1 if du == 1 else du * 2)
        sk = cfg.source_resblock_kernel_sizes[i]
        for j, _ in enumerate(cfg.source_resblock_dilation_sizes[i]):
            spec.conv1d(f"source_resblocks.{i}.convs1.{j}", c, c, sk)
            spec.conv1d(f"source_resblocks.{i}.convs2.{j}", c, c, sk)
            spec.add(f"source_resblocks.{i}.activations1.{j}.alpha", (c,), ones)
            spec.add(f"source_resblocks.{i}.activations2.{j}.alpha", (c,), ones)
        for j in range(nk):
            kk = cfg.resblock_kernel_sizes[j]
            for m, _ in enumerate(cfg.resblock_dilation_sizes[j]):
                spec.conv1d(f"resblocks.{i * nk + j}.convs1.{m}", c, c, kk)
                spec.conv1d(f"resblocks.{i * nk + j}.convs2.{m}", c, c, kk)
                spec.add(f"resblocks.{i * nk + j}.activations1.{m}.alpha", (c,), ones)
                spec.add(f"resblocks.{i * nk + j}.activations2.{m}.alpha", (c,), ones)
    spec.conv1d("conv_post", c, cfg.istft_n_fft + 2, 7)
    for i in range(5):
        spec.conv1d(f"f0_predictor.condnet.{2 * i}",
                    cfg.in_channels if i == 0 else cfg.f0_predictor_cond_channels,
                    cfg.f0_predictor_cond_channels, 3)
    spec.linear("f0_predictor.classifier", cfg.f0_predictor_cond_channels, 1)
    return spec


def init_hift_params(cfg: HiFTConfig, device=None, dtype=torch.float32,
                     seed: int = 0) -> HiFT:
    """A randomly initialized :class:`HiFT` built directly on ``device``."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    return HiFT(cfg, dev, dtype, gen)
