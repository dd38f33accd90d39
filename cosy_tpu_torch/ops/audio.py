"""Audio feature ops, the port of the JAX package's ``ops/audio.py``.

- The mel frontend the pretrained flow and HiFT expect (matcha
  audio.py:45-82): reflect pad (n_fft - hop) / 2 | periodic-Hann STFT,
  center=False | sqrt(re^2 + im^2 + 1e-9) | Slaney mel basis |
  ln(max(x, 1e-5)).  It runs on the waveform's device: framing and
  ``torch.fft.rfft``; the filterbank is host numpy, made once.
- STFT / iSTFT of the HiFT head (n_fft 16, hop 4, periodic Hann window,
  centered): plain ``torch.stft`` / ``torch.istft``; the JAX package's
  matmul-rFFT was a TPU workaround.

No Pallas kernel lies behind any of these, so library FFTs are the port.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# CosyVoice-300M mel config (model-dir yaml); CosyVoice2 runs at 24 kHz with
# n_fft = win = 1920 and hop 480
N_FFT = 1024
NUM_MELS = 80
SAMPLE_RATE = 22050
HOP_SIZE = 256
WIN_SIZE = 1024
FMIN = 0.0
FMAX = 8000.0


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mels = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = m >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int = SAMPLE_RATE, n_fft: int = N_FFT, n_mels: int = NUM_MELS,
                   fmin: float = FMIN, fmax: float = FMAX) -> np.ndarray:
    """(n_mels, 1 + n_fft // 2) Slaney-normalized triangular filterbank
    (librosa.filters.mel(htk=False, norm='slaney')), host numpy."""
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)), _hz_to_mel(np.array(fmax)), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def stft_magnitude(y: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP_SIZE,
                   win: int = WIN_SIZE, eps: float = 1e-9) -> torch.Tensor:
    """(B, L) pre-padded -> (B, 1 + n_fft // 2, T) magnitude spectrum: frames
    of n_fft samples every hop (no centering), periodic Hann of ``win``."""
    frames = y.float().unfold(-1, n_fft, hop) * _window(win, y.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)  # (B, T, F)
    return torch.sqrt(spec.real.square() + spec.imag.square() + eps).transpose(1, 2)


def num_mel_frames(n_samples: int, n_fft: int = N_FFT, hop: int = HOP_SIZE) -> int:
    padded = n_samples + 2 * ((n_fft - hop) // 2)
    return 1 + (padded - n_fft) // hop


def mel_spectrogram_prepadded(y: torch.Tensor, n_fft: int = N_FFT, n_mels: int = NUM_MELS,
                              sr: int = SAMPLE_RATE, hop: int = HOP_SIZE, win: int = WIN_SIZE,
                              fmin: float = FMIN, fmax: float = FMAX) -> torch.Tensor:
    """:func:`mel_spectrogram` of a (B, L) waveform ALREADY reflect-padded by
    (n_fft - hop) // 2: callers that bucket the length (a zero tail) pad the
    true signal first, so its last frames read the reflected signal end.
    Frames inside the true padded span equal mel_spectrogram's."""
    mag = stft_magnitude(y, n_fft, hop, win)
    basis = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax), device=y.device)
    return torch.log(torch.clamp(basis @ mag, min=1e-5))


def mel_spectrogram(y: torch.Tensor, n_fft: int = N_FFT, n_mels: int = NUM_MELS,
                    sr: int = SAMPLE_RATE, hop: int = HOP_SIZE, win: int = WIN_SIZE,
                    fmin: float = FMIN, fmax: float = FMAX) -> torch.Tensor:
    """(B, L) waveform in [-1, 1] -> (B, n_mels, T) natural-log mel
    spectrogram, T = num_mel_frames(L), on the waveform's device."""
    pad = (n_fft - hop) // 2
    y = F.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    return mel_spectrogram_prepadded(y, n_fft, n_mels, sr, hop, win, fmin, fmax)


def _window(n_fft: int, device) -> torch.Tensor:
    return torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=device)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int,
          valid_frames: Optional[int] = None) -> torch.Tensor:
    """(B, F, T) real/imag -> (B, hop * (T - 1)) signal: overlap-add with
    window-square normalization, centre-cropped by n_fft // 2 (torch.istft
    with center=True).  ``valid_frames``: only the first frames are real;
    the signal is the iSTFT of those frames (its window-square envelope
    theirs alone), zero-padded to the full length."""
    T = real.shape[-1]
    if valid_frames is not None:
        real, imag = real[..., :valid_frames], imag[..., :valid_frames]
    spec = torch.complex(real.float(), imag.float())
    wav = torch.istft(spec, n_fft, hop_length=hop, win_length=n_fft,
                      window=_window(n_fft, real.device), center=True)
    return torch.nn.functional.pad(wav, (0, hop * (T - 1) - wav.shape[-1]))


def stft_center(y: torch.Tensor, n_fft: int, hop: int):
    """(B, L) -> (real, imag), each (B, F, T): STFT with center=True reflect
    padding."""
    spec = torch.stft(y.float(), n_fft, hop_length=hop, win_length=n_fft,
                      window=_window(n_fft, y.device), center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.real, spec.imag
