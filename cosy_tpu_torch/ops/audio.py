"""STFT / iSTFT of the HiFT head (n_fft 16, hop 4, periodic Hann window,
centered), the port of ``istft`` and ``stft_center`` in the JAX package's
``ops/audio.py``.  Plain ``torch.stft`` / ``torch.istft``: the JAX package's
matmul-rFFT was a TPU workaround, and no kernel of its own computes these."""

from __future__ import annotations

from typing import Optional

import torch


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
