"""STFT / iSTFT of the HiFT head (n_fft 16, hop 4, periodic Hann window,
centered), the port of ``istft`` and ``stft_center`` in the JAX package's
``ops/audio.py``.  Plain ``torch.stft`` / ``torch.istft``: the JAX package's
matmul-rFFT was a TPU workaround, and no kernel of its own computes these."""

from __future__ import annotations

import torch


def _window(n_fft: int, device) -> torch.Tensor:
    return torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=device)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, F, T) real/imag -> (B, hop * (T - 1)) signal: overlap-add with
    window-square normalization, centre-cropped by n_fft // 2 (torch.istft
    with center=True)."""
    spec = torch.complex(real.float(), imag.float())
    return torch.istft(spec, n_fft, hop_length=hop, win_length=n_fft,
                       window=_window(n_fft, real.device), center=True)


def stft_center(y: torch.Tensor, n_fft: int, hop: int):
    """(B, L) -> (real, imag), each (B, F, T): STFT with center=True reflect
    padding."""
    spec = torch.stft(y.float(), n_fft, hop_length=hop, win_length=n_fft,
                      window=_window(n_fft, y.device), center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.real, spec.imag
