"""F0 (pitch) extraction, a host op for the HiFi-GAN training targets (the
port's copy of the JAX package's ``ops/f0.py``).

Reference behavior: cosyvoice/dataset/processor.py compute_f0 (pyworld at
the mel frame period, interpolated to the mel length).  The tracker is a
normalized autocorrelation with the same contract: (T_mel,) Hz, 0 on
unvoiced frames.  ``extract_f0`` runs the native C++ kernel
(``native/f0.cpp``, OpenMP over frames), built at first use; a failed build
raises.  The numpy tracker runs only when the caller asks for it
(``native=False``): it is the tests' oracle.
"""

from __future__ import annotations

import numpy as np


def extract_f0(wav: np.ndarray, sr: int = 22050, hop: int = 256, fmin: float = 60.0,
               fmax: float = 500.0, threshold: float = 0.3, native: bool = True) -> np.ndarray:
    """(n_frames,) f0 in Hz of a (T,) waveform, n_frames = ceil(T / hop)."""
    if not native:
        return extract_f0_numpy(wav, sr, hop, fmin, fmax, threshold)
    from ..native import f0_library

    x = np.ascontiguousarray(wav, np.float32)
    out = np.zeros(int(np.ceil(len(x) / hop)), np.float32)
    f0_library().cosy_extract_f0(x.ctypes.data, len(x), int(sr), int(hop), float(fmin),
                                 float(fmax), float(threshold), out.ctypes.data, len(out))
    return out


def extract_f0_numpy(wav: np.ndarray, sr: int = 22050, hop: int = 256, fmin: float = 60.0,
                     fmax: float = 500.0, threshold: float = 0.3) -> np.ndarray:
    n_frames = int(np.ceil(len(wav) / hop))
    win = int(sr / fmin * 2)  # two periods of the lowest pitch
    pad = win // 2
    x = np.pad(wav.astype(np.float64), (pad, pad))
    lag_min = int(sr / fmax)
    lag_max = int(sr / fmin)

    f0 = np.zeros(n_frames, np.float32)
    for i in range(n_frames):
        c = i * hop + pad
        frame = x[c - pad: c - pad + win]
        frame = frame - frame.mean()
        energy = float(frame[: win - lag_max] @ frame[: win - lag_max])
        if energy < 1e-8:
            continue
        # normalized autocorrelation over the lag range via FFT
        n_fft = 1 << int(np.ceil(np.log2(2 * win)))
        spec = np.fft.rfft(frame, n_fft)
        ac = np.fft.irfft(spec * np.conj(spec))[: lag_max + 1]
        if ac[0] <= 0:
            continue
        acn = ac / ac[0]
        k = int(np.argmax(acn[lag_min: lag_max + 1])) + lag_min
        if acn[k] < threshold:
            continue
        # parabolic interpolation around the peak
        if 0 < k < lag_max:
            a, b, c2 = acn[k - 1], acn[k], acn[k + 1]
            denom = a - 2 * b + c2
            shift = 0.5 * (a - c2) / denom if abs(denom) > 1e-12 else 0.0
            k = k + float(np.clip(shift, -1, 1))
        f0[i] = sr / k
    return f0


def interpolate_f0(f0: np.ndarray) -> np.ndarray:
    """Linearly fill unvoiced gaps (processor.py compute_f0 interpolation)."""
    voiced = f0 > 0
    if not voiced.any():
        return f0
    idx = np.arange(len(f0))
    return np.interp(idx, idx[voiced], f0[voiced]).astype(np.float32)
