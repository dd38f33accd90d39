"""Mel-cepstral distortion (MCD), an output-quality metric (the port's copy
of the JAX package's ``ops/mcd.py``; host numpy).

``quant.validate_int8_voice`` compares an int8 decode's audio with the
full-precision decode's by it.  Standard definition:
MCD = (10 / ln 10) * sqrt(2 * sum_{k=1..K} (c_k - c'_k)^2) averaged over
aligned frames, with mel-cepstra obtained from log-mel spectra by DCT-II.
Computed host-side in numpy (an eval metric, not a training op).
"""

from __future__ import annotations

import numpy as np

_LOG10_FACTOR = 10.0 / np.log(10.0)


def mel_to_cepstra(log_mel: np.ndarray, n_cep: int = 13) -> np.ndarray:
    """(T, n_mels) natural-log mel spectra -> (T, n_cep) cepstra (DCT-II,
    ortho), dropping c0 (overall energy) by convention."""
    x = np.asarray(log_mel, np.float64)
    T, M = x.shape
    n = np.arange(M)
    basis = np.cos(np.pi * np.outer(np.arange(n_cep + 1), (2 * n + 1) / (2.0 * M)))
    scale = np.sqrt(2.0 / M) * np.ones((n_cep + 1, 1))
    scale[0] = np.sqrt(1.0 / M)
    cep = x @ (basis * scale).T  # (T, n_cep+1)
    return cep[:, 1:]  # drop c0


def _align_dtw(a: np.ndarray, b: np.ndarray) -> tuple:
    """Plain DTW alignment path between (Ta, K) and (Tb, K) cepstra."""
    Ta, Tb = len(a), len(b)
    dist = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    acc = np.full((Ta + 1, Tb + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, Ta + 1):
        j0, j1 = 1, Tb + 1
        for j in range(j0, j1):
            acc[i, j] = dist[i - 1, j - 1] + min(
                acc[i - 1, j], acc[i, j - 1], acc[i - 1, j - 1])
    # backtrack
    path = []
    i, j = Ta, Tb
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        moves = [(acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1)]
        _, i, j = min(moves)
    path.reverse()
    ia = np.asarray([p[0] for p in path])
    ib = np.asarray([p[1] for p in path])
    return ia, ib


def mcd(
    log_mel_a: np.ndarray,  # (Ta, n_mels) natural-log mel (the framework's)
    log_mel_b: np.ndarray,  # (Tb, n_mels) reference
    n_cep: int = 13,
    align: bool = True,
) -> float:
    """MCD in dB.  ``align=True`` DTW-aligns the two sequences (lengths from
    two synthesis stacks rarely match exactly); False truncates to the
    shorter length and compares frame-by-frame."""
    ca = mel_to_cepstra(log_mel_a, n_cep)
    cb = mel_to_cepstra(log_mel_b, n_cep)
    if align:
        ia, ib = _align_dtw(ca, cb)
        ca, cb = ca[ia], cb[ib]
    else:
        n = min(len(ca), len(cb))
        ca, cb = ca[:n], cb[:n]
    d = np.sqrt(2.0 * ((ca - cb) ** 2).sum(-1))
    return float(_LOG10_FACTOR * d.mean())
