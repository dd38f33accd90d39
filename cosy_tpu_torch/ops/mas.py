"""Monotonic alignment search, a host op (the port's copy of the JAX
package's ``ops/mas.py``).

Reference: the Cython maximum_path kernel of matcha/utils/monotonic_align
(Matcha-TTS training, matcha_tts.py:153); the DP is the public Glow-TTS /
VITS recurrence.  ``maximum_path`` runs the native C++ kernel
(``native/mas.cpp``, OpenMP over the batch), built at first use; a failed
build raises.  The numpy DP runs only when the caller asks for it
(``native=False``): it is the plain version the tests hold the kernel to.
``maximum_path_torch`` takes and returns torch tensors, on the host: the DP
is sequential in T_y and branchy, and the JAX package runs it there too
(``maximum_path_jax``, a host callback).
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e9


def _maximum_path_numpy(value: np.ndarray, t_x: int, t_y: int) -> np.ndarray:
    """(t_x, t_y) log-likelihood grid -> binary path; value modified in place."""
    path = np.zeros((t_x, t_y), np.int32)
    for y in range(t_y):
        x_lo = max(0, t_x + y - t_y)
        x_hi = min(t_x - 1, y)
        for x in range(x_lo, x_hi + 1):
            v_cur = NEG_INF if x == y else value[x, y - 1]
            if x == 0:
                v_prev = 0.0 if y == 0 else NEG_INF
            else:
                v_prev = NEG_INF if y == 0 else value[x - 1, y - 1]
            value[x, y] += max(v_cur, v_prev)
    index = t_x - 1
    for y in range(t_y - 1, -1, -1):
        path[index, y] = 1
        if index != 0 and (index == y or value[index, y - 1] < value[index - 1, y - 1]):
            index -= 1
    return path


def maximum_path(value: np.ndarray, t_xs: np.ndarray, t_ys: np.ndarray,
                 native: bool = True) -> np.ndarray:
    """Batched MAS: (B, T_x, T_y) float32 log-likelihoods with (B,) valid
    text and mel lengths -> (B, T_x, T_y) int32 binary alignment paths
    (zero outside each sample's valid corner)."""
    value = np.ascontiguousarray(value, np.float32).copy()
    B, Tx, Ty = value.shape
    t_xs = np.ascontiguousarray(t_xs, np.int32)
    t_ys = np.ascontiguousarray(t_ys, np.int32)
    if t_xs.shape != (B,) or t_ys.shape != (B,) or (t_xs > Tx).any() or (t_ys > Ty).any():
        raise ValueError(f"lengths {t_xs.tolist()} / {t_ys.tolist()} do not fit a "
                         f"({B}, {Tx}, {Ty}) grid")
    path = np.zeros((B, Tx, Ty), np.int32)
    if native:
        from ..native import mas_library

        mas_library().cosy_maximum_path(value.ctypes.data, path.ctypes.data, t_xs.ctypes.data,
                                        t_ys.ctypes.data, B, Tx, Ty)
        return path
    for b in range(B):
        tx, ty = int(t_xs[b]), int(t_ys[b])
        if tx > 0 and ty > 0:
            path[b, :tx, :ty] = _maximum_path_numpy(value[b, :tx, :ty], tx, ty)
    return path


def maximum_path_torch(value: torch.Tensor, t_xs: torch.Tensor,
                       t_ys: torch.Tensor) -> torch.Tensor:
    """:func:`maximum_path` on torch tensors: the DP runs on the host and
    the (B, T_x, T_y) int32 paths come back on ``value``'s device."""
    path = maximum_path(value.detach().float().cpu().numpy(), t_xs.cpu().numpy(),
                        t_ys.cpu().numpy())
    return torch.from_numpy(path).to(value.device)
