"""The port's monotonic alignment search against the JAX package's on
tests/test_mas.py's cases: the numpy DP against brute force and JAX's, the
native kernel (g++ at first use) against the numpy DP and JAX's batched
call, and the torch entry point; paths equal exactly."""

import numpy as np
import pytest
import torch

from cosy_tpu.ops.mas import _maximum_path_numpy as j_numpy, maximum_path as j_maximum_path
from cosy_tpu_torch.ops.mas import _maximum_path_numpy, maximum_path, maximum_path_torch
from test_mas import brute_force_best_path
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)


@pytest.mark.parametrize("t_x,t_y", [(3, 5), (4, 4), (2, 7), (5, 6)])
def test_numpy_dp_matches_brute_force_and_jax(t_x, t_y):
    value = np.random.default_rng(t_x * 10 + t_y).standard_normal((t_x, t_y)).astype(np.float32)
    got = _maximum_path_numpy(value.copy(), t_x, t_y)
    np.testing.assert_array_equal(got, brute_force_best_path(value.copy()))
    np.testing.assert_array_equal(got, j_numpy(value.copy(), t_x, t_y))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((4, 6, 9)).astype(np.float32)
    return value, np.array([6, 4, 3, 5], np.int32), np.array([9, 7, 5, 9], np.int32)


def test_native_matches_numpy_and_jax():
    value, t_xs, t_ys = _batch()
    got = maximum_path(value, t_xs, t_ys)
    np.testing.assert_array_equal(got, maximum_path(value, t_xs, t_ys, native=False))
    np.testing.assert_array_equal(got, j_maximum_path(value, t_xs, t_ys))
    for b in range(4):  # each valid column selects exactly one x
        assert (got[b, :, :t_ys[b]].sum(axis=0) == 1).all()
        assert not got[b, t_xs[b]:].any() and not got[b, :, t_ys[b]:].any()


def test_torch_entry_point_and_bad_lengths():
    value, t_xs, t_ys = _batch(1)
    got = maximum_path_torch(torch.from_numpy(value), torch.from_numpy(t_xs),
                             torch.from_numpy(t_ys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), j_maximum_path(value, t_xs, t_ys))
    with pytest.raises(ValueError, match="do not fit"):
        maximum_path(value, np.array([7, 1, 1, 1]), t_ys)
