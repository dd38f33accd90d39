"""The port's ``layers.conformer.moe_ffn`` (positionwise_feed_forward.py:
58-115) against the JAX package's: the dense per-expert loop and the
stacked ``experts_stacked`` path on the same seeded weights (top-1 and
top-2 routing, a gate with and without a bias), the stacked path equal to
the loop, and gradients equal to ``jax.grad``.  Tolerance 1e-5 (f32, JAX's
own in tests/test_moe.py).  Expert parallelism over two ranks is held to
the replicated layer in tests/test_torch_parallel.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.ctx import EVAL as JEVAL
from cosy_tpu.layers.conformer import moe_ffn as j_moe
from cosy_tpu.params import P as JP
from cosy_tpu.parallel.tp import stack_experts as j_stack
from cosy_tpu_torch.layers.basic import ACT
from cosy_tpu_torch.layers.conformer import moe_ffn
from cosy_tpu_torch.params import P
from cosy_tpu_torch.parallel.tp import stack_experts
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

D, H, E = 8, 16, 4


def _params(gate_bias: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    p = {"moe.gate.weight": rng.standard_normal((E, D)).astype(np.float32)}
    if gate_bias:
        p["moe.gate.bias"] = rng.standard_normal(E).astype(np.float32)
    for i in range(E):
        p[f"moe.experts.{i}.w_1.weight"] = (rng.standard_normal((H, D)) * 0.3).astype(np.float32)
        p[f"moe.experts.{i}.w_1.bias"] = (rng.standard_normal(H) * 0.1).astype(np.float32)
        p[f"moe.experts.{i}.w_2.weight"] = (rng.standard_normal((D, H)) * 0.3).astype(np.float32)
        p[f"moe.experts.{i}.w_2.bias"] = (rng.standard_normal(D) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("k, stacked, gate_bias", [
    (1, False, False), (2, False, True), (1, True, True), (2, True, False)],
    ids=["top1-loop", "top2-loop-gate_bias", "top1-stacked-gate_bias", "top2-stacked"])
def test_moe_ffn_matches_jax(k, stacked, gate_bias):
    p, x = _params(gate_bias)
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in p.items()}
    if stacked:
        jp, tp = j_stack(jp, E), stack_experts(tp, E)
        assert sorted(jp) == sorted(tp)
    tp = {n: v.requires_grad_(True) for n, v in tp.items()}
    w = np.sin(np.arange(x.size, dtype=np.float32)).reshape(x.shape)

    def j_loss(params, xi):
        return jnp.sum(j_moe(JP(params), "moe", xi, E, k, jax.nn.relu, 0.0, JEVAL) * w)

    want, (gp, gx) = jax.jit(lambda p_, x_: (
        j_moe(JP(p_), "moe", x_, E, k, jax.nn.relu, 0.0, JEVAL),
        jax.grad(j_loss, argnums=(0, 1))(p_, x_)))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    got = moe_ffn(P(tp), "moe", xt, E, k, ACT["relu"])
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5, rtol=1e-5)
    for n, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(gp[n]), atol=1e-5, rtol=1e-5,
                                   err_msg=n)


def test_stacked_experts_equal_the_loop():
    p, x = _params(True, seed=3)
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    loop = moe_ffn(P(tp), "moe", torch.from_numpy(x), E, 2, ACT["relu"])
    st = moe_ffn(P(stack_experts(tp, E)), "moe", torch.from_numpy(x), E, 2, ACT["relu"])
    np.testing.assert_allclose(st.numpy(), loop.numpy(), atol=1e-5, rtol=1e-5)
    assert stack_experts(tp, E)["moe.experts_stacked.w_1.weight"].shape == (E, H, D)
