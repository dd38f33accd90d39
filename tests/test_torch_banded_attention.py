"""The port's banded attention (kernel C's plain version on CPU tensors)
against the JAX package's Pallas banded kernel in interpret mode, on the
cases of tests/test_banded_attention.py; the estimator with a window against
JAX; the window's gates (an odd mel length, training); the wrapper's
refusals.  Tolerance 2e-5 (f32, kernel plain version; on the rows
t < k_valid[b] where k_valid is short, the others have no admissible key),
2e-4 for the whole estimator."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.ctx import EVAL as J_EVAL
from cosy_tpu.layers.unet import conditional_decoder as j_decoder
from cosy_tpu.ops import flash_attention as jfa
from cosy_tpu.params import P as JP
from cosy_tpu_torch import ops as tops
from cosy_tpu_torch.ctx import Ctx
from cosy_tpu_torch.layers import attention as tattn
from cosy_tpu_torch.layers.unet import conditional_decoder as t_decoder
from cosy_tpu_torch.models import flow as TF
from cosy_tpu_torch.ops import flash_attention as tfa
from test_torch_common import assert_close, port_config, port_init, t, torch_params
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-5, rtol=2e-5)
MODULE_TOL = dict(atol=2e-4, rtol=2e-4)


def _qkv(B, H, T, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, d)).astype(np.float32) for _ in range(3)]


# (B, H, T, d, window, scale, k_valid): the aligned case, the ragged T with
# short k_valid, and a window covering T, of tests/test_banded_attention.py;
# then a window of 0 and a k_valid that leaves rows with no admissible key
CASES = {
    "aligned": (2, 3, 384, 64, 96, 0.125, None),
    "ragged_k_valid": (2, 2, 300, 8, 64, 0.3, [300, 217]),
    "window_covers_T": (1, 2, 96, 16, 96, 0.25, None),
    "window_0": (1, 2, 40, 8, 0, 0.3, None),
    "rows_without_keys": (2, 2, 150, 8, 16, 0.3, [150, 40]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_pallas_interpret(case):
    B, H, T, d, window, scale, kv = CASES[case]
    q, k, v = _qkv(B, H, T, d, seed=sorted(CASES).index(case))
    k_valid = None if kv is None else np.asarray(kv, np.int32)
    want = np.asarray(jfa.banded_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, window,
        k_valid=None if kv is None else jnp.asarray(k_valid), interpret=True))
    got = tfa.banded_attention(t(q), t(k), t(v), scale, window,
                               None if kv is None else t(k_valid, torch.int32))
    assert got.shape == want.shape and torch.isfinite(got).all()
    for b in range(B):
        n = T if kv is None else kv[b]
        assert_close(got[b, :, :n], want[b, :, :n], **TOL, name=f"{case} b={b}")


def test_window_covering_T_equals_full_attention():
    q, k, v = (t(a) for a in _qkv(1, 2, 96, 16, seed=2))
    full = tfa.flash_attention(q, k, v, None, 0.25)
    assert_close(tfa.banded_attention(q, k, v, 0.25, 96), full, atol=1e-6, rtol=1e-6)
    assert_close(tfa.banded_attention(q, k, v, 0.25, 10 ** 6), full, atol=1e-6, rtol=1e-6)


def test_out_view_and_strided_inputs():
    """q/k/v as strided views of one QKV product, the way the estimator
    hands them over; the result is a tensor of its own."""
    rng = np.random.default_rng(5)
    B, T, H, d = 2, 50, 2, 8
    qkv = t(rng.standard_normal((B, T, 3, H, d)).astype(np.float32))
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    res = tfa.banded_attention(q, k, v, 0.3, 7)
    want = tfa.banded_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), 0.3, 7)
    assert res.shape == q.shape and res.data_ptr() != qkv.data_ptr()
    assert_close(res, want, atol=0, rtol=0)
    with pytest.raises(TypeError):
        tfa.banded_attention(q, k, v, 0.3, 7, out=torch.empty(q.shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("T,window", [(1279, 128), (2558, 256), (150, 4096)])
def test_launch_passes_every_argument_of_the_c_entry_point(monkeypatch, T, window, dtype):
    """``_launch_banded`` hands ``cosy_banded_attention`` exactly the
    arguments its ctypes signature names: the window clamped to T and the
    plan (kv_splits) of ``_attention_plan`` for that window.  No kernel runs here: the entry point is a stand-in."""
    from cosy_tpu_torch.ops import _cuda

    seen = []
    monkeypatch.setattr(_cuda, "function", lambda name: lambda *a: seen.append((name, a)) or 0)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda x: 0)
    monkeypatch.setattr(tfa.banded_attention, "launches", 0)
    q = torch.zeros((2, 8, T, 64), dtype=dtype)
    out = torch.empty_like(q)
    tfa._launch_banded(q, q, q, 0.125, window, None, out)
    (name, args), = seen
    assert name == "cosy_banded_attention" and tfa.banded_attention.launches == 1
    assert len(args) == len(_cuda.SIGNATURES[name][1])
    assert args[6:10] == (2, 8, T, 64) and args[12] == min(window, T)
    assert args[13] == tfa._attention_plan(16, T, T, min(window, T), dtype)


@pytest.fixture(scope="module")
def tiny_flow():
    jcfg = j_tiny().flow
    jcfg = dataclasses.replace(
        jcfg, estimator=dataclasses.replace(jcfg.estimator, attn_window=8))
    params = port_init(TF.init_flow_params, jcfg)
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, torch_params(params)


def _estimator_inputs(seed, B, T, n_mels=80):
    rng = np.random.default_rng(seed)
    x, mu, cond = (rng.standard_normal((B, n_mels, T)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((B, n_mels)).astype(np.float32)
    tt = rng.uniform(size=(B,)).astype(np.float32)
    return x, mu, tt, spks, cond


def _count_banded(monkeypatch):
    calls = []
    real = tfa.banded_attention

    def counting(q, k, v, scale, window, *a, **kw):
        calls.append((q.shape[2], window))
        return real(q, k, v, scale, window, *a, **kw)

    monkeypatch.setattr(tattn, "banded_attention", counting)
    return calls


def test_estimator_with_window_matches_jax(tiny_flow, monkeypatch):
    """Window 8 at T = 48, 4 at the T/2 level: every block goes through
    banded_attention, and the output equals the JAX estimator's (a band
    bias on its CPU path)."""
    jcfg, jp, tp = tiny_flow
    calls = _count_banded(monkeypatch)
    x, mu, tt, spks, cond = _estimator_inputs(3, 2, 48)
    want = jax.jit(lambda p, *a: j_decoder(
        JP(p).sub("decoder.estimator"), jcfg.estimator, a[0], None, *a[1:], J_EVAL))(
            jp, *(jnp.asarray(a) for a in (x, mu, tt, spks, cond)))
    got = t_decoder(tp.sub("decoder.estimator"), port_config(jcfg).estimator,
                    t(x), None, t(mu), t(tt), t(spks), t(cond))
    assert_close(got, np.asarray(want), **MODULE_TOL)
    est = jcfg.estimator
    n_blocks = est.n_blocks * (2 * len(est.channels) + est.num_mid_blocks)
    assert len(calls) == n_blocks and set(calls) == {(48, 8), (24, 4)}


def test_odd_mel_length_drops_the_window(tiny_flow, monkeypatch):
    """An odd mel length is padded and masked; a level with a mask has a
    bias, and a level with a bias keeps full attention: no banded call, and
    the mel equals the one of the same model without a window."""
    jcfg, _, tp = tiny_flow
    calls = _count_banded(monkeypatch)
    cfg_w = port_config(jcfg)
    cfg_full = dataclasses.replace(
        cfg_w, estimator=dataclasses.replace(cfg_w.estimator, attn_window=None))
    rng = np.random.default_rng(4)
    spk = t(rng.standard_normal((1, 192)).astype(np.float32))
    empty_tok, empty_feat = torch.zeros((1, 0), dtype=torch.long), torch.zeros((1, 0, 80))

    def run(cfg, n_tok):
        tok = torch.from_numpy(np.random.default_rng(6).integers(0, 128, (1, n_tok)))
        T = int(n_tok / 50 * 22050 / 256)
        z = t(np.random.default_rng(7).standard_normal((1, 80, T + T % 2)).astype(np.float32))
        with torch.inference_mode():
            return TF.flow_inference(tp, cfg, tok, empty_tok, empty_feat, spk,
                                     n_timesteps=2, z=z), T

    mel_w, T = run(cfg_w, 19)  # 32.7 -> 32 frames: even, the window engages
    assert T % 2 == 0 and len(calls) > 0
    calls.clear()
    mel_w, T = run(cfg_w, 18)  # 31 frames: odd, padded to 32 with a mask
    mel_full, _ = run(cfg_full, 18)
    assert T % 2 == 1 and calls == []
    assert_close(mel_w, mel_full, atol=0, rtol=0)


def test_training_drops_the_window(tiny_flow, monkeypatch):
    jcfg, _, tp = tiny_flow
    calls = _count_banded(monkeypatch)
    cfg_w = port_config(jcfg).estimator
    x, mu, tt, spks, cond = (t(a) for a in _estimator_inputs(8, 2, 32))
    args = (x, None, mu, tt, spks, cond)
    est = tp.sub("decoder.estimator")
    out_w = t_decoder(est, cfg_w, *args, Ctx(torch.Generator().manual_seed(0), train=True))
    out_f = t_decoder(est, dataclasses.replace(cfg_w, attn_window=None), *args,
                      Ctx(torch.Generator().manual_seed(0), train=True))
    assert calls == []
    assert_close(out_w, out_f, atol=0, rtol=0)


def test_wrapper_refusals_and_launch_count():
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="self-attention"):
        tfa.banded_attention(q, torch.zeros((1, 2, 9, 64)), torch.zeros((1, 2, 9, 64)), 1.0, 2)
    with pytest.raises(ValueError, match="window"):
        tfa.banded_attention(q, q, q, 1.0, -1)
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.banded_attention(qg, q, q, 1.0, 2)
    with torch.no_grad():  # nothing is recorded: the wrapper takes it
        assert tfa.banded_attention(qg, q, q, 1.0, 2).shape == q.shape
    m = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.banded_attention(m, m, m, 1.0, 2)
    # what the CUDA branch checks before a launch: fp16 and a head dim != 64
    h = torch.zeros((1, 2, 8, 64), dtype=torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        tfa.check_kernel_args(h, h, h, None, None)
    d32 = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="head dim 64"):
        tfa.check_kernel_args(d32, d32, d32, None, None)
    # the CPU path launches no kernel and counts none
    assert "banded_attention" in tops.launch_counts()
    n0 = tfa.banded_attention.launches
    tfa.banded_attention(q, q, q, 1.0, 2)
    assert tfa.banded_attention.launches == n0
