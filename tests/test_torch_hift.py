"""The port's HiFT vocoder against the JAX package (CPU) and the
torch-recorded golden.  The sine source's random draws are JAX's own
(split(rng) -> uniform phase, normal noise), injected into the port.
Tolerance 2e-4 for whole modules; the waveform golden keeps
tests/test_hift.py's 5e-4 / 5e-3."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cosy_tpu.compat import fold_weight_norm as j_fold
from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.models import hift as JH
from cosy_tpu.params import P as JP
from cosy_tpu_torch.config import HiFTConfig
from cosy_tpu_torch.models import hift as TH
from cosy_tpu_torch.params import fold_weight_norm
from test_torch_common import assert_close, golden_np, port_config, port_init, t, torch_params
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)

GOLDEN_CFG = dict(
    in_channels=6, base_channels=16, nb_harmonics=2,
    upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    source_resblock_kernel_sizes=(3, 3), source_resblock_dilation_sizes=((1,), (1,)),
    f0_predictor_cond_channels=8)


def test_hift_decode_golden():
    params, ins, outs = golden_np("hift_decode")
    p = torch_params(params)
    folded = fold_weight_norm(dict(p.d))
    # the port's fold equals the JAX package's
    jf = j_fold({k: jnp.asarray(v) for k, v in params.items()})
    assert set(folded) == set(jf)
    for k in folded:
        assert_close(folded[k], np.asarray(jf[k]), **TOL, name=k)
    from cosy_tpu_torch.params import P

    p = P(folded)
    f0 = TH.f0_predict(p.sub("f0_predictor"), t(ins["mel"]))
    assert_close(f0, outs["f0"], **TOL, name="f0")
    wav = TH.hift_decode(p, HiFTConfig(**GOLDEN_CFG), t(ins["mel"]), t(ins["s"]))
    assert wav.shape == outs["wav"].shape
    assert_close(wav, outs["wav"], atol=5e-4, rtol=5e-3, name="wav")


@pytest.fixture(scope="module")
def tiny_hift():
    jcfg = j_tiny().hift
    params = port_init(TH.init_hift_params, jcfg, seed=3)
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, torch_params(params)


def _jax_draws(key, B, H, L):
    k_phase, k_noise = jax.random.split(key)
    phase = jax.random.uniform(k_phase, (B, H, 1), minval=-jnp.pi, maxval=jnp.pi)
    noise = jax.random.normal(k_noise, (B, H, L))
    return t(np.asarray(phase)), t(np.asarray(noise))


def test_hift_decode_matches_jax(tiny_hift):
    jcfg, jp, tp = tiny_hift
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((1, 80, 12)).astype(np.float32)
    src = (0.1 * rng.standard_normal((1, 1, 12 * 256))).astype(np.float32)
    want = jax.jit(lambda p, m, s: JH.hift_decode(JP(p), jcfg, m, s))(
        jp, jnp.asarray(mel), jnp.asarray(src))
    got = TH.hift_decode(tp, port_config(jcfg), t(mel), t(src))
    assert_close(got, np.asarray(want), **TOL)


def test_sine_source_with_jax_draws(tiny_hift):
    jcfg, jp, tp = tiny_hift
    rng = np.random.default_rng(1)
    f0 = np.where(rng.uniform(size=(2, 1, 512)) > 0.3, 180.0, 0.0).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = JH.sine_source(JP(jp).sub("m_source"), jcfg, key, jnp.asarray(f0))
    phase, noise = _jax_draws(key, 2, jcfg.nb_harmonics + 1, 512)
    got = TH.sine_source(tp.sub("m_source"), port_config(jcfg), t(f0), phase=phase, noise=noise)
    assert_close(got, np.asarray(want), **TOL)


def test_hift_inference_with_jax_draws(tiny_hift):
    jcfg, jp, tp = tiny_hift
    mel = np.random.default_rng(2).standard_normal((1, 80, 10)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want_wav, want_s = jax.jit(lambda p, k, m: JH.hift_inference(JP(p), jcfg, k, m))(
        jp, key, jnp.asarray(mel))
    phase, noise = _jax_draws(key, 1, jcfg.nb_harmonics + 1, 10 * 256)
    wav, s = TH.hift_inference(tp, port_config(jcfg), t(mel), phase=phase, noise=noise)
    assert_close(s, np.asarray(want_s), **TOL, name="source")
    assert_close(wav, np.asarray(want_wav), **TOL, name="wav")
