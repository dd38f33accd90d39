"""The port's length-masked (bucket-padded) stages of the final streaming
chunk, each against the JAX package's counterpart on the same padded
inputs (JAX's own z and sine-source draws injected) and against the port's
own unpadded run on the valid frames, as tests/test_bucket_masking.py:41-153
holds the JAX package.  Tolerance 2e-4 (1e-5 for the interpolation)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.models import flow as JF, hift as JH
from cosy_tpu.params import P as JP
from cosy_tpu_torch.models import flow as TF, hift as TH
from test_torch_common import assert_close, port_config, port_init, t, torch_params
from test_torch_hift import _jax_draws

TOL = dict(atol=2e-4, rtol=2e-4)
UP = 256  # tiny HiFT: 8 x 8 upsampling x hop 4


@pytest.fixture(scope="module")
def flow():
    jcfg = j_tiny().flow
    params = port_init(TF.init_flow_params, jcfg, seed=1)
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, torch_params(params)


@pytest.fixture(scope="module")
def hift():
    jcfg = j_tiny().hift
    params = port_init(TH.init_hift_params, jcfg, seed=2)
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, torch_params(params)


@pytest.mark.parametrize("v,ov", [(7, 12), (20, 34), (40, 69), (64, 110)])
def test_interpolate_linear_valid(v, ov):
    x = np.random.default_rng(v).standard_normal((1, 5, 64)).astype(np.float32)
    want = JF.interpolate_linear_valid(jnp.asarray(x), 128, jnp.asarray(v), jnp.asarray(ov))
    got = TF.interpolate_linear_valid(t(x), 128, v, ov)
    assert_close(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    assert_close(got[..., :ov], TF.interpolate_linear(t(x)[..., :v], ov), atol=1e-5, rtol=1e-5)
    assert torch.all(got[..., ov:] == 0)


@pytest.mark.parametrize("v", [12, 41, 64, 96])
def test_length_regulator_inference_valid(flow, v):
    """Under and over the 40 tokens where the 3-segment split starts."""
    jcfg, jp, tp = flow
    x2 = np.random.default_rng(v).standard_normal((1, 128, 80)).astype(np.float32)
    mel_v, mel_b = int(v / 50 * 22050 / 256), int(128 / 50 * 22050 / 256)
    want = jax.jit(lambda p, x: JF.length_regulator_inference_valid(
        JP(p).sub("length_regulator"), x, jnp.asarray(v), mel_b, jnp.asarray(mel_v),
        jcfg.regulator_stages, 50))(jp, jnp.asarray(x2))
    reg = tp.sub("length_regulator")
    got = TF.length_regulator_inference_valid(reg, t(x2), v, mel_b, mel_v,
                                              jcfg.regulator_stages, 50)
    assert_close(got, np.asarray(want), **TOL)
    unpadded = TF.length_regulator_inference(reg, t(x2)[:, :0], t(x2)[:, :v], 0, mel_v,
                                             jcfg.regulator_stages, 50)
    assert_close(got[:, :mel_v], unpadded, **TOL)
    assert torch.all(got[:, mel_v:] == 0)


@pytest.mark.parametrize("v", [30, 33, 57])
def test_flow_inference_bucketed(flow, v):
    """A bucket of 64 tokens (110 mel frames) with v real ones: against
    JAX's flow_inference(token_valid, mel_valid) with its z, and against
    the port's unpadded solve given the same z on the valid frames.  The
    unpadded solve of an odd mel length (v = 30: 51 frames) pads one frame
    and takes the estimator's GroupNorm statistics over it, in the JAX
    package as in the port, so only even lengths (33: 56, 57: 98) are the
    same computation there."""
    jcfg, jp, tp = flow
    cfg = port_config(jcfg)
    rng = np.random.default_rng(v)
    tok = np.zeros((1, 64), np.int32)
    tok[:, :v] = rng.integers(0, jcfg.vocab_size, (1, v))
    spk = rng.standard_normal((1, 192)).astype(np.float32)
    mel_v = int(v / 50 * 22050 / 256)
    key = jax.random.PRNGKey(v)
    want = jax.jit(lambda p, k, tk, s: JF.flow_inference(
        JP(p), jcfg, k, tk, jnp.zeros((1, 0), jnp.int32), jnp.zeros((1, 0, 80)), s,
        n_timesteps=4, finetuned_norm=True, token_valid=jnp.asarray(v),
        mel_valid=jnp.asarray(mel_v)))(jp, key, jnp.asarray(tok), jnp.asarray(spk))
    z = np.asarray(jax.random.normal(key, (1, 80, 110)))
    empty = (torch.zeros((1, 0), dtype=torch.long), torch.zeros((1, 0, 80)))
    got = TF.flow_inference(tp, cfg, t(tok, torch.long), *empty, t(spk), n_timesteps=4,
                            finetuned_norm=True, z=t(z), token_valid=v, mel_valid=mel_v)
    assert_close(got, np.asarray(want), **TOL)
    assert torch.all(got[:, :, mel_v:] == 0)
    if mel_v % 2:
        return
    unpadded = TF.flow_inference(tp, cfg, t(tok[:, :v], torch.long), *empty, t(spk),
                                 n_timesteps=4, finetuned_norm=True, z=t(z[:, :, :mel_v]))
    assert_close(got[:, :, :mel_v], unpadded, **TOL)


@pytest.mark.parametrize("v", [10, 17])
def test_f0_predict_masked(hift, v):
    jcfg, jp, tp = hift
    mel = np.random.default_rng(v).standard_normal((1, 80, 24)).astype(np.float32)
    mel[:, :, v:] = 0.0
    p = tp.sub("f0_predictor")
    want = JH.f0_predict(JP(jp).sub("f0_predictor"), jnp.asarray(mel), mel_valid=jnp.asarray(v))
    got = TH.f0_predict(p, t(mel), mel_valid=v)
    assert_close(got, np.asarray(want), **TOL)
    assert_close(got[:, :v], TH.f0_predict(p, t(mel[:, :, :v])), **TOL)


def _padded_source(s_u, Lv, L, pad):
    """An unpadded source zero-padded to L with the STFT's reflect pad
    written at the true boundary (what hift_inference(mel_valid) builds)."""
    s = np.zeros((1, 1, L), np.float32)
    s[:, :, :Lv] = s_u
    s[:, :, Lv:Lv + pad] = s_u[:, :, Lv - pad - 1:Lv - 1][:, :, ::-1]
    return s


@pytest.mark.parametrize("v", [9, 16])
def test_hift_decode_masked(hift, v):
    jcfg, jp, tp = hift
    cfg = port_config(jcfg)
    Tb = 24
    rng = np.random.default_rng(v)
    mel = rng.standard_normal((1, 80, Tb)).astype(np.float32)
    mel[:, :, v:] = 0.0
    Lv = v * UP
    s_u = (0.1 * rng.standard_normal((1, 1, Lv))).astype(np.float32)
    s = _padded_source(s_u, Lv, Tb * UP, jcfg.istft_n_fft // 2)
    want = jax.jit(lambda p, m, s_: JH.hift_decode(JP(p), jcfg, m, s_, mel_valid=jnp.asarray(v)))(
        jp, jnp.asarray(mel), jnp.asarray(s))
    got = TH.hift_decode(tp, cfg, t(mel), t(s), mel_valid=v)
    assert_close(got[:, :Lv], np.asarray(want)[:, :Lv], **TOL)
    assert_close(got[:, :Lv], TH.hift_decode(tp, cfg, t(mel[:, :, :v]), t(s_u)), **TOL)


@pytest.mark.parametrize("v", [9, 16, 24])
def test_hift_inference_masked(hift, v):
    """JAX's phase and noise drawn at the full source length and injected;
    v = 24 fills the buffer (the STFT's own reflect pad applies).  The
    port's unpadded run gets the valid head of the same noise."""
    jcfg, jp, tp = hift
    cfg = port_config(jcfg)
    Tb = 24
    mel = np.random.default_rng(v).standard_normal((1, 80, Tb)).astype(np.float32)
    mel[:, :, v:] = 0.0
    key = jax.random.PRNGKey(v)
    want_wav, want_s = jax.jit(lambda p, k, m: JH.hift_inference(
        JP(p), jcfg, k, m, mel_valid=jnp.asarray(v)))(jp, key, jnp.asarray(mel))
    phase, noise = _jax_draws(key, 1, jcfg.nb_harmonics + 1, Tb * UP)
    wav, s = TH.hift_inference(tp, cfg, t(mel), phase=phase, noise=noise, mel_valid=v)
    Lv = v * UP
    assert_close(s, np.asarray(want_s), **TOL, name="source")
    assert_close(wav[:, :Lv], np.asarray(want_wav)[:, :Lv], **TOL, name="wav")
    wav_u, s_u = TH.hift_inference(tp, cfg, t(mel[:, :, :v]), phase=phase,
                                   noise=noise[:, :, :Lv])
    assert_close(s[:, :, :Lv], s_u, **TOL, name="unpadded source")
    assert_close(wav[:, :Lv], wav_u, **TOL, name="unpadded wav")
