"""HiFi-GAN training in the port against the JAX package on the CPU: the
weight-normed ``conv2d``, the period and resolution discriminators and
``multiple_discriminator`` (narrow discriminators: the same graph with few
channels), every GAN loss (adversarial, feature match, TPR with its even
median, multi-mel), ``hift_forward_train`` on JAX's sine draws, both turns'
losses (``hifigan_generator_loss`` / ``_discriminator_loss``) on JAX's
draws, one ``HiFiGanTrainer`` turn (each optimizer's update is the clipped
AdamW step of its turn's autograd gradient at optax's defaults) and its
checkpoint round trip, the discriminator's init names and shapes at full
width, and the pitch trackers: the port's numpy tracker equal to JAX's, its
native build within tests/test_f0.py's rule of it.  JAX's own turn is not
run: its compile takes ~40 s on a CPU, why the JAX package marks its GAN
turn tests slow.  Tolerances: 2e-5 for plain functions, 2e-4 for
modules."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.layers.basic import conv2d as j_conv2d
from cosy_tpu.models import gan as JG
from cosy_tpu.ops import f0 as JF0
from cosy_tpu.params import P as JP
from cosy_tpu_torch.layers.basic import conv2d
from cosy_tpu_torch.models import gan as TG
from cosy_tpu_torch.models.hift import init_hift_params
from cosy_tpu_torch.ops import f0 as TF0
from cosy_tpu_torch.params import P as TP, from_numpy
from cosy_tpu_torch.train.gan_trainer import HiFiGanTrainer
from test_torch_common import assert_close, port_config, t
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)
JCFG = j_tiny().hift
TCFG = port_config(JCFG)
N = 2048  # samples: above the widest STFT's half window (MRD n_fft 2048)


@pytest.fixture(scope="module")
def nets():
    """Narrow discriminators and the tiny generator as flat numpy dicts."""
    disc = {k: v.numpy() for k, v in TG.init_discriminator_params(
        "cpu", seed=1, channels=4, mpd_channels=(1, 4, 8, 8, 8, 8)).items()}
    gen = {k: v.numpy() for k, v in init_hift_params(TCFG, "cpu", seed=2).state_dict().items()}
    return disc, gen


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _wavs(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((0.3 * rng.standard_normal((B, N))).astype(np.float32) for _ in range(2))


def test_weight_normed_conv2d_matches_jax():
    rng = np.random.default_rng(3)
    p = {"c.weight_v": rng.standard_normal((5, 2, 3, 9)).astype(np.float32),
         "c.weight_g": rng.uniform(0.5, 2, (5, 1, 1, 1)).astype(np.float32),
         "c.bias": rng.standard_normal(5).astype(np.float32)}
    x = rng.standard_normal((2, 2, 7, 20)).astype(np.float32)
    want = j_conv2d(JP(_jnp(p)), "c", jnp.asarray(x), stride=(1, 2), padding=(1, 4))
    got = conv2d(TP(from_numpy(p, "cpu")), "c", t(x), stride=(1, 2), padding=(1, 4))
    assert_close(got, want, atol=2e-5, rtol=2e-5)


def _losses(lib, rs, gs, fr, fg, y, y_hat):
    return (lib.generator_adv_loss(gs), lib.discriminator_adv_loss(rs, gs),
            lib.feature_match_loss(fr, fg), lib.tpr_loss(rs, gs, 0.04), lib.tpr_loss(gs, rs, 5.0),
            lib.multi_mel_loss(y, y_hat))


def test_discriminators_and_losses_match_jax(nets):
    disc, _ = nets
    y, y_hat = _wavs()

    def j_fn(p, a, b):
        out = JG.multiple_discriminator(JP(p), a, b)
        return out, _losses(JG, *out, a, b)

    want, want_losses = jax.jit(j_fn)(_jnp(disc), jnp.asarray(y), jnp.asarray(y_hat))
    got = TG.multiple_discriminator(TP(from_numpy(disc, "cpu")), t(y), t(y_hat))
    assert len(got[0]) == len(want[0]) == 8
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            if isinstance(w, list):
                for gi, wi in zip(g, w):
                    assert_close(gi, wi, **TOL)
            else:
                assert_close(g, w, **TOL)
    for g, w in zip(_losses(TG, *got, t(y), t(y_hat)), want_losses):
        assert_close(g, w, **TOL)
    # the median of an even count is the mean of the two middle values:
    # d = [0, 1, 3, 10], median 2, below it (0 - 2)^2 and (1 - 2)^2
    d = [t(np.asarray([[0.0, 1.0, 3.0, 10.0]]))]
    assert_close(TG.tpr_loss(d, [torch.zeros(1, 4)], 100.0), 2.5, atol=1e-6, rtol=0)


def test_hift_forward_train_with_jax_draws(nets):
    _, gen = nets
    rng = np.random.default_rng(4)
    mel = (rng.standard_normal((2, 80, 8)) * 2 - 6).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want_wav, want_f0 = jax.jit(lambda p, m: JG.hift_forward_train(JP(p), JCFG, key, m))(
        _jnp(gen), jnp.asarray(mel))
    k_phase, k_noise = jax.random.split(key)
    H, L = JCFG.nb_harmonics + 1, 8 * 256
    phase = np.asarray(jax.random.uniform(k_phase, (2, H, 1), minval=-jnp.pi, maxval=jnp.pi))
    noise = np.asarray(jax.random.normal(k_noise, (2, H, L)))
    wav, f0 = TG.hift_forward_train(TP(from_numpy(gen, "cpu")), TCFG, t(mel), None, t(phase),
                                    t(noise))
    assert_close(f0, want_f0, **TOL)
    assert_close(wav, want_wav, **TOL)


def _gan_batch(seed=6, B=1, T=8):
    rng = np.random.default_rng(seed)
    return {"speech": rng.uniform(-0.5, 0.5, (B, T * 256)).astype(np.float32),
            "speech_feat": (rng.standard_normal((B, T, 80)) * 2 - 6).astype(np.float32),
            "pitch_feat": rng.uniform(100, 200, (B, T)).astype(np.float32)}


def _draws(key, B=1, T=8):
    """JAX's sine draws (phase, noise) of ``hift_forward_train(key)``."""
    k_phase, k_noise = jax.random.split(key)
    H = JCFG.nb_harmonics + 1
    return (t(np.asarray(jax.random.uniform(k_phase, (B, H, 1), minval=-jnp.pi,
                                            maxval=jnp.pi))),
            t(np.asarray(jax.random.normal(k_noise, (B, H, T * 256)))))


def test_turn_losses_match_jax(nets):
    """Both turns' losses at the same weights on JAX's draws."""
    disc, gen = nets
    batch = _gan_batch()
    key = jax.random.PRNGKey(7)
    want_g, want_d = jax.jit(lambda g, d, b: (
        JG.hifigan_generator_loss(g, d, JCFG, key, b),
        JG.hifigan_discriminator_loss(g, d, JCFG, key, b)))(_jnp(gen), _jnp(disc), _jnp(batch))
    tb = {k: t(v) for k, v in batch.items()}
    got_g = TG.hifigan_generator_loss(from_numpy(gen, "cpu"), from_numpy(disc, "cpu"), TCFG, tb,
                                      source_draws=_draws(key))
    got_d = TG.hifigan_discriminator_loss(from_numpy(gen, "cpu"), from_numpy(disc, "cpu"), TCFG,
                                          tb, source_draws=_draws(key))
    for got, want in ((got_g, want_g), (got_d, want_d)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_close(got[k], want[k], **TOL, name=k)


def _adamw_first_step(p, g, lr, clip):
    """optax's clip_by_global_norm then adamw (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4) from zero moments, on a dict of leaves."""
    norm = torch.sqrt(sum(torch.sum(v ** 2) for v in g.values()))
    f = clip / torch.clamp(norm, min=clip)
    return {k: p[k] - lr * ((g[k] * f) / (torch.abs(g[k] * f) + 1e-8) + 1e-4 * p[k]) for k in p}


def test_one_gan_turn(nets, tmp_path):
    """One discriminator turn, then one generator turn on the updated
    discriminators: the metrics are the turns' losses, and each update is
    the clipped AdamW step of the turn's autograd gradient; a checkpoint
    round trip restores both networks and optimizers."""
    disc, gen = nets
    batch = _gan_batch()
    tb = {k: t(v) for k, v in batch.items()}
    d_draws, g_draws = _draws(jax.random.PRNGKey(8)), _draws(jax.random.PRNGKey(9))
    tt = HiFiGanTrainer(TCFG, from_numpy(gen, "cpu"), from_numpy(disc, "cpu"), grad_clip=0.5)
    m = tt.step(batch, source_draws=(d_draws, g_draws))
    d0 = {k: v.clone().requires_grad_(True) for k, v in from_numpy(disc, "cpu").items()}
    ld = TG.hifigan_discriminator_loss(from_numpy(gen, "cpu"), d0, TCFG, tb, source_draws=d_draws)
    ld["loss"].backward()
    d1 = _adamw_first_step({k: v.detach() for k, v in d0.items()},
                           {k: v.grad for k, v in d0.items()}, 2e-4, 0.5)
    for k in ld:
        np.testing.assert_allclose(m[f"disc/{k}"], float(ld[k]), rtol=1e-5, atol=1e-6)
    for k, v in d1.items():
        assert_close(tt.disc_params[k], v.numpy(), atol=1e-6, rtol=1e-5, name=k)
    g0 = {k: v.clone().requires_grad_(True) for k, v in from_numpy(gen, "cpu").items()}
    lg = TG.hifigan_generator_loss(g0, d1, TCFG, tb, source_draws=g_draws)
    lg["loss"].backward()
    g1 = _adamw_first_step({k: v.detach() for k, v in g0.items()},
                           {k: v.grad for k, v in g0.items()}, 2e-4, 0.5)
    for k in lg:
        np.testing.assert_allclose(m[f"gen/{k}"], float(lg[k]), rtol=1e-5, atol=1e-6)
    for k, v in g1.items():
        assert_close(tt.gen_params[k], v.numpy(), atol=1e-6, rtol=1e-5, name=k)
    tt.save_checkpoint(str(tmp_path), step=1)
    tt.close()  # the asynchronous write on disk
    back = HiFiGanTrainer(TCFG, from_numpy(gen, "cpu"), from_numpy(disc, "cpu"))
    assert back.load_checkpoint(str(tmp_path)) == 1
    for mine, theirs in ((back.gen_params, tt.gen_params), (back.disc_params, tt.disc_params)):
        assert all(torch.equal(mine[k], v) for k, v in theirs.items())
    assert back.gen_opt.state_dict()["state"].keys() == tt.gen_opt.state_dict()["state"].keys()


def test_discriminator_init_names_and_shapes_equal_jax():
    want = jax.eval_shape(JG.init_discriminator_params, jax.random.PRNGKey(0))
    got = TG.init_discriminator_params("cpu", seed=0)
    assert sorted(got) == sorted(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    k = "mpd.discriminators.0.convs.0"
    norm = torch.sqrt(torch.sum(got[k + ".weight_v"] ** 2, dim=(1, 2, 3), keepdim=True))
    assert torch.allclose(got[k + ".weight_g"], norm)


def _harmonic(f0_hz, n_sec=1.0, sr=22050):
    n = int(n_sec * sr)
    f = np.broadcast_to(np.asarray(f0_hz, np.float64), (n,))
    phase = 2 * np.pi * np.cumsum(f) / sr
    x = sum((0.7 ** k) * np.sin((k + 1) * phase) for k in range(6))
    return (x / np.max(np.abs(x))).astype(np.float32)


def test_pitch_trackers_match_jax():
    """The numpy trackers are equal; the native build agrees with them by
    tests/test_f0.py's rule (voicing on 99% of frames, 99% of voiced
    frames within 3%, median relative error below 1e-6)."""
    rng = np.random.default_rng(7)
    wav = np.concatenate([_harmonic(np.linspace(100, 300, 2 * 22050), 2.0)
                          + 0.01 * rng.standard_normal(2 * 22050).astype(np.float32),
                          (0.1 * rng.standard_normal(22050)).astype(np.float32),
                          np.zeros(22050, np.float32)])
    ref = JF0._extract_f0_numpy(wav)
    np.testing.assert_array_equal(TF0.extract_f0(wav, native=False), ref)
    got = TF0.extract_f0(wav)
    assert got.shape == ref.shape
    assert ((got > 0) == (ref > 0)).mean() > 0.99
    both = (got > 0) & (ref > 0)
    rel = np.abs(got[both] - ref[both]) / ref[both]
    assert np.median(rel) < 1e-6 and (rel < 0.03).mean() > 0.99
    gap = np.asarray([0, 0, 100, 0, 0, 120, 0, 0], np.float32)
    np.testing.assert_array_equal(TF0.interpolate_f0(gap), JF0.interpolate_f0(gap))
