"""The slice as a whole at tiny_model_config(): the port's prefix and
token2wav against the JAX pipeline (same text ids; same speech tokens, z and
HiFT draws), the port's synthesize() and CLI end to end on the CPU, and the
weight bridge (strict loads of JAX inits; key and shape equality at full
width through jax.eval_shape and the meta device).  Tolerance 2e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import ModelConfig as JModelConfig, tiny_model_config as j_tiny
from cosy_tpu.infer.pipeline import TTSPipeline as JPipeline
from cosy_tpu.models import flow as JF, hift as JH, llm as JL
from cosy_tpu_torch.config import ModelConfig
from cosy_tpu_torch.infer.pipeline import TTSPipeline
from cosy_tpu_torch.models.flow import Flow
from cosy_tpu_torch.models.hift import HiFT
from cosy_tpu_torch.models.llm import TransformerLM
from cosy_tpu_torch.params import from_numpy
from test_torch_common import assert_close, port_config, t
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)


def _load(cls, cfg, flat):
    m = cls(cfg, "cpu")
    m.load_state_dict(from_numpy({k: np.asarray(v) for k, v in flat.items()}, "cpu"),
                      strict=True)
    return m


@pytest.fixture(scope="module")
def slice_pair():
    jcfg = j_tiny()
    key = jax.random.PRNGKey(0)
    jl = JL.init_llm_params(jax.random.fold_in(key, 1), jcfg.llm)
    jf = JF.init_flow_params(jax.random.fold_in(key, 2), jcfg.flow)
    jh = JH.init_hift_params(jax.random.fold_in(key, 3), jcfg.hift)
    jpipe = JPipeline(jcfg, jl, jf, jh, finetuned_norm=True)
    tcfg = port_config(jcfg)
    tpipe = TTSPipeline(tcfg, _load(TransformerLM, tcfg.llm, jl), _load(Flow, tcfg.flow, jf),
                        _load(HiFT, tcfg.hift, jh), finetuned_norm=True)
    return jcfg, jpipe, tpipe


def test_prefix_matches_jax(slice_pair):
    _, jpipe, tpipe = slice_pair
    ids = np.asarray([list("hello world".encode())], np.int32)
    spk = np.zeros((1, 192), np.float32)
    want, jmin, jmax = jpipe._build_prefix(ids, None, None, spk, 2048)
    got, tmin, tmax = tpipe._build_prefix(ids, None, None, spk, 2048)
    assert (tmin, tmax) == (jmin, jmax)
    assert_close(got, np.asarray(want), **TOL)


def test_token2wav_matches_jax(slice_pair):
    """31 tokens -> 53 mel frames (odd: padded + masked), NFE 10; z and the
    HiFT phase/noise are JAX's own draws from the split key."""
    jcfg, jpipe, tpipe = slice_pair
    tok = np.random.default_rng(4).integers(0, 128, (1, 31)).astype(np.int32)
    spk = np.zeros((1, 192), np.float32)
    rng = jax.random.PRNGKey(5)
    want = jpipe._t2w_jit(jpipe.flow_params, jpipe.hift_params, rng, jnp.asarray(tok),
                          jnp.zeros((1, 0), jnp.int32), jnp.zeros((1, 0, 80)),
                          jnp.asarray(spk), None, trim=0)
    k_flow, k_hift = jax.random.split(rng)
    T = int(31 / 50 * 22050 / 256)
    z = np.asarray(jax.random.normal(k_flow, (1, 80, T + T % 2)))
    k_phase, k_noise = jax.random.split(k_hift)
    H = jcfg.hift.nb_harmonics + 1
    phase = np.asarray(jax.random.uniform(k_phase, (1, H, 1), minval=-jnp.pi, maxval=jnp.pi))
    noise = np.asarray(jax.random.normal(k_noise, (1, H, T * 256)))
    got = tpipe.token2wav(tok, spk, z=t(z), hift_phase=t(phase), hift_noise=t(noise))
    assert got.shape == (1, T * 256)
    assert_close(got, np.asarray(want), **TOL)


def test_synthesize_end_to_end_cpu(slice_pair):
    _, _, tpipe = slice_pair
    ids = np.asarray([list("hi".encode())], np.int64)
    out = next(tpipe.synthesize(ids, spk_embedding=np.zeros((1, 192), np.float32),
                                max_len_cap=30, seed=3))
    wav = out["tts_speech"]
    n_tok = len(tpipe.generate_tokens(ids, np.zeros((1, 192), np.float32), 30,
                                      generator=torch.Generator().manual_seed(3))[0])
    assert wav.shape == (1, 256 * int(n_tok / 50 * 22050 / 256))
    assert wav.dtype == np.float32 and np.isfinite(wav).all()


def test_cli_tiny_cpu(tmp_path):
    from cosy_tpu_torch.infer.__main__ import main

    out = tmp_path / "out.wav"
    main(["--text", "ab", "--tiny", "--device", "cpu", "--pretrained", str(tmp_path),
          "--output", str(out)])
    assert out.stat().st_size > 44


@pytest.mark.parametrize("part", ["llm", "flow", "hift"])
def test_full_width_key_and_shape_equality(part):
    """At the full ModelConfig() width: JAX init shapes through
    jax.eval_shape (nothing allocated) against the port's modules on the
    meta device."""
    jcfg, tcfg = JModelConfig(), ModelConfig()
    init = {"llm": JL.init_llm_params, "flow": JF.init_flow_params,
            "hift": JH.init_hift_params}[part]
    want = jax.eval_shape(lambda k: init(k, getattr(jcfg, part)), jax.random.PRNGKey(0))
    cls = {"llm": TransformerLM, "flow": Flow, "hift": HiFT}[part]
    got = cls(getattr(tcfg, part), "meta").state_dict()
    assert set(got) == set(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
