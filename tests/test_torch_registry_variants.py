"""The registry's positional encodings and conv subsamplings of the port
against the torch-recorded goldens ``pos_encodings`` and ``subsampling``
(tests/test_registry_variants.py's tolerances: 2e-4, subsampling 5e-4,
masks exactly equal) and against the JAX package's functions (2e-5, jitted)
on seeded inputs with a ragged mask; ``init_conv_subsampling``'s names and
shapes against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosy_tpu.layers import posenc as JPE
from cosy_tpu.layers import subsampling as JSS
from cosy_tpu.params import KeyGen, P as JP
from cosy_tpu_torch.layers import posenc as PE
from cosy_tpu_torch.layers import subsampling as SS
from cosy_tpu_torch.params import Spec, spec_tensors
from test_torch_common import GOLDEN_DIR, assert_close, t, torch_params
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

KINDS = list(SS.SUBSAMPLE_RATES)


def _golden(name):
    blob = np.load(f"{GOLDEN_DIR}/{name}.npz")
    return {k: blob[k] for k in blob.files}


def _kind_params(g, kind):
    pre = "param:" + kind + "."
    return {k[len(pre):]: v.astype(np.float32) for k, v in g.items() if k.startswith(pre)}


def test_pos_encoding_family_matches_golden():
    g = _golden("pos_encodings")
    x = t(g["in:x"])
    lp = t(g["in:learnable_pe"])
    cases = {
        "abs": (PE.abs_pos_encoding(x), "abs_y", "abs_pos"),
        "whisper": (PE.whisper_pos_encoding(x), "whisper_y", "whisper_pos"),
        "learnable": (PE.learnable_pos_encoding(lp, x), "learnable_y", "learnable_pos"),
        "nope": (PE.no_pos_encoding(x), "nope_y", "nope_pos"),
    }
    for name, ((y, pos), ykey, pkey) in cases.items():
        assert_close(y, g["out:" + ykey], 2e-4, 2e-4, name)
        assert_close(pos, g["out:" + pkey], 2e-4, 2e-4, name + "_pos")
    off = {"abs": PE.abs_pos_encoding(x[:, :5], offset=3),
           "whisper": PE.whisper_pos_encoding(x[:, :5], offset=3),
           "learnable": PE.learnable_pos_encoding(lp, x[:, :5], offset=3),
           "nope": PE.no_pos_encoding(x[:, :5], offset=3)}
    for name, (y, _) in off.items():
        assert_close(y, g[f"out:{name}_y_off3"], 2e-4, 2e-4, name + "_off3")
    assert torch.count_nonzero(PE.no_pos_encoding(x)[1]) == 0


@pytest.mark.parametrize("kind", KINDS)
def test_conv_subsampling_matches_golden(kind):
    g = _golden("subsampling")
    fn = SS.SUBSAMPLE_RATES[kind][0]
    y, m = fn(torch_params(_kind_params(g, kind)), t(g["in:x"]), torch.from_numpy(g["in:mask"]))
    assert_close(y, g[f"out:{kind}_y"], 5e-4, 5e-4, kind)
    np.testing.assert_array_equal(m.numpy(), g[f"out:{kind}_mask"], err_msg=kind + "_mask")


@pytest.mark.parametrize("which", ["abs", "abs_offset_no_xscale", "whisper", "learnable",
                                   "none", "tables"])
def test_pos_encodings_match_jax(which):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, 24)).astype(np.float32)
    pe = rng.standard_normal((1, 40, 24)).astype(np.float32)
    if which == "tables":
        for jfn, tfn in ((JPE.sinusoid_table, PE.sinusoid_table),
                         (JPE.whisper_pos_table, PE.whisper_pos_table)):
            want = jax.jit(jfn, static_argnums=(0, 1))(37, 24)
            assert_close(tfn(37, 24), want, 2e-5, 2e-5, jfn.__name__)
        return
    jx = {"abs": lambda x: JPE.abs_pos_encoding(x),
          "abs_offset_no_xscale": lambda x: JPE.abs_pos_encoding(x, offset=4, apply_xscale=False),
          "whisper": lambda x: JPE.whisper_pos_encoding(x, offset=2),
          "learnable": lambda x: JPE.learnable_pos_encoding(jnp.asarray(pe), x, offset=5),
          "none": lambda x: JPE.no_pos_encoding(x)}[which]
    tx = {"abs": lambda x: PE.abs_pos_encoding(x),
          "abs_offset_no_xscale": lambda x: PE.abs_pos_encoding(x, offset=4, apply_xscale=False),
          "whisper": lambda x: PE.whisper_pos_encoding(x, offset=2),
          "learnable": lambda x: PE.learnable_pos_encoding(t(pe), x, offset=5),
          "none": lambda x: PE.no_pos_encoding(x)}[which]
    want_y, want_pos = jax.jit(jx)(x)
    y, pos = tx(t(x))
    assert_close(y, want_y, 2e-5, 2e-5, which)
    assert_close(pos, want_pos, 2e-5, 2e-5, which + "_pos")
    assert pos.shape == tuple(want_pos.shape)


def _port_weights(kind, idim, odim, seed):
    spec = SS.init_conv_subsampling(Spec(), "", kind, idim, odim)
    return {k: v.numpy() for k, v in
            spec_tensors(spec, "cpu", torch.Generator().manual_seed(seed)).items()}


@pytest.mark.parametrize("kind", KINDS)
def test_conv_subsampling_matches_jax(kind):
    """Seeded weights of the port's init, 80 mel bins, a ragged mask."""
    idim, odim, T = 80, 20, 45
    w = _port_weights(kind, idim, odim, seed=KINDS.index(kind))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, T, idim)).astype(np.float32)
    mask = np.ones((2, 1, T), bool)
    mask[1, :, 31:] = False
    jfn, tfn = JSS.SUBSAMPLE_RATES[kind][0], SS.SUBSAMPLE_RATES[kind][0]
    want_y, want_m = jax.jit(lambda p, x, m: jfn(JP(p), x, m))(w, x, mask)
    y, m = tfn(torch_params(w), t(x), torch.from_numpy(mask))
    assert_close(y, want_y, 2e-5, 2e-5, kind)
    np.testing.assert_array_equal(m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("kind", KINDS)
def test_init_conv_subsampling_equals_jax(kind):
    def jax_init(key):
        params = {}
        JSS.init_conv_subsampling(KeyGen(key), params, "front.", kind, idim=80, odim=32)
        return params

    want = jax.eval_shape(jax_init, jax.random.PRNGKey(0))
    spec = SS.init_conv_subsampling(Spec(), "front", kind, idim=80, odim=32)
    assert {k: s for k, (s, _) in spec.entries.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    with pytest.raises(ValueError):
        SS.init_conv_subsampling(Spec(), "", "conv3d", 80, 32)
