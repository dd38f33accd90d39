"""The port's ONNX ingestion (compat/onnx.py, onnx_export.py, replicas.py)
on the CPU against the JAX package's: the replica graph bytes identical
for the same seed, the port's executor on both replicas against the JAX
executor and the replica torch module (1e-4; S3 token ids exact), the op
set equal to JAX's ``supported_ops()``, and every hand-built graph of
tests/test_onnx_ingest.py run by both executors (1e-4; integer outputs
exact)."""

import numpy as np
import pytest
import torch

import test_onnx_ingest as ingest
from cosy_tpu.compat import onnx as JO
from cosy_tpu.compat import replicas as JR
from cosy_tpu_torch.compat import onnx as TO
from cosy_tpu_torch.compat import replicas as TR
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=1e-4, rtol=1e-4)
# small replica widths (the real graphs' op inventories at a fraction of
# their size)
CAMPPLUS = dict(fcm_ch=8, ch=32, growth=16, emb=24)
S3 = dict(d=32, heads=4, n_layers=2, n_codes=64, dv=16, max_t=128)


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _hold(got, want, what=""):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", ["campplus", "s3"])
def test_replica_bytes_are_identical(name):
    make = f"make_{name}_replica"
    kw = CAMPPLUS if name == "campplus" else S3
    assert getattr(TR, make)(seed=4, **kw)[1] == getattr(JR, make)(seed=4, **kw)[1]


def test_supported_ops_equal_jax():
    assert TO.supported_ops() == JO.supported_ops()


@pytest.mark.parametrize("T", [37, 90])
def test_campplus_replica(T):
    mod, data = TR.make_campplus_replica(seed=1, **CAMPPLUS)
    x = np.random.default_rng(T).standard_normal((1, T, 80)).astype(np.float32)
    got = TO.OnnxModel(data, "cpu").run({"x": x})[0]
    assert isinstance(got, torch.Tensor) and got.shape == (1, 24)
    with torch.no_grad():
        _hold(got, mod(torch.from_numpy(x)).numpy(), "torch module")
    _hold(got, JO.OnnxModel(data).run({"x": x})[0], "JAX executor")


@pytest.mark.parametrize("T,valid", [(64, 50), (96, 96)])
def test_s3_replica(T, valid):
    mod, data = TR.make_s3_replica(seed=2, **S3)
    rng = np.random.default_rng(T)
    feats = rng.standard_normal((1, 128, T)).astype(np.float32)
    lens = np.asarray([valid], np.int32)
    got = TO.OnnxModel(data, "cpu")(feats, lens)[0]
    assert got.dtype == torch.int64 and got.shape == (1, T // 2)
    with torch.no_grad():
        _hold(got, mod(torch.from_numpy(feats), torch.from_numpy(lens)).numpy(), "torch module")
    _hold(got, JO.OnnxModel(data).run({"feats": feats, "feats_length": lens})[0], "JAX executor")


class _Both:
    """Stands in for the JAX ``OnnxModel`` inside a test of
    tests/test_onnx_ingest.py: runs every call through the JAX executor and
    the port's on the CPU, holds the port's outputs to JAX's, and hands
    JAX's back to the test's own checks."""

    calls = 0

    def __init__(self, data):
        self.jax = JO.OnnxModel(data)
        self.port = TO.OnnxModel(data, "cpu")

    def __getattr__(self, name):
        return getattr(self.jax, name)

    def _check(self, want, got):
        assert len(want) == len(got)
        for i, (w, g) in enumerate(zip(want, got)):
            _hold(g, w, f"output {i}")
        type(self).calls += 1
        return want

    def run(self, feeds):
        return self._check(self.jax.run(feeds), self.port.run(feeds))

    def __call__(self, *args):
        return self._check(self.jax(*args), self.port(*args))


INGEST = ["conv_bn_relu_matches_torch", "grouped_conv2d_matches_torch",
          "conv_transpose_matches_torch", "grouped_conv_transpose_matches_torch",
          "pools_match_torch", "attention_block_matches_numpy",
          "shape_machinery_folds_under_jit", "vq_argmin_gather", "stats_pooling_gemm_head",
          "misc_ops", "avgpool_ceil_mode_count_include_pad_matches_torch"]


@pytest.mark.parametrize("name", INGEST)
def test_hand_built_graphs_match_jax(name, monkeypatch):
    monkeypatch.setattr(ingest, "OnnxModel", _Both)
    before = _Both.calls
    getattr(ingest, "test_" + name)()
    assert _Both.calls > before


def test_unsupported_op_raises_and_cuda_is_the_default():
    data = ingest.model([ingest.node("NonMaxSuppression", ["x"], ["y"])],
                        [ingest.vinfo("x", np.float32, (2,))], [ingest.vinfo("y")])
    with pytest.raises(NotImplementedError, match="NonMaxSuppression"):
        TO.OnnxModel(data, "cpu").run({"x": np.zeros(2, np.float32)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TO.OnnxModel(data)


def test_shape_machinery_stays_on_the_host():
    """Shape -> Gather -> Unsqueeze -> Concat -> Reshape of a device tensor:
    the shape chain is host numpy (no device value feeds a Reshape
    target), the data a tensor."""
    n = ingest.node
    data = ingest.model(
        [n("Shape", ["x"], ["shp"]), n("Gather", ["shp", "i0"], ["d0"], axis=0),
         n("Unsqueeze", ["d0", "ax0"], ["d0u"]), n("Concat", ["d0u", "negone"], ["tgt"], axis=0),
         n("Reshape", ["x", "tgt"], ["y"]), n("Range", ["zero", "d0", "one"], ["r"])],
        [ingest.vinfo("x", np.float32, (2, 3, 4))], [ingest.vinfo("y"), ingest.vinfo("r")],
        {"i0": np.array(0, np.int64), "ax0": np.array([0], np.int64),
         "negone": np.array([-1], np.int64), "zero": np.array(0, np.int64),
         "one": np.array(1, np.int64)})
    m = TO.OnnxModel(data, "cpu")
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    y, r = m.run({"x": x})
    assert isinstance(y, torch.Tensor) and y.shape == (2, 12)
    assert isinstance(r, np.ndarray) and r.tolist() == [0, 1]
