"""The port's export tools against the JAX package's: the estimator's ONNX
bytes equal JAX's for the same numpy weights (tests/test_onnx_export.py's
configurations), the graph run by the port's executor within 2e-4 of JAX's
``conditional_decoder`` (its tolerance), the refusal of a T the levels do
not divide, ``export_flow_estimator_onnx``'s own check on a tiny model,
checkpoint averaging and selection equal to JAX's, and ``export_program``'s
``torch.export`` round trip of the tiny estimator (1e-5)."""

import os

import jax
import numpy as np
import pytest
import torch

from cosy_tpu import export as JX
from cosy_tpu.compat.onnx_export import export_estimator_onnx as j_export_estimator_onnx
from cosy_tpu.config import EstimatorConfig as JEst
from cosy_tpu.ctx import EVAL
from cosy_tpu.layers.unet import conditional_decoder as j_conditional_decoder
from cosy_tpu.params import P as JP
from cosy_tpu_torch import export as X
from cosy_tpu_torch.compat.onnx import OnnxModel
from cosy_tpu_torch.compat.onnx_export import export_estimator_onnx
from cosy_tpu_torch.config import tiny_model_config
from cosy_tpu_torch.layers.unet import conditional_decoder, init_conditional_decoder
from cosy_tpu_torch.models.flow import init_flow_params
from cosy_tpu_torch.params import P, Spec, save_torch_checkpoint, spec_tensors
from test_torch_common import port_config
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

CFG = JEst(in_channels=32, out_channels=8, channels=(16, 16), attention_head_dim=4,
           n_blocks=1, num_mid_blocks=1, num_heads=2)
DEEP = JEst(in_channels=32, out_channels=8, channels=(16, 16), attention_head_dim=4,
            n_blocks=2, num_mid_blocks=2, num_heads=2, gelu_approximate=False)
CASES = {"tanh": (CFG, 16, 0), "erf_depth": (DEEP, 32, 3)}


def _weights(jcfg, seed):
    spec = Spec()
    init_conditional_decoder(spec, "", port_config(jcfg))
    return {k: v.numpy() for k, v in
            spec_tensors(spec, "cpu", torch.Generator().manual_seed(seed)).items()}


def _feeds(cfg, B, T, seed=1, ragged=False):
    rng = np.random.default_rng(seed)
    mel = cfg.out_channels
    mask = np.ones((B, 1, T), np.float32)
    if ragged:
        mask[1, :, T - 6:] = 0.0
    return {"x": rng.standard_normal((B, mel, T)).astype(np.float32), "mask": mask,
            "mu": rng.standard_normal((B, mel, T)).astype(np.float32),
            "t": np.linspace(0.15, 0.85, B).astype(np.float32),
            "spks": rng.standard_normal((B, mel)).astype(np.float32),
            "cond": rng.standard_normal((B, mel, T)).astype(np.float32)}


@pytest.mark.parametrize("case", list(CASES))
def test_onnx_bytes_equal_jax(case):
    jcfg, T, seed = CASES[case]
    w = _weights(jcfg, seed)
    for B in (1, 2):
        got = export_estimator_onnx(w, port_config(jcfg), T=T, B=B)
        assert got == j_export_estimator_onnx(w, jcfg, T=T, B=B)


@pytest.mark.parametrize("case, ragged", [("tanh", False), ("tanh", True),
                                          ("erf_depth", False)])
def test_onnx_graph_matches_jax_estimator(case, ragged):
    jcfg, T, seed = CASES[case]
    w = _weights(jcfg, seed)
    B = 2
    data = export_estimator_onnx(w, port_config(jcfg), T=T, B=B)
    feeds = _feeds(jcfg, B, T, seed=seed + 1, ragged=ragged)
    got = OnnxModel(data, "cpu").run(feeds)[0].numpy()
    want = np.asarray(jax.jit(lambda p, f: j_conditional_decoder(
        JP(p), jcfg, f["x"], f["mask"], f["mu"], f["t"], f["spks"], f["cond"], EVAL))(w, feeds))
    assert got.shape == want.shape == (B, jcfg.out_channels, T)
    if ragged:  # the final mask multiply zeroes the pad frames
        assert np.abs(got[1, :, T - 6:]).max() == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_onnx_export_refuses_a_bad_T():
    with pytest.raises(ValueError, match="multiple"):
        export_estimator_onnx(_weights(CFG, 0), port_config(CFG), T=15, B=1)


@pytest.fixture(scope="module")
def tiny_flow():
    mc = tiny_model_config(n_mels=8)
    return mc, init_flow_params(mc.flow, "cpu", seed=0)


def test_export_flow_estimator_onnx_checks_itself(tmp_path, tiny_flow, monkeypatch):
    mc, flow = tiny_flow
    path = str(tmp_path / "estimator.onnx")
    seen = []
    real = X.verify_estimator_onnx
    monkeypatch.setattr(X, "verify_estimator_onnx",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    assert X.export_flow_estimator_onnx(dict(flow.named_parameters()), mc, path, B=1,
                                        T=16) == path
    assert os.path.getsize(path) > 1000 and len(seen) == 1 and seen[0] <= 5e-3
    # a bare estimator tree exports the same graph
    est = {k[len("decoder.estimator."):]: v for k, v in flow.named_parameters()
           if k.startswith("decoder.estimator.")}
    bare = str(tmp_path / "bare.onnx")
    X.export_flow_estimator_onnx(est, mc, bare, B=1, T=16, verify=False)
    with open(path, "rb") as a, open(bare, "rb") as b:
        assert a.read() == b.read()


def test_average_checkpoints_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(3):
        flat = {"a.weight": rng.standard_normal((4, 3)).astype(np.float32) * (i + 1),
                "b.bias": rng.standard_normal(5).astype(np.float32) + 1e4}
        paths.append(str(tmp_path / f"epoch_{i}.pt"))
        save_torch_checkpoint(flat, paths[-1])
    out = str(tmp_path / "avg.pt")
    got = X.average_checkpoints(paths, out)
    want = JX.average_checkpoints(paths)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = torch.load(out, weights_only=True)
    assert all(torch.equal(back[k], got[k]) for k in got)
    with pytest.raises(ValueError):
        X.average_checkpoints([])


def test_find_checkpoints_by_mtime(tmp_path):
    for i, age in enumerate((30, 10, 20, 40)):
        p = tmp_path / f"epoch_{i}.pt"
        p.write_bytes(b"x")
        os.utime(p, (1e9 - age, 1e9 - age))
    pattern = str(tmp_path / "epoch_*.pt")
    got = X.find_checkpoints(pattern, num=3)
    assert got == JX.find_checkpoints(pattern, num=3)
    assert [os.path.basename(p) for p in got] == ["epoch_1.pt", "epoch_2.pt", "epoch_0.pt"]


def test_export_program_round_trips_the_tiny_estimator(tmp_path, tiny_flow):
    mc, flow = tiny_flow
    path = str(tmp_path / "estimator.pt2")
    assert X.export_flow_estimator(dict(flow.named_parameters()), mc, path, B=2, T=16) == path
    program = torch.export.load(path)
    assert os.path.getsize(path) > 1000
    # the program holds the weights: it runs on the inputs alone
    g = torch.Generator().manual_seed(9)
    args = (torch.randn(2, 8, 16, generator=g), torch.ones(2, 1, 16),
            torch.randn(2, 8, 16, generator=g), torch.rand(2, generator=g),
            torch.randn(2, 8, generator=g), torch.randn(2, 8, 16, generator=g))
    with torch.no_grad():
        got = program.module()(*args)
        want = conditional_decoder(P(dict(flow.named_parameters())).sub("decoder.estimator"),
                                   mc.flow.estimator, *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
