"""Shared helpers of the port's parity tests (no tests here).

Both packages get the same numbers: inputs and weights are made with numpy
(or by one package's own init) and handed to JAX as jnp arrays and to the
port as CPU torch tensors.  JAX stays on the CPU (tests/conftest.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cosy_tpu_torch import config as TC
from cosy_tpu_torch.params import P as TP, from_numpy

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for a module's tiny CPU models: many small ops,
    for which a thread pool only adds contention beside the other test
    workers; the count is restored afterwards.  Every port test module
    imports it by name, which makes it autouse there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torch_params(flat) -> TP:
    """A port ``P`` view over a flat dict of numpy / jax arrays (CPU, f32)."""
    return TP(from_numpy({k: np.asarray(v) for k, v in flat.items()}, "cpu"))


def port_init(init, jcfg, seed=0):
    """Weights made by the port's own ``init`` at ``jcfg``'s width, as a flat
    numpy dict that both packages take (the port's CPU init is much quicker
    than the JAX package's eager one; the JAX init is held to the port's in
    test_torch_pipeline)."""
    module = init(port_config(jcfg), "cpu", seed=seed)
    return {k: v.numpy() for k, v in module.state_dict().items()}


def t(x, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def port_config(jcfg):
    """The port's copy of a JAX config dataclass, with the same field values
    (fields the port's class leaves out, TrainConfig's mesh axis and PRNG
    implementation, are dropped)."""
    cls = getattr(TC, type(jcfg).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name in names}
    kw = {k: port_config(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}
    return cls(**kw)


def grad_agreement(got: dict, want: dict):
    """(cosine, max relative error) of two gradient dicts over the same
    keys, each flattened into one vector; the relative error is
    max|got - want| over max|want|."""
    assert sorted(got) == sorted(want)
    g = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in sorted(got)])
    w = np.concatenate([np.asarray(want[k], np.float64).ravel() for k in sorted(want)])
    cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
    return cos, float(np.abs(g - w).max() / np.abs(w).max())


def golden_np(name):
    """(params, ins, outs) of a golden fixture as numpy arrays (the port's
    tests read the npz directly, without building jnp arrays)."""
    blob = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    params, ins, outs = {}, {}, {}
    for k in blob.files:
        kind, key = k.split(":", 1)
        if kind == "param":
            params[key] = blob[k].astype(np.float32)
        elif kind == "in":
            ins[key] = blob[k]
        elif kind == "out":
            outs[key] = blob[k]
        else:
            raise ValueError(f"unexpected golden entry {k}")
    return params, ins, outs


def assert_close(got, want, atol, rtol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=name)


def tiny_flats(jcfg, seed=0):
    """Seeded {'llm', 'flow', 'hift'} weights at ``jcfg``'s width as flat
    numpy dicts (the port's init; both packages take them)."""
    from cosy_tpu_torch.models.flow import init_flow_params
    from cosy_tpu_torch.models.hift import init_hift_params
    from cosy_tpu_torch.models.llm import init_llm_params

    return {"llm": port_init(init_llm_params, jcfg.llm, seed),
            "flow": port_init(init_flow_params, jcfg.flow, seed + 1),
            "hift": port_init(init_hift_params, jcfg.hift, seed + 2)}


def port_modules(tcfg, flats):
    """The port's (TransformerLM, Flow, HiFT) on the CPU with ``flats``
    loaded strictly."""
    from cosy_tpu_torch.models.flow import Flow
    from cosy_tpu_torch.models.hift import HiFT
    from cosy_tpu_torch.models.llm import TransformerLM

    mods = []
    for cls, part in ((TransformerLM, "llm"), (Flow, "flow"), (HiFT, "hift")):
        m = cls(getattr(tcfg, part), "cpu")
        m.load_state_dict(from_numpy(flats[part], "cpu"), strict=True)
        mods.append(m)
    return tuple(mods)
