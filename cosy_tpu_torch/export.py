"""Model export tools (the port of the JAX package's ``export.py``): the
estimator as an ONNX graph for the reference's serving stack
(cosyvoice/bin/export_onnx.py), the estimator's program as a
``torch.export`` artifact, and checkpoint averaging
(cosyvoice/bin/average_model.py).

``export_program`` stands where JAX's ``export_stablehlo`` does: it traces a
function with ``torch.export`` and round-trips the saved ``.pt2`` program.
A ``.pt2`` program cannot hold the ctypes launches of kernels A, B1 and B2,
so ``export_flow_estimator`` traces the estimator's plain path on the CPU:
the artifact carries the estimator's math and weights, as the StableHLO
program does.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import EstimatorConfig, ModelConfig
from .params import P, Params, load_torch_checkpoint, resolve_device, save_torch_checkpoint

ESTIMATOR_PREFIX = "decoder.estimator."
ONNX_TOLERANCE = 5e-3  # max |graph - estimator| of the export's own check (JAX's bound)


class _Program(torch.nn.Module):
    """A plain function as the module ``torch.export`` traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn: Callable, example_args: Sequence[torch.Tensor], path: str) -> str:
    """Trace ``fn`` (a module or a function of tensors) at ``example_args``
    with ``torch.export``, save the program to ``path`` and check that the
    program loaded back from it gives ``fn``'s result (1e-5, as JAX's
    StableHLO round trip).  Returns ``path``."""
    module = fn if isinstance(fn, torch.nn.Module) else _Program(fn)
    args = tuple(example_args)
    with torch.no_grad():
        program = torch.export.export(module, args)
        torch.export.save(program, path)
        got = torch.export.load(path).module()(*args)
        want = module(*args)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=1e-5, atol=1e-5)
    return path


def _estimator_tree(params) -> Dict[str, torch.Tensor]:
    """The estimator's weights of a flow tree (``decoder.estimator.``
    stripped), or the whole tree when it is a bare estimator (a distilled
    student's export)."""
    est = {k[len(ESTIMATOR_PREFIX):]: v for k, v in params.items()
           if k.startswith(ESTIMATOR_PREFIX)}
    return est or dict(params)


class _Estimator(torch.nn.Module):
    """The estimator forward at ``EVAL`` over weights it holds as buffers,
    with the reference's export inputs (x, mask, mu, t, spks, cond)."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: EstimatorConfig):
        super().__init__()
        self.cfg = cfg
        self.names = sorted(weights)
        for i, k in enumerate(self.names):
            self.register_buffer(f"w{i}", weights[k])

    def forward(self, x, mask, mu, t, spks, cond):
        from .layers.unet import conditional_decoder

        p = P({k: getattr(self, f"w{i}") for i, k in enumerate(self.names)})
        return conditional_decoder(p, self.cfg, x, mask, mu, t, spks, cond)


def export_flow_estimator(params, model_cfg: ModelConfig, out_path: str, B: int = 2,
                          T: int = 256) -> str:
    """The CFM estimator's forward as a ``torch.export`` program, its plain
    path traced on the CPU at (B, T), the weights inside; checked on
    seeded inputs after a round trip through ``out_path``."""
    cfg = model_cfg.flow.estimator
    est = {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
           for k, v in _estimator_tree(params).items()}
    g = torch.Generator().manual_seed(0)
    n = cfg.out_channels
    args = (torch.randn(B, n, T, generator=g), torch.ones(B, 1, T),
            torch.randn(B, n, T, generator=g), torch.rand(B, generator=g),
            torch.randn(B, n, generator=g), torch.randn(B, n, T, generator=g))
    return export_program(_Estimator(est, cfg), args, out_path)


def average_checkpoints(paths: List[str], out_path: Optional[str] = None) -> Params:
    """The mean of N torch-format checkpoints, summed in f64 and returned
    as f32 CPU tensors (cosyvoice/bin/average_model.py); written to
    ``out_path`` when given."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc: Dict[str, torch.Tensor] = {}
    for path in paths:
        for k, v in load_torch_checkpoint(path).items():
            v = v.to(torch.float64)
            acc[k] = acc[k] + v if k in acc else v
    avg = {k: (v / len(paths)).to(torch.float32) for k, v in acc.items()}
    if out_path:
        save_torch_checkpoint(avg, out_path)
        print(f"averaged {len(paths)} checkpoints -> {out_path}")
    return avg


def find_checkpoints(pattern: str, num: int = 5) -> List[str]:
    """The ``num`` newest files matching ``pattern``, newest first
    (average_model.py --num)."""
    return sorted(glob.glob(pattern), key=os.path.getmtime, reverse=True)[:num]


def _onnx_feeds(cfg: EstimatorConfig, B: int, T: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded inputs of the estimator graph (all frames valid), the JAX
    package's draws."""
    rng = np.random.default_rng(seed)
    mel = cfg.out_channels
    return {"x": rng.standard_normal((B, mel, T)).astype(np.float32),
            "mask": np.ones((B, 1, T), np.float32),
            "mu": rng.standard_normal((B, mel, T)).astype(np.float32),
            "t": np.linspace(0.1, 0.9, B).astype(np.float32),
            "spks": rng.standard_normal((B, mel)).astype(np.float32),
            "cond": rng.standard_normal((B, mel, T)).astype(np.float32)}


def verify_estimator_onnx(data: bytes, est: Dict[str, torch.Tensor], cfg: EstimatorConfig,
                          B: int, T: int, device) -> float:
    """max |graph - estimator| on :func:`_onnx_feeds`: the graph run by the
    port's executor (``compat.onnx``) and the port's ``conditional_decoder``
    at ``EVAL`` (kernels A, B1 and B2 on a card), both on ``device``."""
    from .compat.onnx import OnnxModel
    from .layers.unet import conditional_decoder

    feeds = _onnx_feeds(cfg, B, T)
    p = P({k: v.to(device, torch.float32) for k, v in est.items()})
    args = [torch.from_numpy(feeds[k]).to(device)
            for k in ("x", "mask", "mu", "t", "spks", "cond")]
    with torch.inference_mode():
        want = conditional_decoder(p, cfg, *args)
        got = OnnxModel(data, device).run(feeds)[0]
    return float((got.float() - want.float()).abs().max().item())


def export_flow_estimator_onnx(params, model_cfg: ModelConfig, out_path: str, B: int = 2,
                               T: int = 256, verify: bool = True) -> str:
    """The CFM estimator as an ONNX graph (compat/onnx_export.py), static
    shapes (B, T): one file a serving bucket.  ``verify`` holds the written
    graph to the estimator (:func:`verify_estimator_onnx`, within 5e-3) on
    the device of tensor weights (CPU tensors ask for the CPU), or on CUDA
    for numpy weights."""
    from .compat.onnx_export import export_estimator_onnx

    cfg = model_cfg.flow.estimator
    est = _estimator_tree(params)
    device = next((v.device for v in est.values() if isinstance(v, torch.Tensor)), None)
    est = {k: torch.as_tensor(v).detach() for k, v in est.items()}
    data = export_estimator_onnx({k: v.cpu().numpy() for k, v in est.items()}, cfg, T=T, B=B)
    with open(out_path, "wb") as f:
        f.write(data)
    if verify:
        err = verify_estimator_onnx(data, est, cfg, B, T, resolve_device(device))
        if err > ONNX_TOLERANCE:
            raise RuntimeError(f"ONNX export check failed: max |graph - estimator| {err:.3e} "
                               f"> {ONNX_TOLERANCE}")
    return out_path
