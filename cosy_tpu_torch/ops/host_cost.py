"""The host's cost of kernel B1's launches and of one estimator call on the card.

    python -m cosy_tpu_torch.ops.host_cost
    python3 PATH/cosy_tpu_torch/ops/host_cost.py --tree DIR

Prints one JSON line: the host microseconds of an ``ln_gemm()`` call at 312
rows in f32, cycling through 64 weight sets as an estimator call's blocks
do (the wrapper returns once its launch is queued, so this is what a launch
costs the host), three times; the same for a ``flash_attention()`` call at
the main path's T/2 level, (2,8,156,64) f32 with a (B, T, T) bias, q, k, v
the heads of a (2, 156, 3, 8, 64) product and out a (2, 156, 8, 64) view
(as the fused block hands them over: the kernel's tensor maps are encoded
in the call), 400 calls a round; B1's on-card ms at 150, 156, 312, 624 and
5116 rows in f32 and bf16 (``plan_sweep.device_ms``); and one full-width
estimator call (B = 2, T = 312, the last frame masked: ``chip_smoke.py``'s
[6]) as the wall of 30 back-to-back calls (three times), [6]'s unprofiled
wall (CUDA events over 3 calls), its device busy ms, launches and the time
of each product kernel.  ``--tree`` measures the port of another checkout
with that checkout's ``chip_smoke.py`` (the estimator's seeded weights and
inputs), such as the parent commit unpacked with ``git archive`` into the
git-ignored ``build/``; run it as a file then, so that nothing of this
checkout is imported.  To compare two commits on one card, run parent,
change, change, parent in one call.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="the root of another checkout of the port to measure")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    root = Path(args.tree).resolve() if args.tree else here.parents[1]
    # run as a file, the script's own directory leads sys.path: drop it
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("host_cost: no CUDA device")
    import chip_smoke as cs
    import cosy_tpu_torch
    from cosy_tpu_torch.ops import _cuda
    from cosy_tpu_torch.ops.fused_block import ln_gemm

    for module in (cs, cosy_tpu_torch):
        if not Path(module.__file__).resolve().is_relative_to(root):
            raise SystemExit(f"host_cost: {module.__name__} came from {module.__file__}, "
                             f"not {root}")
    _cuda.build()
    dev = cs.DEV
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": str(root)}
    for dtype in (torch.float32, torch.bfloat16):
        for M in (150, 156, 312, 624, 5116):
            x = torch.randn(M, 256, device=dev, generator=g).to(dtype)
            w = (torch.randn(256, device=dev, generator=g) * 0.05 + 1).to(dtype)
            b = (torch.randn(256, device=dev, generator=g) * 0.05).to(dtype)
            ws = [(torch.randn(512, 256, device=dev, generator=g) * 0.05).to(dtype)
                  for _ in range(3)]
            out[f"B1 on-card ms {str(dtype)[6:]} {M}"] = cs.device_ms(lambda: ln_gemm(x, w, b, ws))
    x = torch.randn(312, 256, device=dev, generator=g)
    w = torch.randn(256, device=dev, generator=g) * 0.05 + 1
    b = torch.randn(256, device=dev, generator=g) * 0.05
    sets = [[torch.randn(512, 256, device=dev, generator=g) * 0.05 for _ in range(3)]
            for _ in range(64)]
    host = []
    for _ in range(3):
        for ws in sets:
            ln_gemm(x, w, b, ws)
        torch.cuda.synchronize()
        n = 64 * 40
        t0 = time.perf_counter()
        for i in range(n):
            ln_gemm(x, w, b, sets[i % 64])
        host.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    out["ln_gemm host us a call, f32 312 rows"] = host

    from cosy_tpu_torch.ops.flash_attention import flash_attention

    qkv = torch.randn(2, 156, 3, 8, 64, device=dev, generator=g)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    bias = torch.zeros(2, 156, 156, device=dev)
    o = torch.empty(2, 156, 8, 64, device=dev).permute(0, 2, 1, 3)
    host = []
    for _ in range(3):
        for _ in range(20):
            flash_attention(q, k, v, bias, 0.125, out=o)
        torch.cuda.synchronize()
        n = 400  # fewer than the launch queue holds: the host never waits on it
        t0 = time.perf_counter()
        for _ in range(n):
            flash_attention(q, k, v, bias, 0.125, out=o)
        host.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    out["flash_attention host us a call, f32 (2,8,156,64) views + bias"] = host

    cfg = cs.ModelConfig()
    flow = cs.init_flow_params(cfg.flow, dev, seed=1)
    est = cs.P(dict(flow.named_parameters())).sub("decoder.estimator")
    ecfg = cfg.flow.estimator
    est_args = cs.estimator_args(312, True)

    def call():
        return cs.conditional_decoder(est, ecfg, *est_args)

    with torch.inference_mode():
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(30):
                call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / 30 * 1e3)
        out["estimator wall ms a call (30 back to back)"] = walls
        out["estimator [6] unprofiled wall ms"] = cs.cuda_ms(call, 3)
        _, busy, by_name = cs.profile_device(call)
    out["estimator busy ms"] = busy
    out["estimator launches"] = sum(n for n, _ in by_name.values())
    out["estimator product kernels (launches, ms)"] = {
        k[:110]: v for k, v in by_name.items()
        if "gemm" in k or "block_tail" in k or "attention" in k}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
