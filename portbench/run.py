"""Run one cell of ``BENCHMARK.json`` once on the CUDA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, weights from the seed, the
kernels' build or load, the warm-up of the cell's own shapes) counts as
``setup_s``; then the cell's driver measures for ``--seconds``.  With
``--trace 1`` a sub-window is profiled, with the harness's spans around
the calls the cell's per-layer metrics name, and the line carries those
metrics, the device's busy and window seconds and the ``breakdown``;
otherwise its end-to-end metrics.  After the window the
program is freed and the frozen reference checks a sample of what the
window produced (``correct``).  The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of that object.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cosy_tpu")


def environment():
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths (the port builds its nvcc libraries under ``build/``
    beside its package by itself), and one host thread for PyTorch's and
    the math libraries' CPU pools, so that a run's load is one process
    with few threads (the engine's loop and the harness's consumer beside
    the main one).  Set before torch is imported."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"


def metric_module(path: Path):
    """A metric's file as a module: ``read(record)``, and ``SPANS`` and
    ``CAPTURE`` where it reads spans."""
    sp = importlib.util.spec_from_file_location(f"portbench.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e30


def sample(cell, seed: int, seconds: float, device, t0: float, tracer=None):
    """The sequence every reading of a cell goes through, the benchmark's
    runs, the limits' readings and the control's test alike: the program
    built from the seed and warmed, ``seconds`` of the cell's traffic
    measured (none at 0: a training cell's readings come from its
    set-up's steps), the reference's samples taken, the program freed.

    Returns the window's record (None at 0 s; else with ``setup_s`` from
    ``t0``, the memory peak read before the samples and the type the work
    computes in), the samples, and the mix's inference-config fields."""
    import torch

    from . import system
    from .reference import check
    from .trace import Tracer

    cuda = device.type == "cuda"
    check.set_tf32(False)  # the configurations state float32 with TF32 off
    drivers = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    inference = drivers.Driver.inference(cell)
    build = getattr(drivers.Driver, "build", system.build)
    drv = drivers.Driver(cell, build(cell.config, seed, device, inference), seed,
                         system.plain_config(cell.config))
    drv.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rec = None
    if seconds > 0:
        rec = drv.measure(seconds, tracer or Tracer(False))
        if cuda:
            torch.cuda.synchronize()
        bad = forbidden_modules()
        if bad:
            raise Isolation(f"the run loaded {bad}")
        rec.setup_s = setup_s
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        rec.dtype = getattr(drivers.Driver, "dtype", _config_dtype)(cell)
    samples = drv.samples(seed)
    drv.close()
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec, samples, inference


def _config_dtype(cell) -> str:
    return cell.config.get("dtype", "float32")


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of ``cell`` on ``device``: set-up from ``t0`` (the process's
    start), the window, the reference's check; returns the result line's
    object, its ``compared`` key last."""
    import torch

    from . import spans, spec, system
    from .reference import check
    from .trace import Tracer

    cuda = device.type == "cuda"
    metric_mods = {m["name"]: metric_module(cell.metric_file(m["name"]))
                   for m in (cell.per_layer if trace else cell.end_to_end)}
    tracer = Tracer(trace, spans.collect(metric_mods.values()))
    rec, samples, inference = sample(cell, seed, seconds, device, t0, tracer)
    tracer.reduce()
    rec.profile = tracer.profile
    rec.spans = tracer.spans if trace else None
    rec.plain = system.plain_config(cell.config)
    rec.peaks = spec.load_json(HERE / "yardstick" / "peaks.json")
    if trace:
        print(f"portbench: traced sub-window {rec.profile.window_s if rec.profile else 0:.3f} s "
              f"delivered {rec.traced_audio_s:.3f} s of audio, {rec.traced_steps} steps; "
              f"reduced in {tracer.reduce_s:.1f} s", file=sys.stderr)
    if rec.segments:
        ttfa = sorted(rec.ttfa_s)
        p90 = ttfa[min(len(ttfa) - 1, int(0.9 * len(ttfa)))] if ttfa else float("nan")
        print(f"portbench: window {rec.window_s:.3f} s, {rec.segments} segments, engine "
              f"pending {rec.pending[0]} at its open and {rec.pending[1]} at its close; "
              f"{len(ttfa)} first chunks in it, time to first audio p90 {1e3 * p90:.1f} ms",
              file=sys.stderr)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_mods[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    numbers = check.numbers(cell.traffic["driver"])(
        cell.config, seed, inference, samples, device, control=False) if samples else {}
    correct, compared = check.compare(numbers, cell.limits())
    for c in compared.values():
        c["value"] = _finite(c["value"])
    print(f"portbench: reference check of {len(samples)} samples in "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": cell.chips, "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device_info}
    if trace and rec.profile is not None:
        device_info["busy_s"] = rec.profile.busy_s
        device_info["window_s"] = rec.profile.window_s
        out["breakdown"] = {"device_ops": rec.profile.top_ops(10),
                            "idle_gaps": rec.profile.idle_by_host(10)}
    out["compared"] = compared
    return out


class Isolation(RuntimeError):
    """The run's process loaded JAX or the JAX package."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()

    import torch

    torch.set_num_threads(1)

    from . import spec

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"portbench: {cell.name} seed {args.seed} on {torch.cuda.get_device_name(0)} "
          f"({power_limit()})", file=sys.stderr, flush=True)
    try:
        out = run_cell(cell, args.seed, args.seconds, args.trace == 1, device, _T0)
    except Isolation as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for k, c in out["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
