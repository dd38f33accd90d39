"""The readings a cell's limits are set from, on the card: for each seed, a
short window of the cell's own traffic and the numbers its check compares,
for the program and for the control (the TF32 reference in the program's
place), in one process.

    python3 -m portbench.readings --workload <cell> --seconds <s> --seeds 1 2 3 [--control]

One JSON line a seed on standard output.  ``--seconds 0`` runs no window
(a training cell's readings come from its set-up's steps).  ``--fault
NAME`` plants one of :data:`FAULTS` under the program first, for a fault's
readings.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def half_batch():
    """Half of each micro-batch left out of the training step, its mean
    taken over the rest."""
    from cosy_tpu_torch.train import trainer as T

    orig = T.JointTrainer._micro

    def micro(self, super_batch, a, rows=None):
        out = orig(self, super_batch, a, rows)
        half = next(iter(out.values())).shape[0] // 2
        return {k: v[:half] for k, v in out.items()}

    T.JointTrainer._micro = micro


FAULTS = {"half_batch": half_batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    from . import run
    run.environment()

    import torch

    torch.set_num_threads(1)

    from . import spec
    from .reference import check

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload)
    device = torch.device("cuda", 0)
    if args.fault:
        FAULTS[args.fault]()
    numbers_fn = check.numbers(cell.traffic["driver"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec, samples, inference = run.sample(cell, seed, args.seconds, device, t0)
        t1 = time.perf_counter()
        row = {"seed": seed, "samples": len(samples), "run_s": t1 - t0,
               "audio_s_per_s": rec.audio_s / rec.window_s if rec else None}
        row["program"] = numbers_fn(cell.config, seed, inference, samples, device, control=False)
        t2 = time.perf_counter()
        row["check_s"] = t2 - t1
        if args.control:
            row["control"] = numbers_fn(cell.config, seed, inference, samples, device,
                                        control=True)
            row["control_s"] = time.perf_counter() - t2
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
