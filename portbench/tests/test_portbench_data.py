"""A configuration, a traffic mix and a per-layer metric added as files
only: a folder laid out as a checkout gains one of each, and the harness
finds them by the names its ``BENCHMARK.json`` gives and runs the new cell
without an edit to any file of the harness."""

import json

import torch

from portbench import run, spec
from portbench.tests import tiny

METRIC = '''"""Whole calls a second of the window."""


def read(rec):
    return rec.attempted / rec.window_s if rec.attempted else None
'''


def test_a_config_a_mix_and_a_metric_added_as_files(tmp_path):
    root = tiny.root(tmp_path, extra_metrics={"calls_per_s": METRIC})
    data = root / spec.HERE.name
    cfg = tiny.config_300m()
    cfg["model"]["flow"]["estimator"]["num_mid_blocks"] = 2
    (data / "configs" / "tiny-300m-deeper.json").write_text(json.dumps(cfg))
    (data / "traffic" / "vc-short.json").write_text(json.dumps({
        "driver": "token2wav", "why": "short token2wav calls",
        "tokens": {"dist": "loguniform", "min": 20, "max": 60}, "table": 2,
        "trace_seconds": 1, "check_calls": 2}))
    (data / "limits" / "tiny.deeper.vc-short.json").write_text(json.dumps(
        {"why": "toy", "limits": {"wav_rel_err": 2e-5}}))
    bench = spec.load_json(root / "BENCHMARK.json")
    bench["configs"].append({"name": "tiny-300m-deeper", "source": "toy", "reduced": [],
                             "file": f"{spec.HERE.name}/configs/tiny-300m-deeper.json",
                             "why": "toy"})
    bench["workloads"].append({"name": "tiny.deeper.vc-short", "config": "tiny-300m-deeper",
                               "traffic": "vc-short", "chips": 1, "why": "toy"})
    e2e = next(m for m in bench["end_to_end"] if m["name"] == "audio_s_per_s")
    e2e["workloads"].append("tiny.deeper.vc-short")
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "entry",
                               "moves": "audio_s_per_s", "workloads": ["tiny.deeper.vc-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.Cell("tiny.deeper.vc-short", root=root)
    assert cell.config["model"]["flow"]["estimator"]["num_mid_blocks"] == 2
    assert cell.traffic["tokens"]["max"] == 60
    assert [m["name"] for m in cell.per_layer] == ["calls_per_s"]
    out = run.run_cell(cell, 11, 1.5, False, torch.device("cpu"), 0.0)
    assert out["correct"] and set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
    traced = run.run_cell(cell, 11, 1.5, True, torch.device("cpu"), 0.0)
    assert traced["correct"] and traced["metrics"]["calls_per_s"]["value"] > 0
