"""The harness as a whole: it measures only on a card, every cell finds
its files by name, ``BENCHMARK.json`` keeps to the contract's shape, a
run's last line has the contract's form, and nothing a run loads is JAX or
the JAX package (top-level names compared whole: the port's name begins
with the JAX package's)."""

import json
import math
import os
import re
import subprocess
import sys
import textwrap

import torch

from portbench import run, spec
from portbench.tests import tiny

ROOT = spec.ROOT
BENCH = spec.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "cosy_tpu")


def test_the_harness_refuses_to_measure_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cell = BENCH["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA" in out.stderr


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"])
        assert (spec.HERE / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert (spec.HERE / "reference" / f"{cell.traffic['driver']}.py").is_file()
        limits = cell.limits()
        assert limits and all(v > 0 for v in limits.values())
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
        moved = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in moved for m in cell.per_layer)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = run.metric_module(spec.HERE / "metrics" / f"{m['name']}.py")
        assert callable(mod.read), m["name"]


def test_benchmark_json_keeps_to_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == [spec.HERE.name]
    assert len(BENCH["command"]) <= 32
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith(f"{spec.HERE.name}/")
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        assert (ROOT / c["file"]).is_file()
    cfgs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in cfgs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == cfgs
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for w in BENCH["workloads"]:  # every cell: setup_s, another end-to-end metric, a layer's
        mine = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_run_from_data_at_a_tiny_size_prints_the_contract_line(tmp_path, capsys):
    root = tiny.root(tmp_path)
    cell = spec.Cell("tiny.vc-long", root=root)
    out = run.run_cell(cell, 2 ** 31 + 5, 2.0, False, torch.device("cpu"), 0.0)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and math.isfinite(v["value"]) and v["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["compared"]) == set(cell.limits())
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    traced = run.run_cell(cell, 2 ** 31 + 5, 2.0, True, torch.device("cpu"), 0.0)
    # no card, no device trace: every trace reader finds nothing and says so
    assert traced["correct"] is True and traced["metrics"] == {}


_ISOLATION = textwrap.dedent('''
    import importlib, json, pkgutil, sys
    sys.path.insert(0, {root!r})
    import portbench
    {body}
''')


def _fresh(body: str):
    code = _ISOLATION.format(root=str(ROOT), body=textwrap.dedent(body))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_nothing_of_jax_or_the_jax_package(tmp_path):
    """A whole run at a tiny size in a fresh process, and every module of
    the harness imported: the port is there, JAX and ``cosy_tpu`` are not."""
    root = tiny.root(tmp_path)
    loaded = _fresh(f'''
        import torch
        from portbench import run, spec
        for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
            if not m.name.startswith("portbench.tests"):
                importlib.import_module(m.name)
        for p in sorted((run.HERE / "metrics").glob("*.py")):
            run.metric_module(p)
        for name in ("tiny.vc-long", "tiny.stream16"):
            run.run_cell(spec.Cell(name, root={str(root)!r}), 7, 1.0, True,
                         torch.device("cpu"), 0.0)
        assert not run.forbidden_modules()
        print(json.dumps(sorted(sys.modules)))
    ''')
    assert "cosy_tpu_torch.infer.engine" in loaded
    assert "portbench.reference.frozen.infer.pipeline2" in loaded
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN]


def test_the_isolation_check_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cosy_tpu_torch_x", sys)
    assert not [m for m in run.forbidden_modules() if m == "cosy_tpu_torch_x"]
    monkeypatch.setitem(sys.modules, "cosy_tpu.config", sys)
    assert "cosy_tpu.config" in run.forbidden_modules()


def test_the_reference_loads_nothing_of_the_program():
    loaded = _fresh('''
        import portbench.reference
        for m in pkgutil.walk_packages(portbench.reference.__path__, "portbench.reference."):
            importlib.import_module(m.name)
        print(json.dumps(sorted(sys.modules)))
    ''')
    assert "portbench.reference.check" in loaded
    assert not [m for m in loaded if m.split(".")[0] in ("cosy_tpu_torch",) + FORBIDDEN]
