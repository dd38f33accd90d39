"""What ``BENCHMARK.json`` and the data files under ``portbench/`` say about
one cell: its configuration file, its traffic mix, the metrics it reports.

Everything is found by the names ``BENCHMARK.json`` gives, under one root:
the checkout's, or, in the tests, a folder that adds files of its own
(``<root>/portbench/traffic/<mix>.json``, ``metrics/<metric>.py``,
``limits/<cell>.json`` and the configuration file the entry names).

Config files hold the dataclass fields of the model's configuration as
JSON (nested groups as objects, tuples as lists); :func:`build` turns such
an object back into the dataclass of either package, the port's or the
frozen reference's, which have the same fields.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from pathlib import Path
from typing import Any, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""

    def __init__(self, name: str, root: Path = ROOT):
        root = Path(root)
        self.root, self.data = root, root / HERE.name
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config: Dict[str, Any] = load_json(root / self.config_entry["file"])
        self.traffic: Dict[str, Any] = load_json(
            self.data / "traffic" / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if _in_cell(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _in_cell(m, name)]


    def limits(self) -> Dict[str, float]:
        """Each number the cell's check compares, with its limit."""
        return load_json(self.data / "limits" / f"{self.name}.json")["limits"]

    def metric_file(self, name: str) -> Path:
        return self.data / "metrics" / f"{name}.py"


def _in_cell(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def build(cls, data: Dict[str, Any]):
    """The dataclass ``cls`` from its JSON object: nested dataclasses
    recursively, lists to tuples where the field is a tuple; a field the
    object leaves out keeps its default, a key the class lacks raises."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = {}
    for key, value in data.items():
        kw[key] = _value(hints[key], value)
    return cls(**kw)


def _value(hint, value):
    origin = typing.get_origin(hint)
    if dataclasses.is_dataclass(hint) and isinstance(value, dict):
        return build(hint, value)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return value if value is None else _value(args[0], value)
    if origin is tuple and isinstance(value, list):
        args = typing.get_args(hint)
        inner = args[0] if args else Any
        return tuple(_value(inner, v) for v in value)
    return value


def as_json(obj) -> Any:
    """A dataclass as the JSON object :func:`build` reads."""
    return json.loads(json.dumps(dataclasses.asdict(obj)))
