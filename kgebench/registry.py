"""Finds what a cell is made of, by the names in `BENCHMARK.json`.

Under the data root (this folder unless a caller gives another):

- `cells/<cell>.json`: its configuration, traffic, driver `kind`, `why`
  and the limits of the numbers its check compares;
- `configs/<config>.json`: the model, widths, graph, loss, optimizer,
  `source`, `reduced` and `assumed`;
- `traffic/<traffic>.json`: the sampler or the query stream;
- `models/<model>.py`: the model's plain reference and operation counts;
- `metrics/<metric>.py`: the reader of one per-layer metric, `read(span)`,
  which returns a number or None when it finds nothing to read.

`kind` picks the driver, `kgebench/drivers/<kind>.py`.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Spec:
    name: str
    chips: int
    kind: str
    cell: dict
    config: dict
    traffic: dict
    model: ModuleType
    end_to_end: list    # the cell's entries of BENCHMARK.json's end_to_end
    per_layer: list     # (entry, reader module) of its per_layer metrics


def _module_name(kind: str, name: str) -> str:
    return "kgebench_" + kind + "_" + "".join(c if c.isalnum() else "_" for c in name)


def spec(bench: dict, name: str, root: Path = ROOT) -> Spec:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in the benchmark")
    cell = load_json(root / "cells" / f"{name}.json")
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} {cell[key]!r} in its file, "
                             f"{entry[key]!r} in the benchmark")
    config = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    model = load_module(root / "models" / f"{config['model']}.py",
                        _module_name("model", config["model"]))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = []
    for m in bench["per_layer"]:
        if name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names:
            per_layer.append((m, load_module(root / "metrics" / f"{m['name']}.py",
                                             _module_name("metric", m["name"]))))
    return Spec(name=name, chips=entry["chips"], kind=cell["kind"], cell=cell,
                config=config, traffic=traffic, model=model, end_to_end=e2e,
                per_layer=per_layer)
