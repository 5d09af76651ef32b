"""Shared fixtures: a copy of the benchmark's data files at a tiny size,
so every cell runs on the CPU in a second or two."""

import json
import shutil

import pytest

from kgebench import registry

DATA = ("configs", "traffic", "cells", "metrics", "models")
TINY_CONFIG = {"entities": 300, "relations": 7, "train": 2000, "nbatches": 10, "ncomp": 16}
TINY_TRAFFIC = {
    "pool": {"k": 64},
    "serve": {"batch": 64, "distinct_batches": 8, "sample_queries": 100, "tie_rows": 8,
              "traced_batches": 4},
}


def edit(path, **changes):
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


@pytest.fixture
def tiny_root(tmp_path):
    """The data files copied under tmp_path, every configuration and
    traffic mix shrunk."""
    root = tmp_path / "kgebench"
    for d in DATA:
        shutil.copytree(registry.ROOT / d, root / d)
    for path in (root / "configs").glob("*.json"):
        edit(path, **TINY_CONFIG)
    for name, changes in TINY_TRAFFIC.items():
        edit(root / "traffic" / f"{name}.json", **changes)
    return root


# cells whose files the benchmark keeps but BENCHMARK.json leaves out: their
# host-bound rate swings more between runs than any bound allows (PERF.md)
HELD = ("hole_wn18.iid", "hole_wn18.pool")


def with_held(bench: dict) -> dict:
    """`bench` with the held cells added as a later change would add them."""
    bench = json.loads(json.dumps(bench))
    for name in HELD:
        cell = registry.load_json(registry.ROOT / "cells" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": cell["config"],
                                   "traffic": cell["traffic"], "chips": 1, "why": cell["why"]})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "transe_l1_fb15k.pool" in m.get("workloads", []):
                m["workloads"].append(name)
    return bench


@pytest.fixture
def bench():
    return with_held(registry.load_json(registry.BENCHMARK))
