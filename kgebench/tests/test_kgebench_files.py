"""BENCHMARK.json against the files the harness finds by name, and the
contract's limits on its shape."""

import json
import re

import pytest

from kgebench import registry
from kgebench.tests.conftest import HELD

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_cells_match_their_files(bench):
    names = [w["name"] for w in registry.load_json(registry.BENCHMARK)["workloads"]]
    assert names == ["transe_l1_fb15k.pool", "transe_l1_fb15k.serve"]
    files = sorted(p.stem for p in (registry.ROOT / "cells").glob("*.json"))
    assert files == sorted(names + list(HELD))
    for w in bench["workloads"]:
        cell = registry.load_json(registry.ROOT / "cells" / f"{w['name']}.json")
        assert (cell["config"], cell["traffic"], cell["why"]) == (w["config"], w["traffic"], w["why"])
        assert w["chips"] == 1
        assert (registry.ROOT / "drivers" / f"{cell['kind']}.py").exists()
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())


@pytest.mark.parametrize("name", ["transe_l1_fb15k.pool", "hole_wn18.iid",
                                  "transe_l1_fb15k.serve", "hole_wn18.pool"])
def test_spec_finds_every_file(bench, name):
    spec = registry.spec(bench, name)
    assert spec.config["model"] == spec.model.__name__.split("_")[-1]
    reported = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.per_layer and all(callable(reader.read) for _, reader in spec.per_layer)
    assert all(m["moves"] in reported for m, _ in spec.per_layer)


def test_contract_shape():
    bench = registry.load_json(registry.BENCHMARK)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert registry.load_json(registry.ROOT.parent / c["file"])["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (registry.ROOT / "metrics" / f"{m['name']}.py").exists() or m in bench["end_to_end"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    assert len({m["layer"] for m in bench["per_layer"]}) >= 3
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= {w["name"] for w in bench["workloads"]}
