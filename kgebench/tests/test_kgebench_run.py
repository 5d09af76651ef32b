"""Whole runs at a tiny size on the CPU: the result line, a cell added as
files only, the import check, and the end without a card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from kgebench import registry, run

CPU = torch.device("cpu")
CELLS = ["transe_l1_fb15k.pool", "hole_wn18.iid", "transe_l1_fb15k.serve", "hole_wn18.pool"]


def one_run(bench, root, name, trace=False, seed=2**31 + 11):
    return run.run_cell(registry.spec(bench, name, root), seed, 0.3, trace, CPU,
                        time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(bench, tiny_root, name, trace):
    r = one_run(bench, tiny_root, name, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} and c["value"] <= c["limit"]
               for c in r["checks"].values())
    spec = registry.spec(bench, name)
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU only the per-layer metrics read off the host clock remain
        assert set(r["metrics"]) <= {m["name"] for m, _ in spec.per_layer}
    else:
        assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    json.dumps(r, allow_nan=False)


def test_same_seed_same_inputs(bench, tiny_root):
    a = one_run(bench, tiny_root, "hole_wn18.pool", seed=5)
    b = one_run(bench, tiny_root, "hole_wn18.pool", seed=5)
    assert a["checks"] == b["checks"]


def test_cell_added_as_files_only(bench, tiny_root):
    """A configuration, a traffic mix, a cell and a per-layer metric, each a
    new file; the harness's code untouched."""
    cfg = json.loads((tiny_root / "configs" / "hole_wn18.json").read_text())
    cfg.update(entities=250, relations=5, margin=0.5)
    (tiny_root / "configs" / "hole_small.json").write_text(json.dumps(cfg))
    (tiny_root / "traffic" / "pool_wide.json").write_text(json.dumps(
        {"sampler": "shared", "k": 96, "modes": [0, 1]}))
    cell = json.loads((tiny_root / "cells" / "hole_wn18.pool.json").read_text())
    cell.update(config="hole_small", traffic="pool_wide", why="a pool of 96")
    (tiny_root / "cells" / "hole_small.pool_wide.json").write_text(json.dumps(cell))
    (tiny_root / "metrics" / "epoch_ms.train.py").write_text(
        "def read(span):\n    return 1e3 * span.window_s\n")
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "hole_small.pool_wide", "config": "hole_small",
                               "traffic": "pool_wide", "chips": 1, "why": "a pool of 96"})
    bench["end_to_end"][0]["workloads"].append("hole_small.pool_wide")
    bench["per_layer"].append({"name": "epoch_ms.train", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "training step",
                               "moves": "train_triples_per_s"})
    r = one_run(bench, tiny_root, "hole_small.pool_wide")
    assert r["correct"] and set(r["metrics"]) == {"train_triples_per_s", "setup_s"}
    assert one_run(bench, tiny_root, "hole_small.pool_wide", trace=True)["metrics"][
        "epoch_ms.train"]["value"] > 0


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert run.forbidden_modules() == []
    for name in ("jaxtyping", "skge_torch.x", "skgeX", "flaxen"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    assert run.forbidden_modules() == []
    for name in ("jax.numpy", "skge", "skge_tpu.models", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    assert run.forbidden_modules() == ["flax", "jax", "jaxlib", "skge", "skge_tpu"]


CHILD = """
import sys, time, torch
from kgebench import registry, run
root = sys.argv[1]
spec = registry.spec(registry.load_json(registry.BENCHMARK), "transe_l1_fb15k.serve",
                     __import__("pathlib").Path(root))
run.run_cell(spec, 3, 0.2, True, torch.device("cpu"), time.perf_counter())
print(run.forbidden_modules(), sorted(m for m in sys.modules if m.split(".")[0] == "skge_torch")[:1])
"""


def test_a_run_imports_no_jax(tiny_root):
    out = subprocess.run([sys.executable, "-c", CHILD, str(tiny_root)], capture_output=True,
                         text=True, cwd=registry.ROOT.parent, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] ['skge_torch']"


def test_no_card_no_result():
    """Without CUDA the command exits 3 and prints nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "kgebench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=registry.ROOT.parent, timeout=300)
    assert out.returncode == 3 and out.stdout == ""


def test_limits_cli_on_cpu(tiny_root, capsys):
    from kgebench import limits

    limits.main(["--workload", "transe_l1_fb15k.pool", "--seeds", "1", "--cpu"], tiny_root)
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) >= {"program", "control", "half_batch"}


@pytest.mark.cuda
def test_cells_on_the_card(bench, tiny_root):
    """Every cell at the tiny size on the card, traced: the readers find
    their numbers (run on the chip: `python -m pytest -m cuda kgebench/tests`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in CELLS:
        spec = registry.spec(bench, name, tiny_root)
        r = run.run_cell(spec, 7, 0.3, True, torch.device("cuda"), time.perf_counter())
        assert r["correct"] and r["device"]["busy_s"] > 0
        assert set(r["metrics"]) == {m["name"] for m, _ in spec.per_layer}
