"""The cell `rotate_fb15k.pool256` at a tiny size on the CPU: its files and
spec, the result line, `correct` (the program passes, the bf16 control and
the planted faults fail), and K6's roofline reader."""

import json
import time

import pytest
import torch

from kgebench import check, counts, limits, registry, run
from kgebench.drivers import train
from kgebench.tests.conftest import TINY_CONFIG

CPU = torch.device("cpu")
CELL = "rotate_fb15k.pool256"


def one_run(bench, root, trace=False, seed=2**33 + 7):
    return run.run_cell(registry.spec(bench, CELL, root), seed, 0.3, trace, CPU,
                        time.perf_counter())


def test_files_and_spec(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert CELL in names
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    cell = registry.load_json(registry.ROOT / "cells" / f"{CELL}.json")
    assert (cell["config"], cell["traffic"], cell["why"]) == (entry["config"], entry["traffic"],
                                                             entry["why"])
    assert entry["chips"] == 1 and cell["kind"] == "train" and cell["control"] == "bf16"
    spec = registry.spec(bench, CELL)
    assert spec.config["model"] == "rotate" and spec.config["model_args"] == {"distance": "modulus"}
    assert spec.model.tables(spec.config) == {"E": (14951, 2000), "R": (1345, 1000)}
    assert -(-spec.config["train"] // spec.config["nbatches"]) == 1024
    assert spec.traffic == {**spec.traffic, "sampler": "shared", "k": 256, "modes": [0, 1]}
    reported = {m["name"] for m in spec.end_to_end}
    assert reported == {"train_triples_per_s", "setup_s"}
    layer = {m["name"] for m, _ in spec.per_layer}
    assert layer == {"idle_share.train", "mfu.train", "sample_ms.train", "sweep_ms.train",
                     "aggregate_ms.train", "update_ms.train", "k1_roofline.train",
                     "k6_roofline.train"}
    config = next(c for c in bench["configs"] if c["name"] == "rotate_fb15k")
    assert config["reduced"] == [] and config["file"] == f"kgebench/configs/{config['name']}.json"


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(bench, tiny_root, trace):
    r = one_run(bench, tiny_root, trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    if trace:
        # on the CPU no K6 kernel runs: its reader finds nothing
        assert "k6_roofline.train" not in r["metrics"]
    else:
        assert set(r["metrics"]) == {"train_triples_per_s", "setup_s"}
    json.dumps(r, allow_nan=False)


def test_program_passes_and_control_fails(bench, tiny_root):
    spec = registry.spec(bench, CELL, tiny_root)
    sess = train.Session(spec, 9, CPU)
    reads = limits.train_readings(sess, spec.cell["control"])
    lim = spec.cell["limits"]
    assert check.judge(reads["program"], lim), reads["program"]
    assert not check.judge(reads["control"], lim), reads["control"]
    assert not check.judge(reads["half_batch"], lim), reads["half_batch"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_faults_fail(bench, tiny_root, monkeypatch, fault):
    real = train.make_pairwise_step

    def broken(*a, **kw):
        step = real(*a, **kw)
        if fault == "unchanged":
            return lambda state, batch, mask, **k: (state, step(state, batch, mask, **k)[1])

        def half(state, batch, mask, **k):
            keep = torch.arange(mask.shape[0]) < mask.shape[0] // 2
            return step(state, batch, mask * keep, **k)
        return half

    monkeypatch.setattr(train, "make_pairwise_step", broken)
    assert one_run(bench, tiny_root)["correct"] is False


def test_k6_roofline_reader(bench, tiny_root):
    """The reader's work from the tiny files, its share from kernels named
    as csrc/rotate_pool.cu's, and nothing from a span of other work."""
    from kgebench.profiling import Span

    reader = dict((m["name"], r) for m, r in registry.spec(bench, CELL, tiny_root).per_layer)[
        "k6_roofline.train"]
    flops, nbytes = reader.work(tiny_root)
    d, n, nb = TINY_CONFIG["ncomp"], TINY_CONFIG["train"], TINY_CONFIG["nbatches"]
    assert flops == n * 2 * 256 * 15 * d
    b = 2 * -(-n // nb)
    assert nbytes == 4 * nb * (4 * b * 2 * d + 4 * 256 * 2 * d + 3 * b * 256)
    # drivers/train.py's model_flops for a traced epoch of this cell
    spec = registry.spec(bench, CELL, tiny_root)
    ours = counts.train_flops(spec.model, spec.config, spec.traffic, train.Session(spec, 3, CPU).n)
    assert reader.model_flops(tiny_root) == ours
    span = Span(card="NVIDIA H100 80GB HBM3", kind="train", model_flops=ours,
                kernels=[("void (anonymous namespace)::rotate_pool_forward_kernel(...)", 0.0, 1e6),
                         ("other", 0.0, 5e6)])
    least = max(flops / 67e12, nbytes / 3.35e12)
    assert reader.read(span) == pytest.approx(100.0 * least / 1.0)
    assert reader.read(Span(card="NVIDIA H100 80GB HBM3", kind="train", model_flops=ours)) is None
    assert reader.read(Span(card="cpu", kind="train", kernels=span.kernels,
                            model_flops=ours)) is None
    # a span of another cell's work (another pool size here) reads nothing
    other = dict(spec.traffic, k=128)
    assert reader.read(Span(card=span.card, kind="train", kernels=span.kernels,
                            model_flops=counts.train_flops(spec.model, spec.config, other,
                                                           spec.config["train"]))) is None
