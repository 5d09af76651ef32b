"""The port's spans (`skge_torch.utils.metrics.span`) on the CPU: off
outside `torch.profiler` (no annotation, no CUDA event, no clock read),
on inside it (every span a `user_annotation` of the trace, the step's
children inside the step), their counts, the same numbers either way, the
benchmark's readers of them, the store emptied at each profiled stretch,
and torch's flag that turns them on.
"""

import json
import time
import types

import numpy as np
import pytest
import torch

from kgebench import registry, run
from kgebench.tests.conftest import TINY_CONFIG, TINY_TRAFFIC, tiny_root  # noqa: F401
from skge_torch.data import synthetic_kg
from skge_torch.models import MODELS
from skge_torch.optim import AdaGrad
from skge_torch.sampling import SharedNegativeSampler
from skge_torch.serving import LinkPredictor
from skge_torch.training import init_state, make_epoch_fn, make_pairwise_step
from skge_torch.utils import metrics
from skge_torch.utils.metrics import span, span_totals

torch.set_num_threads(1)

N_E, N_R, N_TRAIN, NBATCHES = 120, 6, 600, 4
QUERY_BATCH, NQ = 16, 40  # three serving batches, the last one short
STEP = ("skge_torch.train.sample", "skge_torch.train.score",
        "skge_torch.train.aggregate", "skge_torch.train.update")
SPANS = ("skge_torch.train.step",) + STEP + (
    "skge_torch.train.shuffle", "skge_torch.serve.batch", "skge_torch.serve.filter",
    "skge_torch.serve.score", "skge_torch.serve.topk", "skge_torch.serve.fetch")


def cpu_profile():
    """A CPU profile whose spans start from an empty store: one span with
    the profiler off comes first, as the window comes before a traced span."""
    with span("skge_torch.test.off"):
        pass
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def workload():
    """One epoch of the shared-pool TransE-L1 step through the dense
    aggregation, then the top 5 of every query, filtered by the graph."""
    ds = synthetic_kg(N_E, N_R, N_TRAIN, seed=1, clustered=False)
    model = MODELS["transe"](N_E, N_R, 8)
    opt = AdaGrad(lr=0.1)
    step = make_pairwise_step(model, opt, SharedNegativeSampler(N_E, k=16), margin=1.0,
                              aggregate="dense")
    epoch = make_epoch_fn(step, N_TRAIN, NBATCHES)
    state = init_state(model, opt, torch.Generator().manual_seed(0))
    state, m = epoch(state, torch.as_tensor(ds.train, dtype=torch.int64))
    pred = LinkPredictor(model, state.params, known=ds.train, batch_size=QUERY_BATCH,
                         device="cpu")
    q = np.stack([np.arange(NQ) % N_E, np.arange(NQ) % N_R], axis=1)
    top = pred.top_k(q, 5)
    return m.loss, state.params, top


def test_off_records_nothing(monkeypatch):
    before = span_totals()

    def refuse(*a, **kw):
        raise AssertionError("a span recorded with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(metrics, "time", types.SimpleNamespace(perf_counter=refuse))
    workload()
    assert span("a") is span("b")
    assert span_totals() == before


def test_on_every_span_in_the_trace(tmp_path):
    with cpu_profile() as prof:
        workload()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append((float(e["ts"]),
                                                  float(e["ts"]) + float(e["dur"])))
    assert set(SPANS) <= set(by_name)
    steps = by_name["skge_torch.train.step"]
    assert len(steps) == NBATCHES
    for name in STEP:
        for a, b in by_name[name]:
            assert any(s <= a and b <= e for s, e in steps), name


def test_counts():
    with cpu_profile():
        workload()
    totals = span_totals()
    assert set(totals) == set(SPANS)
    calls = {name: c for name, (c, _, _) in totals.items()}
    for name in ("skge_torch.train.step", "skge_torch.train.sample",
                 "skge_torch.train.score", "skge_torch.train.aggregate",
                 "skge_torch.train.update"):
        # E and R in one grouped scatter, and updated in one span
        assert calls[name] == NBATCHES, name
    assert calls["skge_torch.train.shuffle"] == 1
    batches = -(-NQ // QUERY_BATCH)
    for name in SPANS[6:]:
        assert calls[name] == batches, name
    assert all(host > 0 and stream is None for _, host, stream in totals.values())


def test_same_numbers_on_and_off():
    off = workload()
    with cpu_profile():
        on = workload()
    assert torch.equal(off[0], on[0])
    assert off[1].keys() == on[1].keys()
    assert all(torch.equal(off[1][k], on[1][k]) for k in off[1])
    np.testing.assert_array_equal(off[2].entities, on[2].entities)
    np.testing.assert_array_equal(off[2].scores, on[2].scores)


def test_store_holds_the_latest_profiled_stretch():
    for _ in range(2):
        with cpu_profile():
            for _ in range(3):
                with span("skge_torch.test.on"):
                    pass
        assert span_totals()["skge_torch.test.on"][0] == 3
        assert "skge_torch.test.off" not in span_totals()


def test_torch_sets_the_flag_under_the_profiler(tmp_path):
    """The spans follow `torch.autograd.profiler._is_profiler_enabled`: a
    torch that stopped setting it would turn them off silently."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with cpu_profile():
        assert flag() is True
    with metrics.profile_trace(str(tmp_path)):
        assert flag() is True
    assert flag() is False


def traced(root, name):
    bench = registry.load_json(registry.BENCHMARK)
    return run.run_cell(registry.spec(bench, name, root), 2**31 + 5, 0.2, True,
                        torch.device("cpu"), time.perf_counter())


STREAM_READERS = ("sample_ms.train", "sweep_ms.train", "aggregate_ms.train",
                  "update_ms.train", "sweep_ms.serve", "topk_ms.serve")


@pytest.mark.parametrize("cell", ["transe_l1_fb15k.pool", "transe_l1_fb15k.serve"])
def test_readers_on_the_cpu(tiny_root, cell):
    """Off CUDA the stream readers find nothing; the serving cell's host
    readers find the traced batches' filter and fetch."""
    r = traced(tiny_root, cell)
    assert r["correct"]
    assert not set(STREAM_READERS) & set(r["metrics"])
    if cell.endswith(".serve"):
        for name in ("filter_ms.serve", "fetch_ms.serve"):
            assert r["metrics"][name]["value"] > 0 and r["metrics"][name]["unit"] == "ms"
        traced_batches = TINY_TRAFFIC["serve"]["traced_batches"]
        # a second traced run in the process reads only its own batches
        assert span_totals()["skge_torch.serve.batch"][0] == traced_batches
        traced(tiny_root, cell)
        assert span_totals()["skge_torch.serve.batch"][0] == traced_batches
    else:
        totals = span_totals()
        assert totals["skge_torch.train.step"][0] == TINY_CONFIG["nbatches"]
        assert "skge_torch.serve.batch" not in totals
