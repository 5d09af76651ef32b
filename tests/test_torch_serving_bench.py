"""The port's serving bench (skge_torch/serving_bench.py) against the JAX
package's (scripts/serving_bench.py), on the CPU at tiny sizes: the same
JSON line (metric name, unit, batch, entities, quantize, recall key) for
the exact, L2, bf16 and quantized engines; the same known triples and
query stream; and, with JAX's params carried across, the same top-k ids
as JAX's `LinkPredictor` on that stream.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import skge_tpu
from skge_torch import serving_bench as sb

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts")
)

import serving_bench as jsb  # noqa: E402

torch.set_num_threads(1)

GAP = 1e-5
TINY = ["--cpu", "--entities", "500", "--relations", "8", "--nqueries", "300",
        "--nknown", "2000", "--ncomp", "16", "--batch", "64"]


@pytest.fixture
def jax_run(monkeypatch):
    """Runs JAX's main on `argv`; returns (its JSON line, the engines it
    built: [(params, known, queries, result)])."""
    def run(argv):
        made = []

        class Recorded(skge_tpu.LinkPredictor):
            def __init__(self, model, params, known=None, **kw):
                super().__init__(model, params, known=known, **kw)
                made.append({"params": params, "known": known})

            def top_k(self, queries, k, direction="o", **kw):
                res = super().top_k(queries, k, direction=direction, **kw)
                mine = next(m for m in made if m["known"] is self._known_ref)
                mine["queries"], mine["result"] = queries, res
                return res

        orig_init = Recorded.__init__

        def init(self, model, params, known=None, **kw):
            self._known_ref = known
            orig_init(self, model, params, known=known, **kw)

        Recorded.__init__ = init
        monkeypatch.setattr(skge_tpu, "LinkPredictor", Recorded)
        monkeypatch.setattr(sys, "argv", ["serving_bench.py", *argv])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jsb.main()
        return json.loads(out.getvalue().strip().splitlines()[-1]), made

    return run


CASES = {
    "exact": [],
    "l2": ["--l2"],
    "bf16": ["--bf16"],
    "int8 recall": ["--quantize", "int8", "--recall"],
    "fp8": ["--quantize", "fp8"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_line_equals_jax(jax_run, case):
    want, _ = jax_run(TINY + CASES[case])
    got, res = sb.main(TINY + CASES[case])
    assert set(got) == set(want)
    for key in set(want) - {"value", "recall_vs_exact"}:
        assert got[key] == want[key], key
    assert got["value"] > 0
    assert res.entities.shape == (300, 10)
    if "recall_vs_exact" in want:
        assert 0.5 <= got["recall_vs_exact"] <= 1.0


def test_query_stream_equals_jax(jax_run):
    _, made = jax_run(TINY)
    known, queries = sb.query_stream(500, 8, 2000, 300)
    np.testing.assert_array_equal(known, made[0]["known"])
    np.testing.assert_array_equal(queries, made[0]["queries"])
    assert known.dtype == queries.dtype == np.int32


@pytest.mark.parametrize("case", ["exact", "l2"])
def test_top_k_equals_jax_on_jax_params(jax_run, case):
    _, made = jax_run(TINY + CASES[case])
    params = {k: torch.as_tensor(np.array(v)) for k, v in made[0]["params"].items()}
    _, res = sb.main(TINY + CASES[case], params=params)
    want = made[0]["result"]
    got_ids, want_ids = res.entities, np.asarray(want.entities)
    # fp32 scores summed in another order: ids equal wherever JAX's
    # neighbouring scores lie more than GAP apart, in order
    gaps = -np.diff(np.asarray(want.scores, np.float64), axis=1)
    apart = np.concatenate([gaps > GAP, np.ones((len(gaps), 1), bool)], axis=1)
    apart[:, 1:] &= gaps > GAP
    np.testing.assert_array_equal(got_ids[apart], want_ids[apart])
    assert apart.mean() > 0.99
    np.testing.assert_allclose(res.scores, np.asarray(want.scores), rtol=1e-5, atol=1e-5)


def test_gpu_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        sb.main(["--entities", "500"])
