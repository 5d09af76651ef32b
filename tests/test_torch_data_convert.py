"""The port's data helpers and weight conversion, and its independence from
JAX: skge_torch/data.py against skge_tpu/data.py, skge_torch/convert.py
round trips, and an import scan of the port's files.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from skge_tpu import data as jdata
from skge_tpu import training as jtraining
from skge_tpu.models import TransE as JTransE
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_torch import convert
from skge_torch import data as tdata

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("clustered", [True, False])
def test_synthetic_kg_equals_jax_package(clustered):
    kw = dict(n_entities=60, n_relations=7, n_train=900, n_valid=40,
              n_test=50, seed=3, clustered=clustered)
    want, got = jdata.synthetic_kg(**kw), tdata.synthetic_kg(**kw)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(got, split), getattr(want, split))
        assert getattr(got, split).dtype == np.int32
    assert (got.n_entities, got.n_relations) == (want.n_entities, want.n_relations)
    np.testing.assert_array_equal(got.all_triples(), want.all_triples())


def test_true_triple_index_and_keys_equal_jax_package():
    ds = jdata.synthetic_kg(40, 5, 500, seed=1)
    np.testing.assert_array_equal(
        tdata.encode_keys_np(ds.train, 40, 5), jdata.encode_keys_np(ds.train, 40, 5)
    )
    # the port groups in NumPy, the JAX package in a Python loop: duplicate
    # triples and an empty list too
    for triples in (ds.train, np.concatenate([ds.train, ds.train[::7]]),
                    ds.train[:0]):
        for got, want in zip(tdata.true_triple_index(triples),
                             jdata.true_triple_index(triples)):
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_params_round_trip():
    rng = np.random.default_rng(0)
    arrays = {"E": rng.normal(size=(9, 4)).astype(np.float32),
              "R": rng.normal(size=(3, 4))}
    params = convert.params_from_numpy(arrays, "cpu")
    assert params["E"].dtype == torch.float32 and params["R"].dtype == torch.float64
    back = convert.params_to_numpy(params)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
        assert back[k].dtype == arrays[k].dtype


def test_state_from_jax_train_state():
    model, opt = JTransE(30, 4, 8), JAdaGrad(lr=0.1)
    jstate = jtraining.init_state(model, opt, jax.random.PRNGKey(0))
    jstate = jstate._replace(
        opt_state={k: {"p2": v["p2"] + 0.5} for k, v in jstate.opt_state.items()},
        step=jstate.step + 3,
    )
    host = jax.device_get(jstate)
    state = convert.state_from_numpy(host, "cpu", seed=1)
    assert state.step == 3
    assert state.generator.device.type == "cpu"
    for k in ("E", "R"):
        np.testing.assert_array_equal(state.params[k].numpy(), host.params[k])
        np.testing.assert_array_equal(state.opt_state[k]["p2"].numpy(),
                                      host.opt_state[k]["p2"])
    back = convert.params_to_numpy(state.params)
    for k in back:
        np.testing.assert_array_equal(back[k], host.params[k])


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "skge_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    for module in ("utils/__init__", "utils/checkpoint", "utils/metrics", "trainer",
                   "experiment", "native", "utils/debug", "models/distmult",
                   "models/complexe", "models/simple", "models/tucker", "models/quate",
                   "models/rotate", "models/transh", "models/pairre", "models/transr",
                   "models/conve", "compat", "sample", "param", "actfun", "util",
                   "quality_suite", "bench", "run_transe", "run_hole", "run_rescal",
                   "run_ermlp", "verify_selfadv", "verify_ce", "verify_n3",
                   "rotate_probe", "density_curve"):
        assert f"skge_torch/{module}.py" in scanned, module
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            # nor the JAX system's scripts/ and root bench.py (imported as
            # top-level modules)
            assert top not in ("jax", "jaxlib", "skge_tpu", "skge", "scripts",
                               "quality_suite", "bench", "density_curve",
                               "rotate_probe", "serving_bench", "_verify_ce",
                               "_verify_n3", "_verify_selfadv", "run_transe",
                               "run_hole", "run_rescal", "run_ermlp"), (f, mod)
