"""`LinkPredictor(mesh=)` and `FilteredRankingEval(mesh=)` against the
port's single-device engines. A world of four processes holds the mesh at
(1, 4) and at (2, 2). The entity table repeats every sixth row, so every
score ties with one in each other shard and the k-th place is decided by
the lower-id rule across shards: the mesh engine must return the single
engine's top-k ids and values exactly, both directions, filtered and not,
from whole tables and from this rank's rows, in fp32 and with int8, fp8
and bfloat16 tables; `score_triples` likewise. The mesh ranking must give
the unsharded ranks. The world runs this file as a script (torch, numpy
and skge_torch only).
"""

import os
import sys

import numpy as np
import pytest
import torch

import skge_torch
from skge_torch.parallel import distributed
from skge_torch.parallel import mesh as tmesh

WORLD_TIMEOUT_S = 150
N_E, N_R, DIM, K = 24, 4, 8, 10
SHAPES = [(1, 4), (2, 2)]
QUANT = ("", "int8", "fp8", "bfloat16")


def fixture_data():
    rng = np.random.default_rng(9)
    base = rng.normal(size=(6, DIM)).astype(np.float32)
    params = {"E": np.tile(base, (N_E // 6, 1)),  # ties across every shard
              "R": rng.normal(size=(N_R, DIM)).astype(np.float32)}
    known = np.stack([rng.integers(0, N_E, 60), rng.integers(0, N_E, 60),
                      rng.integers(0, N_R, 60)], axis=1)
    queries = np.stack([rng.integers(0, N_E, 13), rng.integers(0, N_R, 13)], axis=1)
    test = known[:20]
    return params, known, queries, test


def model():
    return skge_torch.DistMult(N_E, N_R, DIM)


def run_engines(mesh=None, local=False):
    """{key: array}: every engine's top-k, the triple scores and the ranks."""
    params, known, queries, test = fixture_data()
    m = model()
    tables = {k: torch.as_tensor(v) for k, v in params.items()}
    if local:  # this rank's rows, as Trainer(mesh=) holds them
        tables["E"] = tmesh.row_block(tables["E"], N_E, mesh.model)
    out = {}
    for quant in QUANT:
        pred = skge_torch.LinkPredictor(m, tables, known=known, batch_size=8, mesh=mesh,
                                        quantize=quant, device="cpu")
        for direction in ("o", "s"):
            for filtered in (True, False):
                res = pred.top_k(queries, K, direction, filtered)
                key = f"{quant or 'fp32'}/{direction}/{filtered}"
                out[key + "/ids"], out[key + "/vals"] = res.entities, res.scores
        out[f"{quant or 'fp32'}/triples"] = pred.score_triples(test)
    ev = skge_torch.FilteredRankingEval(m, test, known, batch_size=8, mesh=mesh)
    res = ev(tables)
    out["ranks"], out["ranks_raw"] = res.ranks, res.ranks_raw
    return out


def worker(out_dir):
    torch.set_num_threads(1)
    distributed.initialize(device="cpu", timeout_s=WORLD_TIMEOUT_S)
    out = {}
    for shape in SHAPES:
        mesh = tmesh.make_mesh(shape, device="cpu")
        for local in (False, True):
            for k, v in run_engines(mesh, local).items():
                out[f"{shape[0]}x{shape[1]}/{local}/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{torch.distributed.get_rank()}.npz"), **out)
    distributed.destroy()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serving")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = distributed.launch_local([sys.executable, os.path.abspath(__file__), str(tmp)],
                                     4, WORLD_TIMEOUT_S, store_dir=str(tmp), env=env)
    for rank, (rc, _, err) in enumerate(procs):
        assert rc == 0, f"rank {rank}: {err[-3000:]}"
    return run_engines(), [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("local", [False, True], ids=["whole", "local"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quant", QUANT, ids=lambda q: q or "fp32")
def test_mesh_top_k_equals_single_engine(world, quant, shape, local):
    want, ranks = world
    q = quant or "fp32"
    for r, got in enumerate(ranks):
        pre = f"{shape[0]}x{shape[1]}/{local}/{q}/"
        for key in [k for k in want if k.startswith(q + "/")]:
            np.testing.assert_array_equal(got[f"{shape[0]}x{shape[1]}/{local}/{key}"],
                                          want[key], err_msg=f"rank {r} {pre}{key}")


def test_ties_reach_the_kth_place_across_shards(world):
    """The fixture tests the tie rule: every score is held by one row of
    each shard, so the k-th place (k = 10 = 4 + 4 + 2) splits a group of
    four equal candidates, and the engine keeps the group's lowest ids, in
    ascending order."""
    want, _ = world
    for direction in ("o", "s"):
        ids = want[f"fp32/{direction}/False/ids"]
        vals = want[f"fp32/{direction}/False/vals"]
        for row_ids, row_vals in zip(ids, vals):
            tied = row_ids[row_vals == row_vals[K - 1]]
            assert 0 < len(tied) < N_E // 6, "the k-th place must split a group"
            group = np.arange(tied[0] % 6, N_E, 6)  # every id with that score
            np.testing.assert_array_equal(tied, group[:len(tied)])


@pytest.mark.parametrize("local", [False, True], ids=["whole", "local"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_ranking_equals_unsharded(world, shape, local):
    want, ranks = world
    for got in ranks:
        for key in ("ranks", "ranks_raw"):
            np.testing.assert_array_equal(got[f"{shape[0]}x{shape[1]}/{local}/{key}"],
                                          want[key])


def test_mesh_engine_rejects_indivisible_entity_count():
    cpu = torch.device("cpu")
    mesh = tmesh.Mesh(shape={"data": 1, "model": 4},
                      data=distributed.ShardGroup(None, 0, 1, cpu),
                      model=distributed.ShardGroup(None, 0, 4, cpu), rank=0, device=cpu)
    m = skge_torch.DistMult(N_E + 2, N_R, DIM)
    with pytest.raises(ValueError, match="not divisible"):
        skge_torch.LinkPredictor(m, m.init_params(torch.Generator()), mesh=mesh,
                                 device="cpu")


if __name__ == "__main__":
    worker(sys.argv[1])
