"""`Trainer(mesh=)` against the port's single-device `Trainer`, fp64
within 1e-9 and the same violations every epoch: 3 epochs at (1, 1),
(2, 2), (4, 1) and (1, 4) of the pairwise step on iid negatives (batches
of 83, padded to the 'data' axis), on a shared pool and with RESCAL's
`shard_relations`, the pointwise step on iid negatives (`sharded`'s route)
and on a pool, selfadv, sampled CE and the vocab-parallel full CE. The
mesh draws for the global batch from the same generator on every rank,
so the trajectory is the single-device one. Every rank ends with the same
full tables, and the checkpoint (gathered over 'model', written by rank
0) loads in both packages; restored on the CPU, it resumes the mesh
trainer on the single-device trajectory (the generator's position carried
over).

The single-device trainers run in this process; the mesh trainers in a
gloo world of one and a world of four (the three other shapes in turn),
which run this file as a script (torch, numpy and skge_torch only).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import skge_torch
from skge_torch.data import synthetic_kg
from skge_torch.parallel import distributed

TOL = dict(rtol=1e-9, atol=1e-12)
WORLD_TIMEOUT_S = 150
SHAPES = [(1, 1), (2, 2), (4, 1), (1, 4)]
EPOCHS, NB = 3, 4
# name: (model, sampler, config keywords)
CASES = {
    "pairwise-iid": ("transe", "iid", {}),
    "pairwise-pool": ("transe", "pool", {}),
    "pairwise-rescal-shardrel": ("rescal", "pool", {"shard_relations": True}),
    "pointwise-iid": ("transe", "iid", {"pairwise": False}),
    "pointwise-pool": ("transe", "pool", {"pairwise": False}),
    "selfadv": ("transe-l2", "pool", {"loss": "selfadv", "margin": 2.0}),
    "sampled_ce": ("transe-l2", "pool", {"loss": "sampled_ce", "label_smoothing": 0.1}),
    "ce": ("distmult", None, {"loss": "ce", "label_smoothing": 0.1,
                              "optimizer": "adam", "learning_rate": 0.01}),
}
CKPT = ("pairwise-pool", (2, 2))
RESUME = 1  # epochs trained on from the checkpoint


def dataset():
    return synthetic_kg(48, 4, n_train=330, seed=3)  # batches of 83


def trainer(name, mesh=None, checkpoint_path=None, max_epochs=EPOCHS):
    model_name, sampler_kind, kw = CASES[name]
    ds = dataset()
    n_e, n_r = ds.n_entities, ds.n_relations
    model = {"transe": lambda: skge_torch.TransE(n_e, n_r, 8, dtype="float64"),
             "transe-l2": lambda: skge_torch.TransE(n_e, n_r, 8, l1=False, dtype="float64"),
             "rescal": lambda: skge_torch.RESCAL(n_e, n_r, 6, dtype="float64", rparam=0.01),
             "distmult": lambda: skge_torch.DistMult(n_e, n_r, 8, dtype="float64")}[
        model_name]()
    sampler = {"iid": lambda: skge_torch.RandomModeSampler(n_e),
               "pool": lambda: skge_torch.SharedNegativeSampler(n_e, k=16),
               None: lambda: None}[sampler_kind]()
    cfg = skge_torch.TrainConfig(**{**dict(max_epochs=max_epochs, nbatches=NB, margin=0.3,
                                           seed=11, checkpoint_path=checkpoint_path), **kw})
    return skge_torch.Trainer(model, sampler, cfg, device="cpu", mesh=mesh), ds


def worker(out_dir, shapes):
    from skge_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    distributed.initialize(device="cpu", timeout_s=WORLD_TIMEOUT_S)
    out = {}
    for shape in shapes:
        mesh = make_mesh(shape, device="cpu")
        for name in CASES:
            path = (os.path.join(out_dir, "mesh.npz") if (name, shape) == CKPT else None)
            tr, ds = trainer(name, mesh, path)
            tr.fit(ds.train)
            pre = f"{shape[0]}x{shape[1]}/{name}/"
            for k, v in tr.full_state().params.items():
                out[pre + k] = v.numpy()
            out[pre + "nviol"] = np.asarray([r["nviolations"] for r in tr.metrics.history])
            out[pre + "loss"] = np.asarray([r["loss"] for r in tr.metrics.history])
            if path is not None:  # resume from the file, restored on the CPU
                torch.distributed.barrier()  # rank 0 has written it
                state, _ = skge_torch.load_checkpoint(path, "cpu")
                tr, _ = trainer(name, mesh, max_epochs=EPOCHS + RESUME)
                tr.fit(ds.train, state=state, start_epoch=EPOCHS)
                for k, v in tr.full_state().params.items():
                    out[pre + "resumed/" + k] = v.numpy()
    np.savez(os.path.join(out_dir, f"rank{torch.distributed.get_rank()}.npz"), **out)
    distributed.destroy()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    groups = [((1, 1),), ((2, 2), (4, 1), (1, 4))]
    with ThreadPoolExecutor(len(groups)) as pool:
        futures = []
        for shapes in groups:
            d = tmp / f"world{len(shapes)}"
            d.mkdir()
            argv = [sys.executable, os.path.abspath(__file__), str(d),
                    ",".join(f"{a}x{b}" for a, b in shapes)]
            futures.append((d, pool.submit(distributed.launch_local, argv,
                                           shapes[-1][0] * shapes[-1][1], WORLD_TIMEOUT_S,
                                           store_dir=str(d), env=env)))
        single = {}
        for name in CASES:  # the single-device runs, while the worlds run
            tr, ds = trainer(name)
            tr.fit(ds.train)
            single[name] = ({k: v.numpy() for k, v in tr.state.params.items()},
                            [r["nviolations"] for r in tr.metrics.history],
                            [r["loss"] for r in tr.metrics.history])
        ranks = {}
        for d, fut in futures:
            for rank, (rc, _, err) in enumerate(fut.result()):
                assert rc == 0, f"rank {rank} of {d.name}: {err[-3000:]}"
            ranks[d.name] = [dict(np.load(d / f"rank{r}.npz")) for r in range(len(fut.result()))]
    return single, ranks, tmp


def _ranks(worlds, shape):
    return worlds[1]["world1" if shape == (1, 1) else "world3"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_trainer_matches_single_device(worlds, case, shape):
    params, nviol, loss = worlds[0][case]
    pre = f"{shape[0]}x{shape[1]}/{case}/"
    ranks = _ranks(worlds, shape)
    kw = CASES[case][2]
    if kw.get("pairwise", True) and "loss" not in kw:  # the margin cases
        assert nviol[0] > 0
    for out in ranks:
        np.testing.assert_array_equal(out[pre + "nviol"], nviol)
        np.testing.assert_allclose(out[pre + "loss"], loss, **TOL)
        for k, v in params.items():
            np.testing.assert_allclose(out[pre + k], v, **TOL, err_msg=f"{case} {shape} {k}")
            # every rank ends with the same full tables, bit for bit
            np.testing.assert_array_equal(out[pre + k], ranks[0][pre + k])


def test_mesh_checkpoint_loads_in_both_packages(worlds):
    from skge_tpu.utils.checkpoint import load_checkpoint as jax_load

    name, shape = CKPT
    path = str(worlds[2] / "world3" / "mesh.npz")
    want = _ranks(worlds, shape)[0]
    pre = f"{shape[0]}x{shape[1]}/{name}/"
    state, meta = skge_torch.load_checkpoint(path, "cpu")
    assert meta["epoch"] == EPOCHS and state.step == EPOCHS * NB
    jstate, jmeta = jax_load(path)
    assert jmeta["epoch"] == EPOCHS and int(jstate.step) == EPOCHS * NB
    for k, v in state.params.items():
        assert v.shape == want[pre + k].shape  # the full tables
        np.testing.assert_array_equal(v.numpy(), want[pre + k])
        np.testing.assert_array_equal(np.asarray(jstate.params[k]), want[pre + k])


def test_mesh_trainer_resumes_from_a_restored_checkpoint(worlds):
    name, shape = CKPT
    tr, ds = trainer(name, max_epochs=EPOCHS + RESUME)
    tr.fit(ds.train)
    pre = f"{shape[0]}x{shape[1]}/{name}/resumed/"
    for out in _ranks(worlds, shape):
        for k, v in tr.state.params.items():
            np.testing.assert_allclose(out[pre + k], v.numpy(), **TOL, err_msg=k)


if __name__ == "__main__":
    worker(sys.argv[1], [tuple(int(v) for v in s.split("x")) for s in sys.argv[2].split(",")])
