"""The port's `PartitionedTrainer` against the JAX package's, at P=2 and
P=4, fp64 within 1e-9: two minibatched epochs of the margin trainer (the
dense and the ragged exchange) and of the reciprocal full-CE trainer,
`params()` in original ids, the sharded `evaluate` (ranks equal to JAX's,
and to the port's single-device ranking of the gathered table), the
trainers' checkpoint directories read by the other package, a resumed
run equal to an uninterrupted one, and `save_sharded_checkpoint` /
`load_sharded_checkpoint` across shard counts both ways (JAX at 6 - P
ranks, the port at P).

JAX's draws (each rank's epoch permutation, each step's pool) are
replayed through its key splits into the port. The port's ragged trainer
is held to JAX's dense one (JAX's exchanges agree bit for bit). The port's side is one
gloo world of P processes per P, running this file as a script (torch,
numpy and skge_torch only).
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from skge_torch.data import add_reciprocal_relations, synthetic_kg
from skge_torch.parallel import distributed
from skge_torch.parallel import partitioned as tpart
from skge_torch.training import TrainState
from skge_torch.utils.checkpoint import load_sharded_checkpoint, save_sharded_checkpoint

TOL = dict(rtol=1e-9, atol=1e-11)
WORLD_TIMEOUT_S = 150
DIM, K, NB, EPOCHS, SEED = 8, 16, 3, 2, 7
# name: (model, loss, reciprocal, exchange)
TRAINERS = {
    "margin-dense": ("transe", "margin", False, "dense"),
    "margin-ragged": ("transe", "margin", False, "ragged"),
    "ce-reciprocal": ("distmult", "ce", True, "dense"),
}
CKPT_ROWS, CKPT_RELS = 64, 5  # rows split over 2 and 4 ranks


def dataset(reciprocal):
    ds = synthetic_kg(70, 5, n_train=600, n_test=40, seed=23, clustered=True)
    return add_reciprocal_relations(ds) if reciprocal else ds


def model_of(pkg, name, ds):
    if name == "transe":
        return pkg.TransE(ds.n_entities, ds.n_relations, DIM, dtype="float64")
    return pkg.DistMult(ds.n_entities, ds.n_relations, DIM, dtype="float64")


def trainer_args(name):
    model, loss, recip, exchange = TRAINERS[name]
    kw = dict(margin=0.5, k=K, nbatches=NB, seed=SEED, loss=loss, reciprocal=recip)
    if loss == "ce":
        kw["label_smoothing"] = 0.1
    return model, recip, exchange, kw


def ckpt_state(seed):
    """A full state with Adam slots, from numpy."""
    rng = np.random.default_rng(seed)
    params = {"E": rng.normal(size=(CKPT_ROWS, DIM)), "R": rng.normal(size=(CKPT_RELS, DIM))}
    opt = {k: {"m": rng.normal(size=v.shape), "v": rng.random(v.shape),
               "t": rng.integers(0, 9, v.shape[0]).astype(np.float64)}
           for k, v in params.items()}
    return params, opt


def worker(in_path, out_dir):
    """One rank: the three trainers on JAX's states and draws, the resume
    run, and the checkpoint round trip."""
    import skge_torch

    torch.set_num_threads(1)
    distributed.initialize(device="cpu", timeout_s=WORLD_TIMEOUT_S)
    group = distributed.make_shard_mesh()
    inputs = dict(np.load(in_path, allow_pickle=False))
    me = group.rank
    out = {}
    for name in TRAINERS:
        model_name, recip, exchange, kw = trainer_args(name)
        ds = dataset(recip)
        tr = tpart.PartitionedTrainer(
            model_of(skge_torch, model_name, ds), skge_torch.AdaGrad(lr=0.1), ds.train,
            group, exchange=exchange, **kw)
        full = {k[len(name) + 1:]: v for k, v in inputs.items() if k.startswith(name + "/")}
        params = {k[8:]: torch.as_tensor(v) for k, v in full.items() if k.startswith("params::")}
        opt_state = {k[8:]: {"p2": torch.as_tensor(full[f"opt::{k[8:]}::p2"])}
                     for k in full if k.startswith("params::")}
        tr._state = tpart.shard_state_partitioned(
            TrainState(params, opt_state, torch.Generator(), 0), tr.model, group)
        pools = list(inputs.get(f"{name}/pools", []))
        tr.sampler.pool = lambda gen, pos, mask: torch.as_tensor(pools.pop(0))
        for e in range(EPOCHS):
            m = tr._fit_epoch(perm=torch.as_tensor(inputs[f"{name}/perm{e}"][me]))
            out[f"{name}/loss{e}"] = np.asarray(m["loss"])
            out[f"{name}/nviol{e}"] = np.asarray(m["nviolations"])
        assert not pools
        for k, v in tr.params().items():
            out[f"{name}/params::{k}"] = v
        res = tr.evaluate(ds.test, ds.all_triples(), batch_size=16)
        out[f"{name}/ranks"] = res.ranks
        out[f"{name}/ranks_raw"] = res.ranks_raw
        # the single-device ranking of the gathered table
        full_model = model_of(skge_torch, model_name, ds)
        ev_model = (skge_torch.ReciprocalEvalWrapper(full_model) if recip else full_model)
        ref = skge_torch.evaluate(
            ev_model, {k: torch.as_tensor(v) for k, v in tr.params().items()},
            ds.test, ds.all_triples(), batch_size=16)
        out[f"{name}/ranks_single"] = ref.ranks
        if name == "margin-dense":
            tr.save(os.path.join(out_dir, "port_trainer"))
            jdir = str(inputs["jax_trainer_dir"])
            deadline = time.monotonic() + WORLD_TIMEOUT_S  # JAX writes it meanwhile
            while not os.path.exists(os.path.join(jdir, "manifest.json")):
                assert time.monotonic() < deadline, "no JAX trainer directory"
                time.sleep(0.1)
            back = tpart.PartitionedTrainer(
                model_of(skge_torch, model_name, ds), skge_torch.AdaGrad(lr=0.1),
                ds.train, group, exchange=exchange, **kw).restore(jdir)
            for k, v in back.params().items():
                out[f"restored/params::{k}"] = v
            out["restored/n_metrics"] = np.asarray(len(back.metrics))

    # resume: save after one epoch of the port's own draws, restore, go on
    ds = dataset(False)
    model_name, _, exchange, kw = trainer_args("margin-ragged")

    def fresh():
        return tpart.PartitionedTrainer(
            model_of(skge_torch, model_name, ds), skge_torch.AdaGrad(lr=0.1),
            ds.train, group, exchange=exchange, **kw)

    whole = fresh().fit(1)
    whole.save(os.path.join(out_dir, "resume"))
    whole.fit(1)
    resumed = fresh().restore(os.path.join(out_dir, "resume")).fit(1)
    for k, v in whole.params().items():
        out[f"resume/whole::{k}"] = v
        out[f"resume/resumed::{k}"] = resumed.params()[k]
    out["resume/metrics"] = np.asarray([[m["loss"], m["nviolations"]]
                                        for m in resumed.metrics])
    out["resume/metrics_whole"] = np.asarray([[m["loss"], m["nviolations"]]
                                              for m in whole.metrics])

    # the JAX directory at 6 - P ranks, read at P; changed; written at P
    state, meta = load_sharded_checkpoint(str(inputs["jax_ckpt_dir"]), group,
                                          sharded=("E",))
    out["ckpt/E"] = state.params["E"].numpy()
    out["ckpt/t"] = state.opt_state["E"]["t"].numpy()
    out["ckpt/step"] = np.asarray(state.step)
    out["ckpt/meta"] = np.asarray(json.dumps(meta))
    state = state._replace(
        params={k: 2.0 * v for k, v in state.params.items()}, step=state.step + 1)
    save_sharded_checkpoint(os.path.join(out_dir, "port_ckpt"), state,
                            {"from": "port"}, group=group, sharded=("E",))
    np.savez(os.path.join(out_dir, f"rank{me}.npz"), **out)
    distributed.destroy()


def _jax_inputs(p, tmp):
    """The port's inputs: JAX's trainers' initial states and replayed
    draws, and a JAX checkpoint saved at 6 - P ranks. Returns (inputs,
    {name: JAX trainer}, the checkpoint's (params, opt, mesh))."""
    import jax
    import jax.numpy as jnp

    import skge_tpu
    from skge_tpu.parallel import partitioned as jpart
    from skge_tpu.training import TrainState as JState
    from skge_tpu.utils.checkpoint import save_sharded_checkpoint as jsave

    mesh = jpart.make_shard_mesh(jax.devices()[:p])
    inputs, jtrs = {}, {}
    for name in TRAINERS:
        model_name, recip, exchange, kw = trainer_args(name)
        if name == "margin-ragged":  # JAX's exchanges agree bit for bit
            inputs.update({k.replace("margin-dense/", "margin-ragged/"): v
                           for k, v in inputs.items() if k.startswith("margin-dense/")})
            continue
        ds = dataset(recip)
        jtr = jpart.PartitionedTrainer(
            model_of(skge_tpu, model_name, ds), skge_tpu.AdaGrad(lr=0.1), ds.train,
            mesh, **kw)
        st = jtr._state
        for k, v in st.params.items():
            inputs[f"{name}/params::{k}"] = np.asarray(v)
            inputs[f"{name}/opt::{k}::p2"] = np.asarray(st.opt_state[k]["p2"])
        # replay the key splits of JAX's epoch and steps
        length = jtr._batches.shape[1]
        n_real = len(jtr.new_of_old)
        key, pools = st.key, []
        for e in range(EPOCHS):
            key, pk = jax.random.split(key)
            inputs[f"{name}/perm{e}"] = np.stack([
                np.asarray(jax.random.permutation(jax.random.fold_in(pk, me), length))
                for me in range(p)]).astype(np.int64)
            for _ in range(max(1, min(NB, length))):
                key, sk = jax.random.split(key)
                if kw["loss"] != "ce":
                    u = np.asarray(jax.random.randint(sk, (K,), 0, n_real))
                    pools.append(jtr.new_of_old[u])
        if pools:
            inputs[f"{name}/pools"] = np.stack(pools).astype(np.int64)
        jtrs[name] = (jtr, ds)
    inputs["jax_trainer_dir"] = str(tmp / "jax_trainer")  # `_jax_fit` writes it
    # a JAX checkpoint at the other shard count
    pj = 6 - p
    jmesh = jpart.make_shard_mesh(jax.devices()[:pj])
    params, opt = ckpt_state(p)
    model = skge_tpu.TransE(CKPT_ROWS, CKPT_RELS, DIM, dtype="float64")
    jstate = jpart.shard_state_partitioned(
        JState(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, opt),
               jax.random.PRNGKey(3), jnp.asarray(5, jnp.int32)), model, jmesh)
    jsave(str(tmp / "jax_ckpt"), jstate, meta={"from": "jax"})
    inputs["jax_ckpt_dir"] = str(tmp / "jax_ckpt")
    return inputs, jtrs, (params, opt, jmesh)


def _jax_fit(tmp, jtrs):
    """JAX's trainers fitted, ranked and (margin-dense) saved: {name:
    (metrics, params, ranking)}."""
    ref = {}
    for name, (jtr, ds) in jtrs.items():
        jtr.fit(EPOCHS)
        res = jtr.evaluate(ds.test, ds.all_triples(), batch_size=16)
        ref[name] = (jtr.metrics, jtr.params(), res)
        if name == "margin-dense":
            jtr.save(str(tmp / "jax_trainer"))
            ref["jax_trainer"] = jtr
    ref["margin-ragged"] = ref["margin-dense"]
    return ref


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request, tmp_path_factory):
    p = request.param
    tmp = tmp_path_factory.mktemp(f"partitioned_trainer_p{p}")
    inputs, jtrs, ckpt = _jax_inputs(p, tmp)
    in_path = str(tmp / "inputs.npz")
    np.savez(in_path, **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    with ThreadPoolExecutor(1) as pool:  # the world runs while JAX fits
        world = pool.submit(
            distributed.launch_local,
            [sys.executable, os.path.abspath(__file__), in_path, str(tmp)], p,
            WORLD_TIMEOUT_S, store_dir=str(tmp), env=env)
        ref = _jax_fit(tmp, jtrs)
        procs = world.result()
    ref["ckpt"] = ckpt
    for rank, (rc, _, err) in enumerate(procs):
        assert rc == 0, f"rank {rank} of {p}: {err[-3000:]}"
    return p, tmp, ref, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(p)]


@pytest.mark.parametrize("name", list(TRAINERS))
def test_trainer_epochs_and_params_match_jax(world, name):
    p, _, ref, ranks = world
    metrics, params, _ = ref[name]
    for r in ranks:
        for e in range(EPOCHS):
            np.testing.assert_allclose(r[f"{name}/loss{e}"], metrics[e]["loss"], **TOL)
            assert float(r[f"{name}/nviol{e}"]) == metrics[e]["nviolations"]
        for k, v in params.items():  # every rank gathers the whole table
            np.testing.assert_allclose(r[f"{name}/params::{k}"], v, **TOL, err_msg=k)


@pytest.mark.parametrize("name", list(TRAINERS))
def test_sharded_evaluate_ranks_match_jax(world, name):
    p, _, ref, ranks = world
    res = ref[name][2]
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}/ranks"], res.ranks)
        np.testing.assert_array_equal(r[f"{name}/ranks_raw"], res.ranks_raw)
        np.testing.assert_array_equal(r[f"{name}/ranks_single"], res.ranks)


def test_trainer_checkpoints_cross_packages(world):
    """The port restores JAX's trainer directory; JAX's trainer restores
    the port's."""
    p, tmp, ref, ranks = world
    jtr = ref["jax_trainer"]
    jparams = jtr.params()
    for r in ranks:
        assert int(r["restored/n_metrics"]) == EPOCHS
        for k, v in jparams.items():
            np.testing.assert_array_equal(r[f"restored/params::{k}"], v)
    jmetrics = jtr.metrics
    jtr.restore(str(tmp / "port_trainer"))
    assert [m["nviolations"] for m in jtr.metrics] == [
        m["nviolations"] for m in jmetrics]
    for k, v in jtr.params().items():
        np.testing.assert_array_equal(v, ranks[0][f"margin-dense/params::{k}"])


def test_resume_equals_uninterrupted(world):
    p, _, _, ranks = world
    for r in ranks:
        np.testing.assert_array_equal(r["resume/metrics"], r["resume/metrics_whole"])
        for k in ("E", "R"):
            np.testing.assert_array_equal(r[f"resume/resumed::{k}"], r[f"resume/whole::{k}"])


def test_sharded_checkpoint_across_shard_counts(world):
    """JAX's directory at 6 - P ranks, read by the port at P; the port's,
    written at P, read by JAX at 6 - P."""
    from skge_tpu.utils.checkpoint import load_sharded_checkpoint as jload

    p, tmp, ref, ranks = world
    params, opt, jmesh = ref["ckpt"]
    np.testing.assert_array_equal(np.concatenate([r["ckpt/E"] for r in ranks]), params["E"])
    np.testing.assert_array_equal(np.concatenate([r["ckpt/t"] for r in ranks]),
                                  opt["E"]["t"])
    assert all(int(r["ckpt/step"]) == 5 for r in ranks)
    assert json.loads(str(ranks[0]["ckpt/meta"])) == {"from": "jax"}
    with open(tmp / "port_ckpt" / "manifest.json") as f:
        assert json.load(f)["n_shards"] == p
    state, meta = jload(str(tmp / "port_ckpt"), jmesh)
    assert meta == {"from": "port"} and int(state.step) == 6
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(state.params[k]), 2.0 * v)
        for sn, sv in opt[k].items():
            np.testing.assert_array_equal(np.asarray(state.opt_state[k][sn]), sv)
    assert len(state.params["E"].sharding.device_set) == 6 - p


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])


def _one_rank(device):
    """A group of one on `device`, for placement alone (no collective)."""
    return distributed.ShardGroup(group=None, rank=0, size=1, device=torch.device(device))


def test_shard_state_keeps_the_generator_or_raises():
    """The state's generator is kept, at its position, on its own device
    type; one that has advanced on the CPU is refused on another device
    type instead of being reseeded (which would repeat its draws)."""
    import skge_torch

    model = skge_torch.TransE(CKPT_ROWS, CKPT_RELS, DIM)
    opt = skge_torch.AdaGrad(lr=0.1)
    gen = torch.Generator().manual_seed(SEED)
    state = skge_torch.init_state(model, opt, gen)
    torch.rand(5, generator=gen)  # the generator has moved
    position = gen.get_state()
    placed = tpart.shard_state_partitioned(state, model, _one_rank("cpu"))
    assert placed.generator is gen
    assert torch.equal(placed.generator.get_state(), position)
    with pytest.raises(ValueError, match="load_checkpoint"):
        tpart.shard_state_partitioned(state, model, _one_rank("cuda"))
    with pytest.raises(ValueError, match="load_checkpoint"):
        tpart.shard_state_partitioned(state._replace(generator=None), model,
                                      _one_rank("cpu"))
    given = torch.Generator()
    assert tpart.shard_state_partitioned(state, model, _one_rank("cpu"),
                                         generator=given).generator is given


def test_init_state_partitioned_continues_its_init_generator_on_the_cpu():
    """On the CPU the training draws continue the generator that drew the
    initial params, as `init_state` with a CPU generator seeded `seed`."""
    import skge_torch

    model = skge_torch.TransE(CKPT_ROWS, CKPT_RELS, DIM)
    opt = skge_torch.AdaGrad(lr=0.1)
    want = skge_torch.init_state(model, opt, torch.Generator().manual_seed(SEED))
    got = tpart.init_state_partitioned(model, opt, SEED, _one_rank("cpu"))
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v)
    assert torch.equal(got.generator.get_state(), want.generator.get_state())
