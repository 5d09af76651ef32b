"""The port's partitioned margin step against the JAX package's, at P=2
and P=4, fp64 within 1e-9: TransE L1 and L2, HolE and ER-MLP (its dense W
and C) on a shared pool, each through the four gradient exchanges (dense,
ragged, emulate and no cap), and TransE L1 on iid corruptions (each rank
its own). `debug_checks` warns when a cap is short, and only then.
`test_torch_partitioned_losses.py` holds the other losses on the same
harness.

The JAX side runs in this process on `jax.devices()[:P]`. The port's side
is one gloo world of P processes per P and test file, which runs this file
as a script (it then imports only torch, numpy and skge_torch) over the
file's cases and writes each rank's tables to an npz. Both start from the
same warm state, built from numpy, and draw the same fixed pool, so no
random draw needs replaying. The ragged and emulated exchanges must also
equal the dense one bit for bit, as in the JAX package.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from skge_torch.data import greedy_entity_partition, partition_edges, synthetic_kg
from skge_torch.parallel import distributed
from skge_torch.parallel import partitioned as tpart
from skge_torch.training import TrainState

TOL = dict(rtol=1e-9, atol=1e-11)
WORLD_TIMEOUT_S = 150
DIM, MARGIN, K, STEPS = 8, 0.7, 7, 2
EXCHANGES = ("dense", "ragged", "emulate", "nocap")
# name: (model, optimizer, loss, directions, label smoothing)
CASES = {
    "transe-l1": ("transe-l1", "adagrad", "margin", None, 0.0),
    "transe-l2": ("transe-l2", "sgd", "margin", None, 0.0),
    "hole": ("hole", "adagrad", "margin", None, 0.0),
    "ermlp": ("ermlp", "adagrad", "margin", None, 0.0),  # dense W and C
    "selfadv": ("transe-l2", "adagrad", "selfadv", None, 0.0),
    "sampled_ce": ("distmult", "adam", "sampled_ce", ("o", "s"), 0.1),
}
CE_CASES = {"ce-both": (("o", "s"), 0.0), "ce-objects": (("o",), 0.1)}
IID = "transe-l1-iid"  # the margin step on iid corruptions, modes 0, 1, 1
NAMES = list(CASES) + list(CE_CASES) + [IID]
MARGIN_NAMES = ["transe-l1", "transe-l2", "hole", "ermlp", IID]  # this file's
LOSS_NAMES = ["selfadv", "sampled_ce"] + list(CE_CASES)  # the losses file's


def graph(p):
    """The relabeled partitioned graph of a world of p ranks."""
    ds = synthetic_kg(61, 5, n_train=400, seed=7, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, p)
    rel, _, n_pad = tpart.relabel_entities(ds.train, part, p)
    s = n_pad // p
    batches, mask, _ = partition_edges(rel, (np.arange(n_pad) // s).astype(np.int32), p)
    return ds.n_relations, n_pad, batches, mask


def model_of(pkg, name, n_pad, n_rel):
    kw = dict(dtype="float64")
    if name.startswith("transe"):
        return pkg.TransE(n_pad, n_rel, DIM, l1=name == "transe-l1", **kw)
    if name == "ermlp":
        return pkg.ERMLP(n_pad, n_rel, DIM, nhidden=5, **kw)
    return {"hole": pkg.HolE, "distmult": pkg.DistMult}[name](n_pad, n_rel, DIM, **kw)


def opt_of(pkg, name):
    return {"adagrad": lambda: pkg.AdaGrad(lr=0.1), "sgd": lambda: pkg.SGD(lr=0.05),
            "adam": lambda: pkg.Adam(lr=0.05)}[name]()


def warm_state(seed, n_pad, n_rel, model, opt):
    """Params and warm optimizer slots from numpy: {key: array}."""
    rng = np.random.default_rng(seed)
    shapes = {"E": (n_pad, DIM), "R": (n_rel, DIM)}
    if model == "ermlp":
        shapes.update(W=(3 * DIM, 5), C=(5,))
    out = {f"params::{k}": rng.uniform(-0.5, 0.5, v) for k, v in shapes.items()}
    for name, shape in shapes.items():
        if opt == "adagrad":
            out[f"opt::{name}::p2"] = rng.uniform(0.1, 1.0, shape)
        elif opt == "adam":
            out[f"opt::{name}::m"] = rng.uniform(-0.1, 0.1, shape)
            out[f"opt::{name}::v"] = rng.uniform(0.01, 0.1, shape)
            out[f"opt::{name}::t"] = rng.integers(0, 4, shape[0]).astype(np.float64)
    return out


def tree(flat, conv):
    params, opt = {}, {}
    for k, v in flat.items():
        parts = k.split("::")
        if parts[0] == "params":
            params[parts[1]] = conv(v)
        else:
            opt.setdefault(parts[1], {})[parts[2]] = conv(v)
    for name in params:
        opt.setdefault(name, {})
    return params, opt


class FixedCorruptions:
    """A `corruptions`-protocol sampler of the port handing out this
    rank's rows of fixed (P, L) replacement tables."""

    def __init__(self, repl, rank):
        self.corr = [(m, torch.as_tensor(r[rank])) for m, r in repl]

    def corruptions(self, generator, pos, mask):
        return [(m, r, mask) for m, r in self.corr]


def _corruption_tables(inputs):
    return [(int(m), inputs[f"iid/repl{i}"]) for i, m in enumerate(inputs["iid/modes"])]


class FixedPool:
    """A `pool`-protocol sampler of the port handing out one pool."""

    modes = (0, 1)

    def __init__(self, pool):
        self._pool = torch.as_tensor(pool)
        self.k = len(pool)

    def pool(self, generator, pos, mask):
        return self._pool


def _port_case(group, inputs, name, exchange, n_rel, n_pad, batch, mask):
    import skge_torch

    model_name, opt_name, loss, directions, ls = _case(name)
    model = model_of(skge_torch, model_name, n_pad, n_rel)
    opt = opt_of(skge_torch, opt_name)
    flat = {k.split("/", 1)[1]: v for k, v in inputs.items() if k.startswith(name + "/")}
    params, opt_state = tree(flat, torch.as_tensor)
    state = tpart.shard_state_partitioned(
        TrainState(params, opt_state, torch.Generator(), 0), model, group)
    sampler = (FixedCorruptions(_corruption_tables(inputs), group.rank) if name == IID
               else FixedPool(inputs["pool"]))
    cap = None if exchange == "nocap" else int(inputs["cap"])
    ragged = {"dense": False, "ragged": True, "emulate": "emulate", "nocap": False}[exchange]
    if loss == "ce":
        step = tpart.make_partitioned_ce_step(model, opt, group, directions, ls)
    elif loss == "margin":
        step = tpart.make_partitioned_pairwise_step(
            model, opt, sampler, MARGIN, group, boundary_cap=cap, ragged=ragged)
    elif loss == "selfadv":
        step = tpart.make_partitioned_selfadv_step(
            model, opt, sampler, MARGIN, group, alpha=1.5, boundary_cap=cap,
            ragged=ragged)
    else:
        step = tpart.make_partitioned_sampled_ce_step(
            model, opt, sampler, group, directions, ls, boundary_cap=cap, ragged=ragged)
    out = {}
    for i in range(STEPS):
        state, m = step(state, batch, mask)
        out[f"loss{i}"] = m.loss.numpy()
        out[f"nviol{i}"] = m.nviolations.numpy()
    for k, v in state.params.items():
        out[f"params::{k}"] = v.numpy()
    for k, slots in state.opt_state.items():
        for sn, v in slots.items():
            out[f"opt::{k}::{sn}"] = v.numpy()
    assert state.step == STEPS
    return out


def _case(name):
    """(model, optimizer, loss, directions, label smoothing) of a case."""
    if name in CE_CASES:
        return ("distmult", "adagrad", "ce") + CE_CASES[name]
    if name == IID:
        return ("transe-l1", "adagrad", "margin", None, 0.0)
    return CASES[name]


def _exchanges(name):
    return EXCHANGES if name in CASES else ("nocap",) if name == IID else ("dense",)


def _cap_warnings(group, inputs, n_rel, n_pad, batch, mask):
    """Whether `debug_checks` warned with a cap of 1 and with the exact cap."""
    import warnings

    import skge_torch

    out = {}
    for cap in (1, int(inputs["cap"])):
        model = model_of(skge_torch, "transe-l1", n_pad, n_rel)
        params, opt_state = tree({k.split("/", 1)[1]: v for k, v in inputs.items()
                                  if k.startswith("transe-l1/")}, torch.as_tensor)
        state = tpart.shard_state_partitioned(
            TrainState(params, opt_state, torch.Generator(), 0), model, group)
        step = tpart.make_partitioned_pairwise_step(
            model, skge_torch.AdaGrad(lr=0.1), FixedPool(inputs["pool"]), MARGIN, group,
            boundary_cap=cap, debug_checks=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(state, batch, mask)
        out[f"warned{cap == 1}"] = np.asarray(
            any("DROPPED" in str(w.message) for w in caught))
    return out


def worker(in_path, out_dir, names):
    """One rank of the port's world: the cases `names`, this rank's tables."""
    torch.set_num_threads(1)
    distributed.initialize(device="cpu", timeout_s=WORLD_TIMEOUT_S)
    group = distributed.make_shard_mesh()
    inputs = dict(np.load(in_path))
    n_rel, n_pad = int(inputs["n_rel"]), int(inputs["n_pad"])
    batch = torch.as_tensor(inputs["batches"][group.rank], dtype=torch.int64)
    mask = torch.as_tensor(inputs["mask"][group.rank], dtype=torch.float64)
    out = {}
    for name in names:
        for exchange in _exchanges(name):
            got = _port_case(group, inputs, name, exchange, n_rel, n_pad, batch, mask)
            out.update({f"{name}/{exchange}/{k}": v for k, v in got.items()})
    if "transe-l1" in names:
        out.update(_cap_warnings(group, inputs, n_rel, n_pad, batch, mask))
    np.savez(os.path.join(out_dir, f"rank{group.rank}.npz"), **out)
    distributed.destroy()


def _jax_reference(p, inputs, names):
    """Run the cases' JAX partitioned steps; {case: (params, opt, losses,
    violations)} with full tables."""
    import jax
    import jax.numpy as jnp

    import skge_tpu
    from skge_tpu.parallel import partitioned as jpart
    from skge_tpu.training import TrainState as JState

    class JCorruptions:  # this shard's row of the (P, L) tables
        def __init__(self, repl):
            self.repl = [(m, jnp.asarray(r)) for m, r in repl]

        def corruptions(self, key, pos, mask):
            me = jax.lax.axis_index(jpart.SHARD_AXIS)
            return [(m, r[me], mask) for m, r in self.repl]

    class JPool:
        modes = (0, 1)

        def __init__(self, pool):
            self._pool = jnp.asarray(pool, jnp.int32)
            self.k = len(pool)

        def pool(self, key, pos, mask):
            return self._pool

    n_rel, n_pad = int(inputs["n_rel"]), int(inputs["n_pad"])
    mesh = jpart.make_shard_mesh(jax.devices()[:p])
    batches = jnp.asarray(inputs["batches"])
    mask = jnp.asarray(inputs["mask"], jnp.float64)
    sampler = JPool(inputs["pool"])
    cap = int(inputs["cap"])
    ref = {}
    for name in names:
        model_name, opt_name, loss, directions, ls = _case(name)
        model = model_of(skge_tpu, model_name, n_pad, n_rel)
        opt = opt_of(skge_tpu, opt_name)
        flat = {k.split("/", 1)[1]: v for k, v in inputs.items() if k.startswith(name + "/")}
        params, opt_state = tree(flat, jnp.asarray)
        state = jpart.shard_state_partitioned(
            JState(params, opt_state, jax.random.PRNGKey(0), jnp.zeros((), jnp.int32)),
            model, mesh)
        if loss == "ce":
            step = jpart.make_partitioned_ce_step(model, opt, mesh, directions, ls)
        elif name == IID:
            step = jpart.make_partitioned_pairwise_step(
                model, opt, JCorruptions(_corruption_tables(inputs)), MARGIN, mesh)
        elif loss == "margin":
            step = jpart.make_partitioned_pairwise_step(
                model, opt, sampler, MARGIN, mesh, boundary_cap=cap)
        elif loss == "selfadv":
            step = jpart.make_partitioned_selfadv_step(
                model, opt, sampler, MARGIN, mesh, alpha=1.5, boundary_cap=cap)
        else:
            step = jpart.make_partitioned_sampled_ce_step(
                model, opt, sampler, mesh, directions, ls, boundary_cap=cap)
        losses, viols = [], []
        for _ in range(STEPS):
            state, m = step(state, batches, mask)
            losses.append(float(m.loss))
            viols.append(float(m.nviolations))
        ref[name] = (jax.tree.map(np.asarray, state.params),
                     jax.tree.map(np.asarray, state.opt_state), losses, viols)
    return ref


def run_world(p, tmp, names):
    """(P, JAX's reference, the port's per-rank outputs) of the cases
    `names` in one world of p ranks, its files under `tmp`."""
    n_rel, n_pad, batches, mask = graph(p)
    s = n_pad // p
    rng = np.random.default_rng(17)
    inputs = {"n_rel": n_rel, "n_pad": n_pad, "batches": batches, "mask": mask,
              "pool": rng.integers(0, n_pad, K).astype(np.int64),
              # the exact cap, and surplus slots that must not double-count
              "cap": tpart.object_boundary_cap(batches, s) + 2}
    assert inputs["cap"] > 2, "the graph must have non-local objects"
    for name in names:
        seed = 100 + NAMES.index(name)
        for k, v in warm_state(seed, n_pad, n_rel, *_case(name)[:2]).items():
            inputs[f"{name}/{k}"] = v
    inputs["iid/modes"] = np.asarray([0, 1, 1])
    for i in range(3):  # uniform replacements: mostly other ranks' rows
        inputs[f"iid/repl{i}"] = rng.integers(0, n_pad, batches.shape[:2]).astype(np.int64)
    in_path = str(tmp / "inputs.npz")
    np.savez(in_path, **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    with ThreadPoolExecutor(1) as pool:  # the world runs while JAX does
        world = pool.submit(
            distributed.launch_local,
            [sys.executable, os.path.abspath(__file__), in_path, str(tmp), *names], p,
            WORLD_TIMEOUT_S, store_dir=str(tmp), env=env)
        ref = _jax_reference(p, inputs, names)
        procs = world.result()
    for rank, (rc, _, err) in enumerate(procs):
        assert rc == 0, f"rank {rank} of {p}: {err[-3000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(p)]
    return p, ref, ranks


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request, tmp_path_factory):
    p = request.param
    return run_world(p, tmp_path_factory.mktemp(f"partitioned_steps_p{p}"), MARGIN_NAMES)


def _full(ranks, key, sharded):
    return (np.concatenate([r[key] for r in ranks]) if sharded else ranks[0][key])


def _check(ranks, ref, prefix):
    params, opt_state, losses, viols = ref
    for i in range(STEPS):
        for r in ranks:  # every rank reports the summed metrics
            np.testing.assert_allclose(r[f"{prefix}/loss{i}"], losses[i], **TOL)
            assert float(r[f"{prefix}/nviol{i}"]) == viols[i]
    for k, v in params.items():
        np.testing.assert_allclose(_full(ranks, f"{prefix}/params::{k}", k == "E"), v,
                                   **TOL, err_msg=f"{prefix} {k}")
    for k, slots in opt_state.items():
        for sn, v in slots.items():
            np.testing.assert_allclose(_full(ranks, f"{prefix}/opt::{k}::{sn}", k == "E"),
                                       v, **TOL, err_msg=f"{prefix} {k} {sn}")


def check_exchange(world, case, exchange):
    """The case's tables and metrics through `exchange` against JAX's; the
    ragged and emulated exchanges also bit-equal to the dense one."""
    p, ref, ranks = world
    _check(ranks, ref[case], f"{case}/{exchange}")
    if exchange in ("ragged", "emulate"):  # the same scatter order as dense
        for r in ranks:
            for k, v in r.items():
                if k.startswith(f"{case}/dense/"):
                    np.testing.assert_array_equal(
                        r[k.replace("/dense/", f"/{exchange}/")], v, err_msg=k)


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("case", [n for n in MARGIN_NAMES if n in CASES])
def test_step_matches_jax(world, case, exchange):
    p, ref, ranks = world
    assert ref[case][3][0] > 0, "a margin case without violations tests little"
    check_exchange(world, case, exchange)


def test_iid_step_matches_jax(world):
    p, ref, ranks = world
    assert ref[IID][3][0] > 0
    _check(ranks, ref[IID], f"{IID}/nocap")


def test_debug_checks_warn_when_the_cap_is_short(world):
    p, _, ranks = world
    assert any(bool(r["warnedTrue"]) for r in ranks)
    assert not any(bool(r["warnedFalse"]) for r in ranks)


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2], sys.argv[3:])
