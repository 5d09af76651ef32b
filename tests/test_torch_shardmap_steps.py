"""The port's explicit-SPMD mesh steps (`skge_torch.parallel.shardmap_step`)
against the JAX package's at the mesh shapes (1, 1), (2, 2), (1, 4) and
(4, 1), fp64 within 1e-9: the pairwise margin step on a shared pool and on
iid corruptions (modes 0, 1, 1) for TransE, HolE, ER-MLP (its dense W and
C) and RESCAL (its factored W through the outer-product scatter on the
pool), and with `shard_relations` for RESCAL and TransH (two relation
tables). Three steps each; the last quarter of the batch is masked, so at
(4, 1) one data shard is all padding. Every rank must hold the replicated
tables and its row block bit for bit as the other members of its groups
do, which is what keeps the replicas from drifting.

The harness serves `test_torch_shardmap_losses.py` and
`test_torch_sharded.py` too. The JAX side runs in this process on
`jax.devices()[:4]`. The port's side is two gloo worlds, one process for
(1, 1) and four for the three other shapes in turn (a mesh per shape over
the same world); each runs this file as a script (torch, numpy and
skge_torch only) over the file's cases and writes each rank's tables to an
npz. Both sides start from the same warm numpy state and draw the same
fixed pool, corruptions or expanded pairs, so no random draw is replayed.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from skge_torch.parallel import distributed

TOL = dict(rtol=1e-9, atol=1e-11)
WORLD_TIMEOUT_S = 150
N_E, N_R, DIM, B, K, STEPS, MARGIN = 24, 4, 6, 32, 7, 3, 0.7
SHAPES = [(1, 1), (2, 2), (1, 4), (4, 1)]
IID_MODES = (0, 1, 1)
# name: (route, model, optimizer, sampler, options)
CASES = {
    # the pairwise margin step (this file)
    "transe-pool": ("pairwise", "transe", "adagrad", "pool", {}),
    "transe-iid": ("pairwise", "transe", "adagrad", "iid", {}),
    "hole-pool": ("pairwise", "hole", "adagrad", "pool", {}),
    "hole-iid": ("pairwise", "hole", "adagrad", "iid", {}),
    "ermlp-pool": ("pairwise", "ermlp", "adagrad", "pool", {}),
    "ermlp-iid": ("pairwise", "ermlp", "adagrad", "iid", {}),
    "rescal-pool": ("pairwise", "rescal", "adagrad", "pool", {}),
    "rescal-iid": ("pairwise", "rescal", "adagrad", "iid", {}),
    "rescal-shardrel": ("pairwise", "rescal", "adagrad", "pool", {"shard_relations": True}),
    "transh-shardrel": ("pairwise", "transh", "adagrad", "pool", {"shard_relations": True}),
    # the pool losses and full CE (test_torch_shardmap_losses.py)
    "selfadv-transe": ("selfadv", "transe-l2", "adagrad", "pool", {}),
    "selfadv-ermlp": ("selfadv", "ermlp", "adagrad", "pool", {}),
    "pointwise-transe": ("pointwise", "transe", "adagrad", "pool", {}),
    "pointwise-rescal": ("pointwise", "rescal", "adagrad", "pool", {}),
    "pointwise-ermlp": ("pointwise", "ermlp", "adagrad", "pool", {}),
    "sampled_ce-transe": ("sampled_ce", "transe", "adagrad", "pool", {"ls": 0.0}),
    "sampled_ce-ermlp": ("sampled_ce", "ermlp", "adam", "pool", {"ls": 0.1}),
    "sampled_ce-unigram": ("sampled_ce", "transe-l2", "adagrad", "unigram",
                           {"ls": 0.1, "shard_relations": True}),
    "ce-distmult": ("ce", "distmult", "adagrad", None, {"dirs": ("o", "s"), "ls": 0.0}),
    "ce-transe": ("ce", "transe", "adam", None, {"dirs": ("o",), "ls": 0.1}),
    # the single-device-equal steps of `sharded` (test_torch_sharded.py)
    "sharded-pairwise-transe": ("sharded_pairwise", "transe", "adagrad", "expanded", {}),
    "sharded-pairwise-hole": ("sharded_pairwise", "hole", "adagrad", "expanded", {}),
    "sharded-pairwise-iid": ("sharded_pairwise", "hole", "adagrad", "iid", {}),
    "sharded-pairwise-adam": ("sharded_pairwise", "transe", "adam", "pool", {}),
    "sharded-pointwise-hole": ("sharded_pointwise", "hole", "adagrad", "expanded", {}),
    "sharded-pointwise-ermlp": ("sharded_pointwise", "ermlp", "adagrad", "expanded", {}),
    "sharded-pointwise-pool": ("sharded_pointwise", "rescal", "adagrad", "pool", {}),
    "score_all_o-hole": ("score_all_o", "hole", "adagrad", None, {}),
}
PAIRWISE_NAMES = [n for n, c in CASES.items() if c[0] == "pairwise"]


def model_of(pkg, name):
    kw = dict(dtype="float64")
    if name.startswith("transe"):
        return pkg.TransE(N_E, N_R, DIM, l1=name == "transe", **kw)
    if name == "ermlp":
        return pkg.ERMLP(N_E, N_R, DIM, nhidden=5, **kw)
    if name in ("hole", "rescal"):
        return {"hole": pkg.HolE, "rescal": pkg.RESCAL}[name](N_E, N_R, DIM, rparam=0.01, **kw)
    return {"transh": pkg.TransH, "distmult": pkg.DistMult}[name](N_E, N_R, DIM, **kw)


def opt_of(pkg, name):
    return {"adagrad": lambda: pkg.AdaGrad(lr=0.1), "adam": lambda: pkg.Adam(lr=0.05)}[name]()


def warm_state(seed, model_name, opt):
    """Params and warm optimizer slots from numpy: {key: array}, shaped as
    the port's `init_params`."""
    import skge_torch

    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in
              model_of(skge_torch, model_name).init_params(torch.Generator()).items()}
    out = {f"params::{k}": rng.uniform(-0.5, 0.5, v) for k, v in shapes.items()}
    for name, shape in shapes.items():
        if opt == "adagrad":
            out[f"opt::{name}::p2"] = rng.uniform(0.1, 1.0, shape)
        else:
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


def make_inputs():
    """The shared inputs: the batch, its mask (last quarter masked), the
    pool (with a duplicate), the iid replacements, the expanded pairs, the
    unigram logits and every case's warm state."""
    rng = np.random.default_rng(5)
    batch = np.stack([rng.integers(0, N_E, B), rng.integers(0, N_E, B),
                      rng.integers(0, N_R, B)], axis=1).astype(np.int64)
    mask = (np.arange(B) < 3 * B // 4).astype(np.float64)
    half = np.arange(2 * B) < B  # subjects corrupted, then objects
    neg = np.concatenate([batch, batch])
    neg[half, 0] = rng.integers(0, N_E, B)
    neg[~half, 1] = rng.integers(0, N_E, B)
    inputs = {
        "batch": batch, "mask": mask,
        "pool": np.concatenate([rng.integers(0, N_E, K - 2), [3, 3]]).astype(np.int64),
        "iid": np.stack([rng.integers(0, N_E, B) for _ in IID_MODES]).astype(np.int64),
        "exp_pos": np.concatenate([batch, batch]), "exp_neg": neg,
        "exp_mask": np.concatenate([mask, mask]) * (rng.uniform(size=2 * B) < 0.9),
        "logits": np.log(np.arange(1, N_E + 1, dtype=np.float64)),
    }
    for i, (name, case) in enumerate(CASES.items()):
        for k, v in warm_state(100 + i, case[1], case[2]).items():
            inputs[f"{name}/{k}"] = v
    return inputs


# --- the port's side: run as a script in each process of a world -----------

class FixedPool:
    """A `pool`-protocol sampler handing out one pool (and, with
    `logits`, the unigram proposal's logits)."""

    modes = (0, 1)

    def __init__(self, pool, logits=None):
        self._pool = pool
        self.k = len(pool)
        if logits is not None:
            self.logits = logits

    def pool(self, generator, pos, mask):
        return self._pool


class FixedCorruptions:
    """A `corruptions`-protocol sampler: fixed global replacements."""

    def __init__(self, repl):
        self.repl = repl

    def corruptions(self, generator, pos, mask):
        return [(m, r, mask) for m, r in zip(IID_MODES, self.repl)]


class FixedExpanded:
    """A sampler with only the expanded form: fixed pairs."""

    def __init__(self, pos, neg, pm):
        self.out = (pos, neg, pm)

    def __call__(self, generator, pos, mask):
        return self.out


def sampler_of(kind, x):
    """The case's sampler over `x` (the inputs as tensors or arrays)."""
    if kind in ("pool", "unigram"):
        return FixedPool(x["pool"], x["logits"] if kind == "unigram" else None)
    if kind == "iid":
        return FixedCorruptions(list(x["iid"]))
    if kind == "expanded":
        return FixedExpanded(x["exp_pos"], x["exp_neg"], x["exp_mask"])
    return None


def _port_case(mesh, inputs, name):
    import skge_torch
    from skge_torch.parallel import mesh as tmesh
    from skge_torch.parallel import sharded, shardmap_step as sm
    from skge_torch.training import TrainState

    route, model_name, opt_name, kind, kw = CASES[name]
    model, opt = model_of(skge_torch, model_name), opt_of(skge_torch, opt_name)
    x = {k: torch.as_tensor(v) for k, v in inputs.items() if "/" not in k}
    sampler = sampler_of(kind, x)
    rel = kw.get("shard_relations", False)
    params, opt_state = tree({k.split("/", 1)[1]: v for k, v in inputs.items()
                              if k.startswith(name + "/")}, torch.as_tensor)
    state = sm.shard_state_shardmap(TrainState(params, opt_state, torch.Generator(), 0),
                                    model, mesh, shard_relations=rel)
    out = {}
    if route == "score_all_o":
        score = sharded.make_sharded_score_all_o(model, mesh)
        out["scores"] = score(state.params, x["batch"][:, 0], x["batch"][:, 2]).numpy()
        return out
    step = {
        "pairwise": lambda: sm.make_shardmap_pairwise_step(model, opt, sampler, MARGIN,
                                                           mesh, shard_relations=rel),
        "selfadv": lambda: sm.make_shardmap_selfadv_step(model, opt, sampler, MARGIN, mesh,
                                                         alpha=1.5, shard_relations=rel),
        "pointwise": lambda: sm.make_shardmap_pointwise_step(model, opt, sampler, mesh,
                                                             shard_relations=rel),
        "sampled_ce": lambda: sm.make_shardmap_sampled_ce_step(
            model, opt, sampler, mesh, label_smoothing=kw["ls"], shard_relations=rel),
        "ce": lambda: sm.make_shardmap_ce_step(model, opt, mesh, kw["dirs"], kw["ls"]),
        "sharded_pairwise": lambda: sharded.make_sharded_pairwise_step(
            model, opt, sampler, MARGIN, mesh),
        "sharded_pointwise": lambda: sharded.make_sharded_pointwise_step(
            model, opt, sampler, mesh),
    }[route]()
    for i in range(STEPS):
        state, m = step(state, x["batch"], x["mask"])
        out[f"loss{i}"] = m.loss.numpy()
        out[f"nviol{i}"] = m.nviolations.numpy()
    assert state.step == STEPS
    specs = tmesh.param_specs(model, rel)
    out["sharded"] = np.asarray([k for k, v in specs.items() if v is not None])
    for k, v in state.params.items():
        out[f"params::{k}"] = v.numpy()
    for k, slots in state.opt_state.items():
        for sn, v in slots.items():
            out[f"opt::{k}::{sn}"] = v.numpy()
    return out


def worker(in_path, out_dir, shapes, names):
    """One rank of the port's world: every shape in turn (a mesh over the
    world each), every case; this rank's outputs to an npz."""
    from skge_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    distributed.initialize(device="cpu", timeout_s=WORLD_TIMEOUT_S)
    inputs = dict(np.load(in_path))
    out = {}
    for shape in shapes:
        mesh = make_mesh(shape, device="cpu")
        for name in names:
            for k, v in _port_case(mesh, inputs, name).items():
                out[f"{shape_key(shape)}/{name}/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{torch.distributed.get_rank()}.npz"), **out)
    distributed.destroy()


def shape_key(shape):
    return f"{shape[0]}x{shape[1]}"


# --- the JAX side ----------------------------------------------------------

def _jax_case(jmesh, inputs, name):
    import jax
    import jax.numpy as jnp

    import skge_tpu
    from skge_tpu.parallel import mesh as jm
    from skge_tpu.parallel import sharded as jsh
    from skge_tpu.parallel import shardmap_step as jsm
    from skge_tpu.training import TrainState as JState

    route, model_name, opt_name, kind, kw = CASES[name]
    model, opt = model_of(skge_tpu, model_name), opt_of(skge_tpu, opt_name)
    x = {k: (jnp.asarray(v, jnp.int32) if v.dtype.kind == "i" else jnp.asarray(v))
         for k, v in inputs.items() if "/" not in k}
    x["logits"] = inputs["logits"]
    sampler = sampler_of(kind, x)
    rel = kw.get("shard_relations", False)
    params, opt_state = tree({k.split("/", 1)[1]: v for k, v in inputs.items()
                              if k.startswith(name + "/")}, jnp.asarray)
    state = JState(params, opt_state, jax.random.PRNGKey(0), jnp.zeros((), jnp.int32))
    if route.startswith("sharded") or route == "score_all_o":
        state = jm.shard_state(state, model, jmesh)
    else:
        state = jsm.shard_state_shardmap(state, model, jmesh, shard_relations=rel)
    if route == "score_all_o":
        out = jsh.make_sharded_score_all_o(model, jmesh)(
            state.params, x["batch"][:, 0], x["batch"][:, 2])
        return {"scores": np.asarray(out)}
    step = {
        "pairwise": lambda: jsm.make_shardmap_pairwise_step(model, opt, sampler, MARGIN,
                                                            jmesh, shard_relations=rel),
        "selfadv": lambda: jsm.make_shardmap_selfadv_step(model, opt, sampler, MARGIN,
                                                          jmesh, alpha=1.5,
                                                          shard_relations=rel),
        "pointwise": lambda: jsm.make_shardmap_pointwise_step(model, opt, sampler, jmesh,
                                                              shard_relations=rel),
        "sampled_ce": lambda: jsm.make_shardmap_sampled_ce_step(
            model, opt, sampler, jmesh, label_smoothing=kw["ls"], shard_relations=rel),
        "ce": lambda: jsm.make_shardmap_ce_step(model, opt, jmesh, kw["dirs"], kw["ls"]),
        "sharded_pairwise": lambda: jsh.make_sharded_pairwise_step(model, opt, sampler,
                                                                   MARGIN, jmesh),
        "sharded_pointwise": lambda: jsh.make_sharded_pointwise_step(model, opt, sampler,
                                                                     jmesh),
    }[route]()
    out = {}
    for i in range(STEPS):
        state, m = step(state, x["batch"], x["mask"])
        out[f"loss{i}"] = float(m.loss)
        out[f"nviol{i}"] = float(m.nviolations)
    out["params"] = jax.tree.map(np.asarray, state.params)
    out["opt"] = jax.tree.map(np.asarray, state.opt_state)
    return out


def _jax_reference(inputs, names):
    import jax

    from skge_tpu.parallel.mesh import make_mesh

    ref = {}
    for shape in SHAPES:
        jmesh = make_mesh(jax.devices()[:shape[0] * shape[1]], shape=shape)
        for name in names:
            ref[(shape, name)] = _jax_case(jmesh, inputs, name)
    return ref


def run_worlds(tmp, names):
    """{shape: ({case: JAX's reference}, [the port's per-rank outputs])}:
    the cases `names` in a world of one at (1, 1) and a world of four at
    the other shapes, the files under `tmp`."""
    inputs = make_inputs()
    in_path = str(tmp / "inputs.npz")
    np.savez(in_path, **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    here = os.path.abspath(__file__)  # this harness, whichever file runs it
    worlds = [((1, 1),), ((2, 2), (1, 4), (4, 1))]
    with ThreadPoolExecutor(len(worlds)) as pool:  # the worlds run while JAX does
        futures = []
        for shapes in worlds:
            d = tmp / f"world{len(shapes)}"
            d.mkdir()
            argv = [sys.executable, here, in_path, str(d),
                    ",".join(shape_key(s) for s in shapes), *names]
            futures.append((shapes, d, pool.submit(
                distributed.launch_local, argv, shapes[-1][0] * shapes[-1][1],
                WORLD_TIMEOUT_S, store_dir=str(d), env=env)))
        ref = _jax_reference(inputs, names)
        out = {}
        for shapes, d, fut in futures:
            procs = fut.result()
            for rank, (rc, _, err) in enumerate(procs):
                assert rc == 0, f"rank {rank} of {shapes}: {err[-3000:]}"
            ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(len(procs))]
            for shape in shapes:
                p = f"{shape_key(shape)}/"
                out[shape] = ({n: ref[(shape, n)] for n in names},
                              [{k[len(p):]: v for k, v in r.items() if k.startswith(p)}
                               for r in ranks])
    return out


def check_case(worlds, shape, name):
    """The case's metrics, tables and optimizer slots on every rank against
    JAX's at the shape; the row blocks and replicated leaves bit-equal
    across the ranks that share them."""
    refs, ranks = worlds[shape]
    ref = refs[name]
    d_size, m_size = shape
    pre = name + "/"
    if CASES[name][0] == "score_all_o":  # (B/D, n_e) rows per data rank
        got = np.concatenate([ranks[d * m_size][pre + "scores"] for d in range(d_size)])
        np.testing.assert_allclose(got, ref["scores"], **TOL)
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(out[pre + "scores"],
                                          ranks[(r // m_size) * m_size][pre + "scores"])
        return
    for i in range(STEPS):
        for out in ranks:  # every rank reports the global metrics
            np.testing.assert_allclose(out[f"{pre}loss{i}"], ref[f"loss{i}"], **TOL,
                                       err_msg=f"{name} {shape} loss {i}")
            assert float(out[f"{pre}nviol{i}"]) == ref[f"nviol{i}"], (name, shape, i)
    sharded = set(str(s) for s in ranks[0][pre + "sharded"])
    leaves = [(f"params::{k}", k, v) for k, v in ref["params"].items()]
    leaves += [(f"opt::{k}::{sn}", k, v) for k, slots in ref["opt"].items()
               for sn, v in slots.items()]
    for key, pname, want in leaves:
        if pname in sharded:
            got = np.concatenate([ranks[m][pre + key] for m in range(m_size)])
        else:
            got = ranks[0][pre + key]
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"{name} {shape} {key}")
        for r, out in enumerate(ranks):
            twin = r % m_size if pname in sharded else 0
            np.testing.assert_array_equal(out[pre + key], ranks[twin][pre + key],
                                          err_msg=f"{name} {shape} {key}: rank {r}")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("shardmap_steps"), PAIRWISE_NAMES)


@pytest.mark.parametrize("shape", SHAPES, ids=shape_key)
@pytest.mark.parametrize("case", PAIRWISE_NAMES)
def test_pairwise_step_matches_jax(worlds, case, shape):
    assert worlds[shape][0][case]["nviol0"] > 0, "a margin case without violations"
    check_case(worlds, shape, case)


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2],
           [tuple(int(v) for v in s.split("x")) for s in sys.argv[3].split(",")],
           sys.argv[4:])
