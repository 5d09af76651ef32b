"""The port's boundary-exchange choice (`choose_exchange`,
`PartitionedTrainer(exchange='auto')`) against the JAX package's.

With JAX's module constants as the port's `ExchangeCosts` (one cycle taken
as the unit of time), the port's choice equals JAX's and its `_s` numbers
equal JAX's `_cycles` after JAX's `round`: on every assertion of
tests/test_exchange_auto.py's cost-model tests and on a seeded sweep of
256 configurations. In gloo worlds of P=2 and P=4 on that file's `_toy`
triples, `stats['exchange']` of the margin, sampled-CE and reciprocal
sampled-CE trainers equals JAX's trainer's on a mesh of P devices, and each
'auto' trainer trains one epoch to a finite loss; an 'auto' trainer that
chooses ragged (a slow link) trains as the dense one, bit for bit in fp64;
`exchange` and the legacy `ragged` are exclusive, and 'auto' without costs
raises. The port's side is one world of P processes per P, running this
file as a script (torch, numpy and skge_torch only). JAX's calibration
against compiled TPU HLO stays JAX-only.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from skge_torch.data import Dataset, add_reciprocal_relations
from skge_torch.parallel import distributed
from skge_torch.parallel import partitioned as tpart

WORLD_TIMEOUT_S = 150
N_E, N_R, DIM, K, NB = 4000, 8, 16, 64, 10
# name: (loss, reciprocal), as in tests/test_exchange_auto.py
TRAINERS = {
    "margin": ("margin", False),
    "sampled_ce": ("sampled_ce", False),
    "sampled_ce-reciprocal": ("sampled_ce", True),
}


def jax_costs():
    """JAX's TPU constants as the port's costs: cycles for seconds."""
    from skge_tpu.parallel import partitioned as jpart

    return tpart.ExchangeCosts(
        link_bytes_per_s=jpart.ICI_BYTES_PER_CYCLE,
        fp32_flops_per_s=jpart.FLOPS_PER_CYCLE_F32,
        ragged_latency_s=jpart.RAGGED_LATENCY_CYCLES,
        compute_fudge=jpart.COMPUTE_FUDGE,
        overlap_eff=jpart.OVERLAP_EFF,
        hide_saturation_s=jpart.SCHED_HIDE_SAT_CYCLES,
    )


def as_cycles(report):
    """The port's report in JAX's form: each `_s` key as `_cycles`,
    rounded as JAX rounds it."""
    return {(k[:-2] + "_cycles" if k.endswith("_s") else k):
            (round(v) if k.endswith("_s") else v) for k, v in report.items()}


def both(**kw):
    """The port's (choice, report) at JAX's constants, held to JAX's."""
    from skge_tpu.parallel.partitioned import choose_exchange

    want_c, want_r = choose_exchange(**kw)
    c, r = tpart.choose_exchange(costs=jax_costs(), **kw)
    assert (c, as_cycles(r)) == (want_c, want_r), kw
    return c, r


def test_cost_model_crossover():
    c, r = both(d=64, cap=256, k=512, batch_per_shard=2048, p=8)
    assert c == "dense", r
    assert r["exposed_dense_s"] == 0
    c, r = both(d=64, cap=2048, k=512, batch_per_shard=2048, p=8)
    assert c == "ragged", r
    assert r["exposed_ragged_s"] < r["exposed_dense_s"]
    c, r = both(d=128, cap=256, k=8192, batch_per_shard=2048, p=8)
    assert c == "ragged", r
    prev = 0.0
    for cap in (256, 512, 1024, 2048):
        _, r = both(d=64, cap=cap, k=512, batch_per_shard=2048, p=8)
        assert r["exposed_dense_s"] >= prev
        prev = r["exposed_dense_s"]
    _, r1 = both(d=64, cap=4096, k=512, batch_per_shard=2048, p=8)
    _, r2 = both(d=64, cap=65536, k=512, batch_per_shard=2048, p=8)
    assert r1 == r2


def test_cost_model_sampled_ce_modes():
    _, r2 = both(d=64, cap=1024, k=8192, batch_per_shard=2048, p=8, n_modes=2)
    _, r1 = both(d=64, cap=1024, k=8192, batch_per_shard=2048, p=8, n_modes=1)
    assert r1["dense_bytes"] == r2["dense_bytes"]
    assert r1["ragged_bytes"] == r2["ragged_bytes"]
    assert r1["hideable_compute_s"] <= r2["hideable_compute_s"]
    assert r1["exposed_dense_s"] >= r2["exposed_dense_s"]
    assert r1["n_modes"] == 1 and r2["n_modes"] == 2
    c2, _ = both(d=32, cap=256, k=512, batch_per_shard=1024, p=8, n_modes=2)
    c1, _ = both(d=32, cap=256, k=512, batch_per_shard=1024, p=8, n_modes=1)
    assert (c2, c1) == ("dense", "ragged")


@pytest.mark.parametrize("n_modes", [1, 2])
def test_cost_model_sweep_equals_jax(n_modes):
    """128 log-uniform draws of (d, cap, k, batch, p) a mode count: the
    same choice and report as JAX's, both choices among them."""
    rng = np.random.default_rng(11 + n_modes)

    def draw(lo, hi):
        return int(np.exp(rng.uniform(np.log(lo), np.log(hi))))

    choices = set()
    for _ in range(128):
        c, _ = both(d=draw(1, 1024), cap=draw(1, 1 << 17), k=draw(1, 1 << 15),
                    batch_per_shard=draw(1, 1 << 16),
                    p=int(rng.choice([1, 2, 3, 4, 8, 16, 64, 256])), n_modes=n_modes)
        choices.add(c)
    assert choices == {"dense", "ragged"}


def test_costs_without_a_link_rate_and_with_defaults():
    """The link rate has no default; the pool-dot rate and the ragged
    latency default to positive card readings; no overlap by default."""
    with pytest.raises(TypeError):
        tpart.ExchangeCosts()
    c = tpart.ExchangeCosts(link_bytes_per_s=1e11)
    assert c.fp32_flops_per_s > 0 and c.ragged_latency_s > 0
    assert (c.overlap_eff, c.compute_fudge, c.hide_saturation_s) == (0.0, 1.0, np.inf)
    # at P=1 the byte terms agree and ragged adds its latency: dense at any rate
    for rate in (1e9, 1e11, 1e13):
        choice, r = tpart.choose_exchange(150, 1, 1024, 4832, 1,
                                          tpart.ExchangeCosts(link_bytes_per_s=rate))
        assert choice == "dense" and r["dense_bytes"] == r["ragged_bytes"]
        assert r["hideable_compute_s"] == 0.0


def _toy(n_e=N_E, n_r=N_R, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(0, n_e, n), rng.integers(0, n_e, n),
        rng.integers(0, n_r, n),
    ], axis=1).astype(np.int32)


def triples_of(reciprocal):
    t = _toy()
    if not reciprocal:
        return t, N_R
    aug = add_reciprocal_relations(Dataset(train=t, valid=t[:0], test=t[:0],
                                           n_entities=N_E, n_relations=N_R))
    return aug.train, 2 * N_R


def worker(in_path, out_path):
    """One rank: the three 'auto' trainers' stats and one epoch each; an
    'auto' trainer on a slow link against a dense one; the refusals."""
    from skge_torch import AdaGrad, TransE

    torch.set_num_threads(1)
    distributed.initialize(device="cpu", timeout_s=WORLD_TIMEOUT_S)
    group = distributed.make_shard_mesh()
    costs = tpart.ExchangeCosts(**json.load(open(in_path)))
    out = {}
    for name, (loss, recip) in TRAINERS.items():
        t, n_r = triples_of(recip)
        tr = tpart.PartitionedTrainer(TransE(N_E, n_r, DIM), AdaGrad(lr=0.1), t, group,
                                      k=K, nbatches=NB, loss=loss, reciprocal=recip,
                                      exchange="auto", exchange_costs=costs)
        tr.fit(1)
        out[name] = {"stats": tr.stats["exchange"], "exchange": tr.exchange,
                     "loss": tr.metrics[-1]["loss"]}
    # a link of one byte a second and no latency: ragged's P-fold fewer bytes win
    params = {}
    for exchange, kw in (("auto", dict(exchange_costs=tpart.ExchangeCosts(
            link_bytes_per_s=1.0, ragged_latency_s=0.0))), ("dense", {})):
        tr = tpart.PartitionedTrainer(TransE(N_E, N_R, DIM, dtype="float64"),
                                      AdaGrad(lr=0.1), _toy(seed=3), group, k=K,
                                      nbatches=NB, exchange=exchange, **kw)
        tr.fit(1)
        params[exchange] = tr.params()
        out[f"slow-{exchange}"] = {"exchange": tr.exchange,
                                   "choice": tr.stats.get("exchange", {}).get("choice")}
    out["slow-equal"] = all(np.array_equal(params["auto"][k], params["dense"][k])
                            for k in params["dense"])
    refusals = []
    for kw in (dict(exchange="dense", ragged="emulate"), dict(exchange="auto", ragged=True),
               dict(exchange="auto")):
        try:
            tpart.PartitionedTrainer(TransE(N_E, N_R, DIM), AdaGrad(lr=0.1), _toy(), group,
                                     k=K, nbatches=NB, **kw)
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    out["refusals"] = refusals
    out["legacy"] = {str(r): tpart.PartitionedTrainer(
        TransE(N_E, N_R, DIM), AdaGrad(lr=0.1), _toy(), group, k=K, nbatches=NB,
        ragged=r).exchange for r in (False, True, "emulate")}
    with open(f"{out_path}.rank{group.rank}", "w") as f:
        json.dump(out, f)
    distributed.destroy()


def _jax_stats(p):
    """JAX's trainers' `stats['exchange']` on a mesh of p devices."""
    import jax
    from jax.sharding import Mesh

    from skge_tpu import AdaGrad, TransE
    from skge_tpu.parallel.partitioned import SHARD_AXIS, PartitionedTrainer

    mesh = Mesh(np.asarray(jax.devices()[:p]), (SHARD_AXIS,))
    out = {}
    for name, (loss, recip) in TRAINERS.items():
        t, n_r = triples_of(recip)
        tr = PartitionedTrainer(TransE(N_E, n_r, DIM), AdaGrad(lr=0.1), t, mesh, k=K,
                                nbatches=NB, loss=loss, reciprocal=recip, exchange="auto")
        out[name] = tr.stats["exchange"]
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request, tmp_path_factory):
    p = request.param
    tmp = tmp_path_factory.mktemp(f"exchange_auto_p{p}")
    in_path = str(tmp / "costs.json")
    c = jax_costs()
    with open(in_path, "w") as f:
        json.dump({k: getattr(c, k) for k in c.__dataclass_fields__}, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    with ThreadPoolExecutor(1) as pool:  # the world runs while JAX builds
        fut = pool.submit(distributed.launch_local,
                          [sys.executable, os.path.abspath(__file__), in_path,
                           str(tmp / "out")], p, WORLD_TIMEOUT_S, store_dir=str(tmp),
                          env=env)
        ref = _jax_stats(p)
        procs = fut.result()
    for rank, (rc, _, err) in enumerate(procs):
        assert rc == 0, f"rank {rank} of {p}: {err[-3000:]}"
    ranks = [json.load(open(tmp / f"out.rank{r}")) for r in range(p)]
    return p, ref, ranks


@pytest.mark.parametrize("name", list(TRAINERS))
def test_trainer_auto_stats_equal_jax_and_train(world, name):
    p, ref, ranks = world
    assert ref[name]["n_modes"] == (1 if name.endswith("reciprocal") else 2)
    for r in ranks:
        got = r[name]
        assert as_cycles(got["stats"]) == ref[name], (p, name)
        assert got["exchange"] == ref[name]["choice"]
        assert np.isfinite(got["loss"])


def test_auto_on_a_slow_link_chooses_ragged_and_trains_as_dense(world):
    _, _, ranks = world
    for r in ranks:
        assert r["slow-auto"] == {"exchange": "ragged", "choice": "ragged"}
        assert r["slow-dense"] == {"exchange": "dense", "choice": None}
        assert r["slow-equal"]


def test_exchange_and_legacy_ragged_are_exclusive_and_auto_needs_costs(world):
    _, _, ranks = world
    for r in ranks:
        both_, auto_ragged, no_costs = r["refusals"]
        assert "either `exchange` or legacy `ragged`" in both_
        assert "either `exchange` or legacy `ragged`" in auto_ragged
        assert "link rate between cards" in no_costs
        assert r["legacy"] == {"False": "dense", "True": "ragged", "emulate": "emulate"}


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
