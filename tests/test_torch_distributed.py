"""`skge_torch.parallel.distributed`'s bootstrap and the `gather=` hooks of
the four gradient functions the partitioned step calls.

- `launch_config` reads the JAX package's SKGE_* variables first, then
  torchrun's, and a world of one without either; `initialize` raises
  without a GPU unless the CPU is asked for, and on the CPU forms a gloo
  world of one (idempotently);
- `launch_local` runs a world of processes on this host and kills one
  that outlives its time limit;
- `PartitionedTrainer` refuses `exchange='auto'` (naming ROADMAP.md), an
  unknown exchange and a reciprocal margin loss;
- left as None, `gather` changes nothing: the four functions give the
  same results bit for bit as with a hook that gathers the same rows, and
  they call the hook with the JAX package's (param, role) sequence.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skge_tpu import TransE as JTransE
from skge_tpu import training as jtraining
from skge_torch import TransE, training
from skge_torch.parallel import distributed

torch.set_num_threads(1)

ENV = ("SKGE_COORDINATOR", "SKGE_NUM_PROCESSES", "SKGE_PROCESS_ID", "MASTER_ADDR",
       "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    distributed.destroy()
    yield monkeypatch
    distributed.destroy()


@pytest.mark.parametrize("env, want", [
    ({}, (None, 1, 0)),
    ({"SKGE_COORDINATOR": "10.0.0.1:1234", "SKGE_NUM_PROCESSES": "4",
      "SKGE_PROCESS_ID": "2"}, ("tcp://10.0.0.1:1234", 4, 2)),
    ({"SKGE_COORDINATOR": "file:///tmp/store", "SKGE_NUM_PROCESSES": "2",
      "SKGE_PROCESS_ID": "1"}, ("file:///tmp/store", 2, 1)),
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "29500", "WORLD_SIZE": "3",
      "RANK": "1", "LOCAL_RANK": "0"}, ("tcp://localhost:29500", 3, 1)),
    # the JAX package's variables win over torchrun's
    ({"SKGE_COORDINATOR": "a:1", "SKGE_NUM_PROCESSES": "2", "SKGE_PROCESS_ID": "0",
      "MASTER_ADDR": "b", "MASTER_PORT": "2", "WORLD_SIZE": "8", "RANK": "5"},
     ("tcp://a:1", 2, 0)),
], ids=["none", "skge", "skge-file", "torchrun", "skge-first"])
def test_launch_config_reads_the_environment(clean_env, env, want):
    for k, v in env.items():
        clean_env.setenv(k, v)
    method, nproc, pid, local = distributed.launch_config()
    assert (method, nproc, pid) == want
    if "LOCAL_RANK" in env:
        assert local == int(env["LOCAL_RANK"])
    assert distributed.launch_config("h:9", 2, 1, 0) == ("tcp://h:9", 2, 1, 0)


def test_launch_config_refuses_a_bad_world(clean_env):
    with pytest.raises(ValueError, match="outside a world"):
        distributed.launch_config(None, 2, 2)
    with pytest.raises(ValueError, match="needs a coordinator"):
        distributed.launch_config(None, 2, 0)


def test_initialize_needs_a_gpu_unless_the_cpu_is_asked_for(clean_env):
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.make_shard_mesh()
    assert not torch.distributed.is_initialized()
    assert distributed.initialize(device="cpu") is False
    assert distributed.initialize(device="cpu") is False  # idempotent
    group = distributed.make_shard_mesh()
    assert (group.rank, group.size, group.device.type) == (0, 1, "cpu")
    assert not distributed.is_distributed()
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(group.all_gather(x), x[None])
    assert torch.equal(group.all_reduce(x), x)
    assert torch.equal(group.reduce_scatter(x), x)
    np.testing.assert_array_equal(distributed.host_replicate(x, group), x.numpy())
    b, m = distributed.make_global_batches(np.ones((1, 4, 3), np.int32),
                                           np.ones((1, 4), np.float32), group)
    assert b.shape == (4, 3) and b.dtype == torch.int64 and m.shape == (4,)
    assert distributed.local_shard_ids(group) == [0]


def test_launch_local_runs_a_world_and_kills_a_late_rank(tmp_path):
    code = ("import os, sys, time; r = int(os.environ['SKGE_PROCESS_ID']);"
            "print(r, os.environ['SKGE_NUM_PROCESSES'],"
            " os.environ['SKGE_COORDINATOR'].startswith('file://'));"
            "time.sleep(60 if r == 1 and len(sys.argv) > 1 else 0)")
    out = distributed.launch_local([sys.executable, "-c", code], 2, 30,
                                   store_dir=str(tmp_path))
    assert [(rc, so.split()) for rc, so, _ in out] == [
        (0, ["0", "2", "True"]), (0, ["1", "2", "True"])]
    out = distributed.launch_local([sys.executable, "-c", code, "late"], 2, 3)
    assert out[0][0] == 0 and out[1][0] is None and "killed after 3" in out[1][2]


N_E, N_R, D, B, K = 20, 4, 6, 9, 5


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"E": rng.normal(size=(N_E, D)), "R": rng.normal(size=(N_R, D))}
    pos = np.stack([rng.integers(0, N_E, B), rng.integers(0, N_E, B),
                    rng.integers(0, N_R, B)], 1)
    pool = rng.integers(0, N_E, K)
    mask = (rng.random(B) > 0.2).astype(np.float64)
    repl = [(m, rng.integers(0, N_E, B), np.ones(B)) for m in (0, 1, 1)]
    return params, pos, pool, mask, repl


def _call(fn_name, lib, model, params, pos, pool, mask, repl, gather):
    kw = {} if gather is None else {"gather": gather}
    fn = getattr(lib, fn_name)
    if fn_name == "pairwise_grads_fused":
        return fn(model, params, pos, repl, mask, 0.5, **kw)
    if fn_name == "pairwise_grads_shared":
        return fn(model, params, pos, pool, mask, 0.5, **kw)
    if fn_name == "selfadv_grads_shared":
        return fn(model, params, pos, pool, mask, 0.5, 1.5, **kw)
    return fn(model, params, pos, pool, mask, ("o", "s"), 0.1, **kw)


def _flat(x):
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flat(v)]
    return [x]


FNS = ["pairwise_grads_fused", "pairwise_grads_shared", "selfadv_grads_shared",
       "sampled_ce_grads_shared"]


@pytest.mark.parametrize("fn_name", FNS)
def test_gather_none_is_bit_equal_and_calls_follow_jax(fn_name):
    params, pos, pool, mask, repl = inputs()
    tparams = {k: torch.as_tensor(v) for k, v in params.items()}
    targs = (torch.as_tensor(pos), torch.as_tensor(pool), torch.as_tensor(mask),
             [(m, torch.as_tensor(r), torch.as_tensor(v)) for m, r, v in repl])
    model = TransE(N_E, N_R, D, dtype="float64")
    calls = []

    def hook(pname, idx, role=None):
        calls.append((pname, role))
        return tparams[pname][idx]

    plain = _call(fn_name, training, model, tparams, *targs, None)
    hooked = _call(fn_name, training, model, tparams, *targs, hook)
    for a, b in zip(_flat(plain), _flat(hooked), strict=True):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b

    jcalls = []
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def jhook(pname, idx, role=None):
        jcalls.append((pname, role))
        return jparams[pname][idx]

    _call(fn_name, jtraining, JTransE(N_E, N_R, D, dtype="float64"), jparams,
          jnp.asarray(pos), jnp.asarray(pool), jnp.asarray(mask),
          [(m, jnp.asarray(r), jnp.asarray(v)) for m, r, v in repl], jhook)
    assert calls == jcalls


def test_partitioned_trainer_refuses_what_it_does_not_have():
    """`exchange='auto'` without the link rate between cards (which one
    card cannot measure) says that it needs it; an unknown exchange and a
    reciprocal margin loss are refused before any process group is
    formed."""
    from skge_torch import AdaGrad
    from skge_torch.parallel.partitioned import PartitionedTrainer

    model, triples = TransE(N_E, N_R, D), np.zeros((4, 3), np.int32)
    with pytest.raises(ValueError, match="link rate between cards"):
        PartitionedTrainer(model, AdaGrad(), triples, exchange="auto")
    with pytest.raises(ValueError, match="unknown exchange"):
        PartitionedTrainer(model, AdaGrad(), triples, exchange="nccl")
    with pytest.raises(ValueError, match="reciprocal=True requires"):
        PartitionedTrainer(model, AdaGrad(), triples, reciprocal=True)
    assert not torch.distributed.is_initialized()
