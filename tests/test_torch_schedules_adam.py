"""The port's lr schedules and lazy Adam (skge_torch/optim.py) against the
JAX package's (skge_tpu/optim.py): the schedules at the edges of warmup and
decay at 1e-12; Adam's three apply paths over repeated touches, so that
each row's count `t` differs, fp64 at 1e-9, with zero-count rows left bit
for bit; SGD and AdaGrad under a schedule.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import optim as joptim
from skge_tpu.ops.aggregate import DenseGrads as JDense
from skge_tpu.ops.aggregate import UniqueGrads as JUnique
from skge_torch import optim as toptim
from skge_torch.ops.aggregate import DenseGrads, UniqueGrads

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("name", ["linear", "cosine"])
@pytest.mark.parametrize("warmup, total, min_scale", [(0, 40, 0.0), (7, 40, 0.1),
                                                      (5, 5, 0.25)])
def test_schedules_match_jax(name, warmup, total, min_scale):
    cls = {"linear": (toptim.WarmupLinear, joptim.WarmupLinear),
           "cosine": (toptim.WarmupCosine, joptim.WarmupCosine)}[name]
    tsch = cls[0](warmup=warmup, total=total, min_scale=min_scale)
    jsch = cls[1](warmup=warmup, total=total, min_scale=min_scale)
    made = toptim.make_schedule(name, warmup, total, min_scale)
    assert made == tsch and toptim.SCHEDULES[name] is cls[0]
    steps = sorted({0, 1, max(warmup - 1, 0), warmup, (warmup + total) // 2,
                    total, total + 5})
    for step in steps:
        want = float(jsch(step))
        assert abs(tsch(step) - want) <= 1e-12, (step, tsch(step), want)
        assert isinstance(tsch(step), float)
    assert toptim.make_schedule(None) is None
    assert toptim.make_schedule("constant") is None


def _touches(seed, n_rows, rounds):
    """Per round: the touched rows (some rows never, some every time) and
    their gradients."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        rows = np.unique(np.concatenate([[0], rng.integers(0, n_rows - 2, 4)]))
        out.append((rows, rng.normal(size=(len(rows), 3))))
    return out


def _jstate(tstate):
    return {k: jnp.asarray(v.numpy()) for k, v in tstate.items()}


def _assert_state(tparam, tstate, jparam, jstate):
    np.testing.assert_allclose(tparam.numpy(), np.asarray(jparam), **TOL)
    for k in jstate:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("path", ["unique", "dense_masked", "full"])
def test_lazy_adam_matches_jax(path):
    """6 rounds of touches under a cosine schedule; the last two rows are
    never touched and stay bit for bit on the sparse paths."""
    n_rows = 9
    rng = np.random.default_rng(1)
    param0 = rng.normal(size=(n_rows, 3))
    sch = dict(warmup=2, total=8, min_scale=0.1)
    topt = toptim.Adam(lr=0.05, schedule=toptim.WarmupCosine(**sch))
    jopt = joptim.Adam(lr=0.05, schedule=joptim.WarmupCosine(**sch))
    tparam = torch.as_tensor(param0)
    tstate = topt.init({"E": tparam})["E"]
    assert tstate["t"].dtype == torch.float64 and tstate["t"].shape == (n_rows,)
    jparam, jstate = jnp.asarray(param0), _jstate(tstate)
    for step, (rows, g) in enumerate(_touches(2, n_rows, 6)):
        if path == "unique":
            cnt = np.ones(len(rows))
            cnt[-1] = 0.0  # listed but not counted: left as it was
            tparam, tstate = topt.apply_unique(
                tparam, tstate, UniqueGrads(torch.as_tensor(rows), torch.as_tensor(g),
                                            torch.as_tensor(cnt)), step=step)
            jparam, jstate = jopt.apply_unique(
                jparam, jstate, JUnique(jnp.asarray(rows), jnp.asarray(g),
                                        jnp.asarray(cnt)), step=step)
        else:
            full = np.zeros((n_rows, 3))
            full[rows] = g
            cnt = np.zeros(n_rows)
            cnt[rows] = 1.0
            if path == "dense_masked":
                tparam, tstate = topt.apply_dense_masked(
                    tparam, tstate, DenseGrads(torch.as_tensor(full), torch.as_tensor(cnt)),
                    post="normless1", step=step)
                jparam, jstate = jopt.apply_dense_masked(
                    jparam, jstate, JDense(jnp.asarray(full), jnp.asarray(cnt)),
                    post="normless1", step=step)
            else:
                tparam, tstate = topt.apply_full(tparam, tstate, torch.as_tensor(full),
                                                 step=step)
                jparam, jstate = jopt.apply_full(jparam, jstate, jnp.asarray(full),
                                                 step=step)
        _assert_state(tparam, tstate, jparam, jstate)
    t = tstate["t"].numpy()
    if path == "full":
        assert np.all(t == 6)
    else:
        assert len(set(t.tolist())) > 2  # the rows' counts differ
        assert torch.equal(tparam[-2:], torch.as_tensor(param0[-2:]))
        for k in ("m", "v", "t"):
            assert not bool(tstate[k][-2:].any())


@pytest.mark.parametrize("cls", ["SGD", "AdaGrad"])
def test_sgd_adagrad_with_schedule_match_jax(cls):
    rng = np.random.default_rng(3)
    param0 = rng.normal(size=(6, 4))
    topt = getattr(toptim, cls)(lr=0.2, schedule=toptim.WarmupLinear(3, 10, 0.2))
    jopt = getattr(joptim, cls)(lr=0.2, schedule=joptim.WarmupLinear(3, 10, 0.2))
    tparam = torch.as_tensor(param0)
    tstate = topt.init({"E": tparam})["E"]
    jparam, jstate = jnp.asarray(param0), _jstate(tstate)
    for step in range(5):
        g = rng.normal(size=(6, 4))
        cnt = (rng.random(6) < 0.6).astype(np.float64)
        tparam, tstate = topt.apply_dense_masked(
            tparam, tstate, DenseGrads(torch.as_tensor(g), torch.as_tensor(cnt)), step=step)
        jparam, jstate = jopt.apply_dense_masked(
            jparam, jstate, JDense(jnp.asarray(g), jnp.asarray(cnt)), step=step)
        _assert_state(tparam, tstate, jparam, jstate)
    assert topt.lr_at(0) == 0.0 and topt.lr_at(None) == 0.2
    assert toptim.OPTIMIZERS["adam"] is toptim.Adam


def test_adam_step_count_stays_fp32_or_wider():
    params = {"E": torch.zeros(3, 2, dtype=torch.bfloat16)}
    assert toptim.Adam().init(params)["E"]["t"].dtype == torch.float32
    jt = joptim.Adam().init({"E": jnp.zeros((3, 2), jnp.bfloat16)})["E"]["t"]
    assert jt.dtype == jnp.float32 and jax.device_get(jt).shape == (3,)
