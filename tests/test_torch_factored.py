"""The port's RESCAL shared-pool training (skge_torch/training.py: the
factored bilinear gradients, their aggregation and the steps) against the
JAX package's.

- pairwise and pointwise gradients (RESCAL factored, TransE generic
  pointwise), fp64 at 1e-9: loss, violations, E occurrences, W factors;
- the port's factored path against its own generic autograd path, modes
  (0,), (1,) and (0, 1);
- `apply_gradients` in every aggregate mode, `rparam` 0 and 0.01, with a
  batch mask;
- step dispatch;
- one fp32 step against JAX's Pallas scatters (interpret mode);
- 8-step trajectories fed JAX's draws, identical violation counts;
- filtered ranking, identical ranks; `convert` of a JAX RESCAL state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.evaluation import FilteredRankingEval as JEval
from skge_tpu.models import RESCAL as JRESCAL
from skge_tpu.models import TransE as JTransE
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_tpu.sampling import SharedNegativeSampler as JSampler
from skge_torch import (RESCAL, AdaGrad, FilteredRankingEval, SharedNegativeSampler,
                        TransE, convert, init_state, make_epoch_fn,
                        make_pairwise_step, make_pointwise_step, training)
from skge_torch.data import synthetic_kg
from skge_torch.ops import cuda_outer, cuda_segment
from skge_torch.ops.aggregate import FactoredOcc
from test_torch_step import ReplayPool

torch.set_num_threads(1)

N_E, N_R, D, B, K = 29, 5, 8, 24, 11
MARGIN = 0.8
TOL = dict(rtol=1e-9, atol=1e-11)
AGGREGATES = ["unique", "dense", "dense_pallas", "dense_sorted"]


def rescal_state(seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    params = {"E": rng.normal(size=(N_E, D)) * 0.5,
              "W": rng.normal(size=(N_R, D, D)) * 0.3}
    p2 = {k: rng.random(v.shape) for k, v in params.items()}
    cast = lambda d: {k: v.astype(dtype) for k, v in d.items()}  # noqa: E731
    return cast(params), cast(p2)


def batch_and_pool(seed, masked=True):
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [rng.integers(0, N_E // 2, B), rng.integers(0, N_E, B),
         rng.integers(0, N_R - 1, B)], axis=1,
    )  # duplicate subjects likely; the last relation stays untouched
    pool = rng.integers(0, N_E, K)
    pool[0] = pos[0, 1]  # a pool entity equal to a true object
    mask = np.ones(B)
    if masked:
        mask[::4] = 0.0
    return pos, pool, mask


def jargs(params, pos, pool, mask):
    return ({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pos),
            jnp.asarray(pool), jnp.asarray(mask, params["E"].dtype))


def targs(params, pos, pool, mask):
    return (convert.params_from_numpy(params, "cpu"), torch.as_tensor(pos),
            torch.as_tensor(pool), torch.as_tensor(mask, dtype=torch.float32))


def grads(lib, loss, model, params, pos, pool, mask, modes=(0, 1)):
    """Run `lib`'s shared-pool gradient function for `loss` through its
    dispatch; returns (loss, nviol or None, occ, g_dense)."""
    if lib is jtraining:
        args = jargs(params, pos, pool, mask)
    else:
        args = targs(params, pos, pool, mask)
    if loss == "pairwise":
        return lib.select_shared_pairwise_fn(model)(
            model, *args, MARGIN, modes=modes)
    out_loss, occ, g_dense = lib.select_shared_pointwise_fn(model)(
        model, *args, modes=modes)
    return out_loss, None, occ, g_dense


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def assert_occ_equal(tocc, jocc):
    assert tocc.keys() == jocc.keys()
    for k, jo in jocc.items():
        to = tocc[k]
        if isinstance(jo, jtraining.FactoredOcc):
            assert isinstance(to, FactoredOcc)
            np.testing.assert_array_equal(to.idx.numpy(), np.asarray(jo.idx))
            for tf, jf in zip((*to.us, *to.vs), (*jo.us, *jo.vs)):
                assert_close(tf, jf)
            assert_close(to.count, jo.count)
        else:
            np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
            assert_close(to[1], jo[1], err_msg=k)
            assert_close(to[2], jo[2], err_msg=k)


CASES = {
    "rescal_pairwise": (RESCAL, JRESCAL, "pairwise"),
    "rescal_pointwise": (RESCAL, JRESCAL, "pointwise"),
    "transe_pointwise": (TransE, JTransE, "pointwise"),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_shared_grads_match_jax_fp64(case, masked):
    tcls, jcls, loss = CASES[case]
    params, _ = rescal_state(0)
    if tcls is TransE:
        params = {"E": params["E"], "R": params["W"][:, 0]}
    pos, pool, mask = batch_and_pool(1, masked)
    jl, jn, jocc, jdense = grads(jtraining, loss, jcls(N_E, N_R, D, dtype="float64"),
                                 params, pos, pool, mask)
    tl, tn, tocc, tdense = grads(training, loss, tcls(N_E, N_R, D, dtype="float64"),
                                 params, pos, pool, mask)
    assert_close(float(tl), float(jl), rtol=1e-12)
    if loss == "pairwise":
        assert int(tn) == int(jn) > 0
    assert tdense == {} and dict(jdense) == {}
    assert_occ_equal(tocc, jocc)


@pytest.mark.parametrize("modes", [(0,), (1,), (0, 1)])
@pytest.mark.parametrize("loss", ["pairwise", "pointwise"])
def test_factored_matches_generic_autograd(loss, modes):
    """The hand-derived RESCAL path against the port's own autograd path
    through `score_pool` (W as full (B, d, d) occurrence grads)."""
    model = RESCAL(N_E, N_R, D, dtype="float64")
    params, p2 = rescal_state(2)
    pos, pool, mask = batch_and_pool(3)
    args = targs(params, pos, pool, mask)
    if loss == "pairwise":
        fl, fn, focc, fd = training.pairwise_grads_shared_bilinear(
            model, *args, MARGIN, modes=modes)
        gl, gn, gocc, gd = training.pairwise_grads_shared(
            model, *args, MARGIN, modes=modes)
        assert int(fn) == int(gn) > 0
    else:
        fl, focc, fd = training.pointwise_grads_shared_bilinear(model, *args, modes=modes)
        gl, gocc, gd = training.pointwise_grads_shared(model, *args, modes=modes)
    assert_close(float(fl), float(gl), rtol=1e-12)
    assert isinstance(focc["W"], FactoredOcc) and gocc["W"][1].shape == (B, D, D)
    opt = AdaGrad(lr=0.1)
    ost = {k: {"p2": v} for k, v in convert.params_from_numpy(p2, "cpu").items()}
    a, a_st = training.apply_gradients(model, opt, args[0], ost, gocc, gd, "dense",
                                       premasked=True)
    b, b_st = training.apply_gradients(model, opt, args[0], ost, focc, fd, "dense",
                                       premasked=True)
    for k in params:
        assert_close(b[k], a[k], rtol=1e-9, atol=1e-12)
        assert_close(b_st[k]["p2"], a_st[k]["p2"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("rparam", [0.0, 0.01])
@pytest.mark.parametrize("aggregate", AGGREGATES)
@pytest.mark.parametrize("loss", ["pairwise", "pointwise"])
def test_apply_gradients_matches_jax_fp64(loss, aggregate, rparam):
    params, p2 = rescal_state(4)
    pos, pool, mask = batch_and_pool(5)
    jm = JRESCAL(N_E, N_R, D, dtype="float64", rparam=rparam)
    tm = RESCAL(N_E, N_R, D, dtype="float64", rparam=rparam)
    _, _, jocc, jd = grads(jtraining, loss, jm, params, pos, pool, mask)
    _, _, tocc, td = grads(training, loss, tm, params, pos, pool, mask)
    # the JAX package's 'dense_sorted' has no factored branch (its
    # segment_outer_mean_dense leaves the sum unset for backend 'sorted');
    # the port scatters it as 'dense', so it is held to JAX's 'dense'
    jaggregate = "dense" if aggregate == "dense_sorted" else aggregate
    want, want_st = jtraining.apply_gradients(
        jm, JAdaGrad(lr=0.1), {k: jnp.asarray(v) for k, v in params.items()},
        {k: {"p2": jnp.asarray(v)} for k, v in p2.items()}, jocc, jd, jaggregate,
        premasked=True,
    )
    got, got_st = training.apply_gradients(
        tm, AdaGrad(lr=0.1), convert.params_from_numpy(params, "cpu"),
        {k: {"p2": torch.as_tensor(v)} for k, v in p2.items()}, tocc, td,
        aggregate, premasked=True,
    )
    for k in params:
        assert_close(got[k], want[k], err_msg=k)
        assert_close(got_st[k]["p2"], want_st[k]["p2"], err_msg=k)
    # rows of W no positive touched keep their values bit for bit
    untouched = np.setdiff1d(np.arange(N_R), pos[mask > 0, 2])
    assert untouched.size
    np.testing.assert_array_equal(got["W"][untouched].numpy(), params["W"][untouched])


def test_dense_rescal_step_launches_each_kernel_wrapper(monkeypatch):
    """Under a dense mode a RESCAL step goes through segment_outer_sum once
    (W) and segment_sum twice (E with its count channel, W's counts)."""
    calls = {"outer": 0, "segment": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    from skge_torch.ops import aggregate
    monkeypatch.setattr(aggregate, "segment_outer_sum",
                        spy("outer", cuda_outer.segment_outer_sum))
    monkeypatch.setattr(aggregate, "segment_sum",
                        spy("segment", cuda_segment.segment_sum))
    params, p2 = rescal_state(6)
    pos, pool, mask = batch_and_pool(7)
    model = RESCAL(N_E, N_R, D, dtype="float64")
    _, _, occ, gd = grads(training, "pairwise", model, params, pos, pool, mask)
    training.apply_gradients(
        model, AdaGrad(), convert.params_from_numpy(params, "cpu"),
        {k: {"p2": torch.as_tensor(v)} for k, v in p2.items()}, occ, gd,
        "dense_pallas", premasked=True,
    )
    assert calls == {"outer": 1, "segment": 2}


@pytest.mark.parametrize("loss", ["pairwise", "pointwise"])
def test_step_dispatch(loss, monkeypatch):
    """The steps route RESCAL to the factored paths and TransE to the
    generic ones; both need a pool sampler."""
    hits = []
    names = {"pairwise": ("pairwise_grads_shared_bilinear", "pairwise_grads_shared"),
             "pointwise": ("pointwise_grads_shared_bilinear", "pointwise_grads_shared")}
    for name in names[loss]:
        orig = getattr(training, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            hits.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(training, name, spy)
    opt = AdaGrad(lr=0.1)
    sampler = SharedNegativeSampler(N_E, k=K)
    pos, _, mask = batch_and_pool(8)
    for model in (RESCAL(N_E, N_R, D), TransE(N_E, N_R, D)):
        if loss == "pairwise":
            step = make_pairwise_step(model, opt, sampler, MARGIN)
        else:
            step = make_pointwise_step(model, opt, sampler)
        state = init_state(model, opt, torch.Generator().manual_seed(0))
        state, m = step(state, torch.as_tensor(pos), torch.as_tensor(mask))
        assert state.step == 1 and bool(torch.isfinite(m.loss))
    assert hits == list(names[loss])
    make = make_pairwise_step if loss == "pairwise" else make_pointwise_step
    with pytest.raises(ValueError):
        make(RESCAL(N_E, N_R, D), opt, object(), *((MARGIN,) if loss == "pairwise" else ()))
    with pytest.raises(ValueError):
        training.apply_gradients(RESCAL(N_E, N_R, D), opt, {}, {}, {}, {}, "sparse")


def test_fp32_step_matches_jax_pallas_scatters():
    """fp32, one pairwise step: the JAX side's E and W scatters in its
    Pallas kernels (interpret mode), the port's through its segment sums;
    params within 1e-6."""
    from jax.experimental.pallas import tpu as pltpu

    loss = "pairwise"
    params, p2 = rescal_state(9, np.float32)
    pos, pool, mask = batch_and_pool(10)
    jm, tm = JRESCAL(N_E, N_R, D), RESCAL(N_E, N_R, D)
    with pltpu.force_tpu_interpret_mode():
        _, _, jocc, jd = grads(jtraining, loss, jm, params, pos, pool, mask)
        want, want_st = jtraining.apply_gradients(
            jm, JAdaGrad(lr=0.1), {k: jnp.asarray(v) for k, v in params.items()},
            {k: {"p2": jnp.asarray(v)} for k, v in p2.items()}, jocc, jd,
            "dense_pallas", premasked=True,
        )
    _, _, tocc, td = grads(training, loss, tm, params, pos, pool, mask)
    got, got_st = training.apply_gradients(
        tm, AdaGrad(lr=0.1), convert.params_from_numpy(params, "cpu"),
        {k: {"p2": torch.as_tensor(v)} for k, v in p2.items()}, tocc, td,
        "dense_pallas", premasked=True,
    )
    for k in params:
        assert got[k].dtype == torch.float32
        assert_close(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert_close(got_st[k]["p2"], want_st[k]["p2"], rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("loss", ["pairwise", "pointwise"])
def test_trajectory_with_jax_draws_matches_jax(loss):
    """2 epochs x 4 steps of RESCAL (rparam 0.01): the port, fed JAX's epoch
    permutations and pool draws, follows JAX's trajectory (fp64, 1e-9;
    violation counts identical)."""
    n_e, n_r, d, k, nb, epochs = 40, 6, 7, 9, 4, 2
    ds = synthetic_kg(n_e, n_r, 150, seed=4)
    jm = JRESCAL(n_e, n_r, d, dtype="float64", rparam=0.01)
    jopt = JAdaGrad(lr=0.1)
    jsampler = JSampler(n_e, k=k)
    if loss == "pairwise":
        jstep = jtraining.make_pairwise_step(jm, jopt, jsampler, 0.5, aggregate="dense")
    else:
        jstep = jtraining.make_pointwise_step(jm, jopt, jsampler, aggregate="dense")
    jepoch = jax.jit(jtraining.make_epoch_fn(jstep, ds.train.shape[0], nb))
    jstate = jtraining.init_state(jm, jopt, jax.random.PRNGKey(7))

    # replay the JAX key splits of make_epoch_fn and the pool step
    key, perms, pools = jstate.key, [], []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(pk, ds.train.shape[0])))
        for _ in range(nb):
            key, sk = jax.random.split(key)
            pools.append(np.array(jsampler.pool(sk, None, None)))

    tm = RESCAL(n_e, n_r, d, dtype="float64", rparam=0.01)
    if loss == "pairwise":
        tstep = make_pairwise_step(tm, AdaGrad(lr=0.1), ReplayPool(pools), 0.5,
                                   aggregate="dense_pallas")
    else:
        tstep = make_pointwise_step(tm, AdaGrad(lr=0.1), ReplayPool(pools),
                                    aggregate="dense_pallas")
    tepoch = make_epoch_fn(tstep, ds.train.shape[0], nb)
    tstate = convert.state_from_numpy(jax.device_get(jstate), "cpu")
    xs_j, xs_t = jnp.asarray(ds.train), torch.as_tensor(ds.train, dtype=torch.int64)
    for e in range(epochs):
        jstate, jmet = jepoch(jstate, xs_j)
        tstate, tmet = tepoch(tstate, xs_t, perm=torch.as_tensor(perms[e]))
        np.testing.assert_array_equal(
            tmet.nviolations.numpy(), np.asarray(jmet.nviolations)
        )
        assert_close(tmet.loss, jmet.loss)
        for name in ("E", "W"):
            assert_close(tstate.params[name], jstate.params[name])
            assert_close(tstate.opt_state[name]["p2"], jstate.opt_state[name]["p2"])
    assert tstate.step == int(jstate.step) == epochs * nb
    if loss == "pairwise":
        assert int(tmet.nviolations.sum()) > 0


@pytest.mark.parametrize("ties", ["mean", "optimistic"])
def test_filtered_ranking_matches_jax(ties):
    ds = synthetic_kg(30, 4, 200, n_test=25, seed=5)
    rng = np.random.default_rng(6)
    params = {"E": rng.normal(size=(30, 8)), "W": rng.normal(size=(4, 8, 8))}
    params["E"][3] = params["E"][4]  # two entities tied everywhere
    known = ds.all_triples()
    want = JEval(JRESCAL(30, 4, 8, dtype="float64"), ds.test, known,
                 batch_size=10, ties=ties)({k: jnp.asarray(v) for k, v in params.items()})
    got = FilteredRankingEval(RESCAL(30, 4, 8, dtype="float64"), ds.test, known,
                              batch_size=10, ties=ties)(
        convert.params_from_numpy(params, "cpu"))
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.ranks_raw, want.ranks_raw)
    assert got.summary() == pytest.approx(want.summary())


def test_state_from_jax_rescal_train_state():
    """The 3-D W and its AdaGrad p2 carry across unchanged."""
    model, opt = JRESCAL(30, 4, 6), JAdaGrad(lr=0.1)
    jstate = jtraining.init_state(model, opt, jax.random.PRNGKey(0))
    jstate = jstate._replace(
        opt_state={k: {"p2": v["p2"] + 0.25} for k, v in jstate.opt_state.items()},
        step=jstate.step + 2,
    )
    host = jax.device_get(jstate)
    state = convert.state_from_numpy(host, "cpu", seed=1)
    assert state.step == 2
    assert state.params["W"].shape == (4, 6, 6)
    assert state.opt_state["W"]["p2"].shape == (4, 6, 6)
    for k in ("E", "W"):
        assert state.params[k].dtype == torch.float32
        np.testing.assert_array_equal(state.params[k].numpy(), host.params[k])
        np.testing.assert_array_equal(state.opt_state[k]["p2"].numpy(),
                                      host.opt_state[k]["p2"])
    back = convert.params_to_numpy(state.params)
    for k in back:
        np.testing.assert_array_equal(back[k], host.params[k])
