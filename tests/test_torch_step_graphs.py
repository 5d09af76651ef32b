"""The shared-pool step as CUDA graphs (`training.PoolStepGraphs`), on the
CPU: its pieces run uncaptured (`capture=False`) through the code the
capture records, held to the eager step (`graphs=False`) bit for bit; the
configurations that stay eager; each step's own metrics; K1's calls as the
benchmark's recorder sees them; the state's buffers.
"""

import pytest
import torch

from kgebench.profiling import k1_recorder
from skge_torch import (ERMLP, RESCAL, SGD, AdaGrad, Adam, HolE, RandomModeSampler,
                        SharedNegativeSampler, TransE, TransR, init_state, make_epoch_fn,
                        make_pairwise_step)
from skge_torch.data import synthetic_kg
from skge_torch.optim import WarmupCosine
from skge_torch.training import PoolStepGraphs, graphs_eligible

torch.set_num_threads(1)

N_E, N_R, N_TRAIN, NCOMP, K, NB = 120, 6, 600, 12, 16, 5

MODELS = {
    "transe_l1": lambda: TransE(N_E, N_R, NCOMP),
    "hole": lambda: HolE(N_E, N_R, NCOMP, rparam=0.01),
    "ermlp": lambda: ERMLP(N_E, N_R, NCOMP, nhidden=4),  # dense params
    "rescal": lambda: RESCAL(N_E, N_R, 6),       # factored W gradients: eager
    "transr": lambda: TransR(N_E, N_R, 64),      # M's rows 4,096 wide: eager
}
OPTS = {"adagrad": lambda: AdaGrad(lr=0.1), "adam": lambda: Adam(lr=0.01),
        "sgd": lambda: SGD(lr=0.05)}


def _xs():
    ds = synthetic_kg(n_entities=N_E, n_relations=N_R, n_train=N_TRAIN, seed=3)
    return torch.as_tensor(ds.train, dtype=torch.int64)


def _run(model, opt, step, xs, epochs=2, nb=NB):
    epoch = make_epoch_fn(step, xs.shape[0], nb)
    state = init_state(model, opt, torch.Generator().manual_seed(7))
    losses, viols = [], []
    for _ in range(epochs):
        state, m = epoch(state, xs)
        losses.append(m.loss)
        viols.append(m.nviolations)
    return state, torch.cat(losses), torch.cat(viols)


def _pieces(model, opt, aggregate="dense"):
    """The graphed step with its pieces run directly, as on the CPU."""
    step = make_pairwise_step(model, opt, SharedNegativeSampler(N_E, k=K), margin=0.5,
                              aggregate=aggregate)
    assert isinstance(step, PoolStepGraphs)
    step.capture = False
    return step


def _assert_same(a, b):
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        for s in a.opt_state[k]:
            assert torch.equal(a.opt_state[k][s], b.opt_state[k][s]), (k, s)
    assert a.step == b.step


@pytest.mark.parametrize("case", [
    ("transe_l1", "adagrad", "dense"), ("hole", "adagrad", "dense"),
    ("transe_l1", "adagrad", "dense_pallas"), ("hole", "adam", "dense_sorted"),
    ("transe_l1", "adam", "dense"), ("ermlp", "sgd", "dense"),
])
def test_pieces_equal_the_eager_step_bit_for_bit(case):
    name, oname, aggregate = case
    model, opt, xs = MODELS[name](), OPTS[oname](), _xs()
    eager = make_pairwise_step(model, opt, SharedNegativeSampler(N_E, k=K), margin=0.5,
                               aggregate=aggregate, graphs=False)
    assert not isinstance(eager, PoolStepGraphs)
    step = _pieces(model, opt, aggregate)
    want, want_loss, want_viol = _run(model, opt, eager, xs)
    got, loss, viol = _run(model, opt, step, xs)
    assert step.params is not None  # bound: steps 1-9 ran through the pieces
    _assert_same(got, want)
    assert torch.equal(loss, want_loss) and torch.equal(viol, want_viol)


@pytest.mark.parametrize("case", ["cpu", "iid", "unique", "schedule", "fused_false",
                                  "graphs_false", "factored", "wide"])
def test_ineligible_configurations_stay_eager(case):
    model = MODELS[{"factored": "rescal", "wide": "transr"}.get(case, "transe_l1")]()
    xs = _xs()
    opt = AdaGrad(lr=0.1, schedule=WarmupCosine(warmup=2, total=20)) \
        if case == "schedule" else AdaGrad(lr=0.1)
    sampler = RandomModeSampler(N_E) if case == "iid" else SharedNegativeSampler(N_E, k=K)
    kw = {"aggregate": "unique" if case == "unique" else "dense",
          "fused": case != "fused_false", "graphs": case != "graphs_false"}
    step = make_pairwise_step(model, opt, sampler, 0.5, **kw)
    eligible = case in ("cpu", "wide")
    assert graphs_eligible(model, opt, sampler, kw["aggregate"], kw["fused"]) == (
        case in ("cpu", "graphs_false", "wide"))
    assert isinstance(step, PoolStepGraphs) == eligible
    if case == "fused_false":  # the generic path takes expanded pairs, not a pool
        return
    if case == "wide":  # its pieces would run, but the table's rows are too wide
        step.capture = False
    state, loss, _ = _run(model, opt, step, xs, epochs=1)
    if eligible:  # the graphed step calls the eager one, binds nothing
        assert step.params is None and not step.graphs
        eager = make_pairwise_step(model, opt, sampler, 0.5, **{**kw, "graphs": False})
        want, want_loss, _ = _run(model, opt, eager, xs, epochs=1)
        _assert_same(state, want)
        assert torch.equal(loss, want_loss)
    assert torch.isfinite(loss).all() and state.step == NB


@pytest.mark.parametrize("name", ["transe_l1", "hole"])
def test_each_step_returns_its_own_metrics(name):
    model, opt, xs = MODELS[name](), AdaGrad(lr=0.1), _xs()
    _, loss, viol = _run(model, opt, _pieces(model, opt), xs, epochs=1, nb=10)
    assert loss.shape == viol.shape == (10,)
    assert len(set(loss.tolist())) == 10  # no one buffer stacked ten times
    assert (viol > 0).all()


@pytest.mark.parametrize("graphs", [False, True])
def test_k1_recorder_sees_one_segment_sum_a_step(graphs):
    model, opt, xs = MODELS["transe_l1"](), AdaGrad(lr=0.1), _xs()
    step = _pieces(model, opt) if graphs else make_pairwise_step(
        model, opt, SharedNegativeSampler(N_E, k=K), margin=0.5, aggregate="dense",
        graphs=False)
    calls = []
    with k1_recorder(calls):
        _run(model, opt, step, xs, epochs=2)
    assert len(calls) == 2 * NB
    b = -(-N_TRAIN // NB)
    t = 2 * b + K + b  # E: s, o, the pool; R: p
    assert {c[:2] for c in calls} == {(t, NCOMP + 4)}  # 12 + count + 3 zeros
    assert len({c[2] for c in calls}) > 1  # each call's own ids
    if graphs:
        want = []
        eager = make_pairwise_step(model, opt, SharedNegativeSampler(N_E, k=K),
                                   margin=0.5, aggregate="dense", graphs=False)
        with k1_recorder(want):
            _run(model, opt, eager, xs, epochs=2)
        assert calls == want


def test_state_holds_the_buffers():
    model, opt, xs = MODELS["transe_l1"](), AdaGrad(lr=0.1), _xs()
    step = _pieces(model, opt)
    batch, mask = xs[:120], torch.ones(120)
    s0 = init_state(model, opt, torch.Generator().manual_seed(1))
    e0 = s0.params["E"].clone()
    s1, _ = step(s0, batch, mask)      # the warm-up: eager, fresh tensors
    s2, _ = step(s1, batch, mask)      # binds copies of s1's tensors
    assert torch.equal(s0.params["E"], e0)  # inputs are left as they were
    assert s2.params["E"] is step.params["E"] and s1.params["E"] is not step.params["E"]
    held = s2.params["E"].clone()
    s3, _ = step(s2, batch, mask)      # in place: the state held from step 2 moves
    assert s3.params["E"] is s2.params["E"]
    assert not torch.equal(s2.params["E"], held)
    s4, _ = step(s0, batch, mask)      # another state is copied in
    assert s4.params["E"] is step.params["E"]
    assert torch.equal(s0.params["E"], e0)
    eager = make_pairwise_step(model, opt, SharedNegativeSampler(N_E, k=K), margin=0.5,
                               aggregate="dense", graphs=False)
    want, _ = eager(s0._replace(generator=torch.Generator().manual_seed(5)), batch, mask)
    s0g = s0._replace(generator=torch.Generator().manual_seed(5))
    got, _ = step(s0g, batch, mask)
    _assert_same(got, want)


@pytest.mark.parametrize("change", ["batch", "table"])
def test_a_call_that_does_not_fit_runs_eager(change):
    model, opt, xs = MODELS["transe_l1"](), AdaGrad(lr=0.1), _xs()
    step = _pieces(model, opt)
    s = init_state(model, opt, torch.Generator().manual_seed(1))
    for _ in range(2):
        s, _ = step(s, xs[:120], torch.ones(120))
    bound = step.params["E"]
    if change == "batch":
        other, batch = s, xs[:60]
    else:  # fp64 tables
        other = s._replace(params={k: v.double() for k, v in s.params.items()},
                           opt_state={k: {n: v.double() for n, v in sl.items()}
                                      for k, sl in s.opt_state.items()})
        batch = xs[:120]
    got, _ = step(other, batch, torch.ones(batch.shape[0]))
    assert got.params["E"] is not bound and step.params["E"] is bound


def test_a_pool_of_another_size_raises():
    model, opt, xs = MODELS["transe_l1"](), AdaGrad(lr=0.1), _xs()
    step = _pieces(model, opt)
    s = init_state(model, opt, torch.Generator().manual_seed(1))
    for _ in range(2):
        s, _ = step(s, xs[:120], torch.ones(120))
    step.sampler = SharedNegativeSampler(N_E, k=K + 1)
    with pytest.raises(ValueError, match="graphs=False"):
        step(s, xs[:120], torch.ones(120))
