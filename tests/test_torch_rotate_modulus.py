"""RotatE with its published distance, the sum of complex moduli
(`RotatE(distance="modulus")`, skge_torch/models/rotate.py), and its sweep
(skge_torch/ops/cuda_rotate.py, K6 in csrc/rotate_pool.cu).

On the CPU, in float64: the model against the benchmark's plain reference
(`kgebench/models/rotate.py`): scores, pool scores of both modes,
all-entity scores and the pool pass's gradients; three shared-pool steps
(`PoolStepGraphs` with `capture=False`) against `kgebench.reference`'s
steps on the same draws; `LinkPredictor`'s top k against the reference's
filtered ranking; the plain sweep's gradient against its formulas with
exact zero moduli; the default squared distance unchanged; the wrapper's
refusals, its split choice and its counters in the graphs' registry.

On the card (marked `cuda`, skipped without one): the kernels against the
plain version in float64, both gradients, at the pool step's and a serving
batch's shapes and ragged ones; bit-equal repeats; launch counts. This
file does not import JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_rotate_modulus.py
"""

import numpy as np
import pytest
import torch

from kgebench import gen, reference, registry
from skge_torch import AdaGrad, SharedNegativeSampler, make_pairwise_step
from skge_torch.models import RotatE, mxu_dot
from skge_torch.ops import cuda_rotate
from skge_torch.serving import LinkPredictor
from skge_torch.training import _COUNTERS, PoolStepGraphs, TrainState

torch.set_num_threads(1)

REF = registry.load_module(registry.ROOT / "models" / "rotate.py", "kgebench_model_rotate")
N_E, N_R, D, B, K = 40, 5, 6, 7, 9
F64 = torch.float64


def _tables(seed=0, n_e=N_E, n_r=N_R, d=D):
    g = torch.Generator().manual_seed(seed)
    return {"E": torch.randn(n_e, 2 * d, generator=g, dtype=F64),
            "R": torch.rand(n_r, d, generator=g, dtype=F64) * 6.0 - 3.0}


def _model(**kw):
    return RotatE(N_E, N_R, D, dtype="float64", distance="modulus", **kw)


def _rows(params, s, o, p):
    return {"es": params["E"][s], "eo": params["E"][o], "rp": params["R"][p]}


def _ids(seed=1, n=B):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, N_E, (n,), generator=g), torch.randint(0, N_E, (n,), generator=g),
            torch.randint(0, N_R, (n,), generator=g))


def test_scores_against_reference():
    params, model = _tables(), _model()
    s, o, p = _ids()
    rows = _rows(params, s, o, p)
    torch.testing.assert_close(model.score_from_rows(rows, {}),
                               REF.score(rows["es"], rows["rp"], rows["eo"]), rtol=1e-12, atol=0)
    pool = params["E"][:K]
    for mode in (0, 1):
        q = REF.query(mode, rows["es"], rows["rp"], rows["eo"])
        want = REF.pool_scores(q, pool)
        torch.testing.assert_close(model.score_pool(rows, pool, {}, mode), want, rtol=1e-12, atol=0)
        both = model.score_pool_modes(rows, pool, {}, (0, 1))
        torch.testing.assert_close(both[mode], want, rtol=1e-12, atol=0)
    torch.testing.assert_close(model.score_all_o(params, s, p),
                               REF.pool_scores(REF.query(1, rows["es"], rows["rp"], None),
                                               params["E"]), rtol=1e-12, atol=0)
    torch.testing.assert_close(model.score_all_s(params, o, p),
                               REF.pool_scores(REF.query(0, None, rows["rp"], rows["eo"]),
                                               params["E"]), rtol=1e-12, atol=0)
    # a positive's score is its own all-entity score at its object
    all_o = model.score_all_o(params, s, p)
    torch.testing.assert_close(all_o[torch.arange(B), o], model.score_from_rows(rows, {}),
                               rtol=1e-12, atol=0)


def _with_zero_moduli(q, pool):
    """Pool row 0 equal to query 0 (every modulus 0) and row 1 sharing
    query 1's first two complex dimensions (those moduli 0)."""
    pool = pool.clone()
    pool[0] = q[0]
    d = q.shape[1] // 2
    for c in (0, 1):
        pool[1, c], pool[1, d + c] = q[1, c], q[1, d + c]
    return pool


def test_pool_pass_gradients_against_reference():
    params = _tables(2)
    s, o, p = _ids(3)
    rows = _rows(params, s, o, p)
    q = REF.query(1, rows["es"], rows["rp"], rows["eo"])
    pool = _with_zero_moduli(q, params["E"][:K])
    g = torch.randn(B, K, generator=torch.Generator().manual_seed(4), dtype=F64)
    gq_ref, gp_ref = REF.pool_pass(q, pool, lambda lo, f: g[lo:lo + f.shape[0]])
    qq, pp = q.clone().requires_grad_(), pool.clone().requires_grad_()
    gq, gp = torch.autograd.grad(cuda_rotate.modulus_sweep(qq, pp), [qq, pp], g)
    torch.testing.assert_close(gq, gq_ref, rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(gp, gp_ref, rtol=1e-12, atol=1e-15)
    assert torch.isfinite(gq).all() and torch.isfinite(gp).all()


def test_plain_backward_against_its_formulas_with_zero_moduli(monkeypatch):
    """The chunked sweep (one pool row a chunk, each under checkpoint)
    differentiated by autograd against the plain backward's formulas; the
    exact zero moduli give 0, never NaN."""
    g0 = torch.Generator().manual_seed(5)
    q = torch.randn(B, 2 * D, generator=g0, dtype=F64)
    pool = _with_zero_moduli(q, torch.randn(K, 2 * D, generator=g0, dtype=F64))
    g = torch.randn(B, K, generator=g0, dtype=F64)
    monkeypatch.setattr(cuda_rotate, "CHUNK_ELEMENTS", B * 2 * D)
    qq, pp = q.clone().requires_grad_(), pool.clone().requires_grad_()
    s = cuda_rotate.modulus_sweep(qq, pp)
    torch.testing.assert_close(s, cuda_rotate.rotate_pool_reference(q, pool), rtol=0, atol=0)
    assert s[0, 0] == 0
    dq, dp = torch.autograd.grad(s, [qq, pp], g)
    dq_want, dp_want = cuda_rotate.rotate_pool_backward_reference(q, pool, g)
    torch.testing.assert_close(dq, dq_want, rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(dp, dp_want, rtol=1e-12, atol=1e-15)
    # the zero moduli's terms are exactly 0: row 0 of the pool against query 0
    d_only = cuda_rotate.rotate_pool_backward_reference(q[:1], pool[:1], g[:1, :1])
    assert all(bool((t == 0).all()) for t in d_only)


def test_three_pool_steps_against_reference():
    """Three graphed-path steps (pieces run uncaptured) against the
    benchmark's reference on the same draws, graph and weights, float64."""
    cfg = {"entities": 60, "relations": 4, "train": 300, "nbatches": 10, "ncomp": 5,
           "margin": 1.0, "lr": 0.1, "adagrad_eps": 1e-6, "entity_zipf": 0.75,
           "relation_zipf": 1.0}
    traffic = {"sampler": "shared", "k": 16, "modes": [0, 1]}
    seed = 2**32 + 17
    xs = torch.as_tensor(gen.kg(cfg, seed))
    p0 = gen.weights(REF.tables(cfg), seed, "cpu", F64)
    model = RotatE(cfg["entities"], cfg["relations"], cfg["ncomp"], dtype="float64",
                   distance="modulus")
    opt = AdaGrad(lr=cfg["lr"], eps=cfg["adagrad_eps"])
    step = make_pairwise_step(model, opt, SharedNegativeSampler(cfg["entities"], k=16),
                              margin=cfg["margin"], aggregate="dense")
    assert isinstance(step, PoolStepGraphs)
    step.capture = False
    gen_ = gen.draw_generator(seed, "cpu")
    state = TrainState({k: v.clone() for k, v in p0.items()}, opt.init(p0), gen_, 0)
    perm = torch.randperm(xs.shape[0], generator=gen_)
    losses = []
    for batch, mask in reference.epoch_batches(xs, perm, cfg["nbatches"], 3):
        state, m = step(state, batch, mask.to(F64))
        losses.append(float(m.loss))
    ref = reference.train_steps(REF, cfg, traffic, p0, xs, gen.draw_generator(seed, "cpu"), 3,
                                reference.PRECISIONS["fp64"])
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-11)
    assert min(ref["loss"]) > 0
    for k in ("E", "R"):
        torch.testing.assert_close(state.params[k], ref["params"][k], rtol=1e-10, atol=1e-12)
        assert not torch.equal(state.params[k], p0[k])


def test_link_predictor_against_reference():
    params = _tables(6)
    model = _model()
    g = np.random.default_rng(7)
    known = np.stack([g.integers(0, N_E, 80), g.integers(0, N_E, 80), g.integers(0, N_R, 80)],
                     axis=1)
    queries = np.stack([g.integers(0, N_E, 23), g.integers(0, N_R, 23)], axis=1)
    pred = LinkPredictor(model, params, known=known, batch_size=8, device="cpu")
    for direction in ("o", "s"):
        res = pred.top_k(queries, 5, direction)
        index = reference.known_index(known, N_R, direction)
        full = torch.cat([s for _, s in reference.rank_scores(
            REF, params, queries, index, direction, reference.PRECISIONS["fp64"], block=8)])
        vals, ids = torch.topk(full, 5, dim=1)
        np.testing.assert_array_equal(res.entities, ids.numpy())
        # the answers' scores come back in fp32: one rounding of the fp64 score
        np.testing.assert_allclose(res.scores, vals.numpy(), rtol=2.0**-24, atol=0)


def test_default_distance_unchanged(monkeypatch):
    """The default is the JAX package's squared distance, computed as
    before: one matmul through the norm expansion, no modulus sweep."""
    def refuse(*a, **k):
        raise AssertionError("the squared distance called the modulus sweep")

    monkeypatch.setattr("skge_torch.models.rotate.modulus_sweep", refuse)
    params = _tables(8)
    model = RotatE(N_E, N_R, D, dtype="float64")
    assert model.distance == "squared"
    s, o, p = _ids(9)
    rows = _rows(params, s, o, p)
    dd = RotatE._rotate(rows["es"], rows["rp"]) - rows["eo"]
    assert torch.equal(model.score_from_rows(rows, {}), -torch.sum(dd * dd, dim=-1))
    pool = params["E"][:K]
    for mode, q in ((1, RotatE._rotate(rows["es"], rows["rp"])),
                    (0, RotatE._rotate(rows["eo"], rows["rp"], sign=-1.0))):
        want = -(torch.sum(q * q, dim=-1, keepdim=True) - 2.0 * mxu_dot(q, pool.T)
                 + torch.sum(pool * pool, dim=-1)[None, :])
        assert torch.equal(model.score_pool(rows, pool, {}, mode), want)
    q = RotatE._rotate(params["E"][s], params["R"][p])
    E = params["E"]
    want = -(torch.sum(q * q, dim=-1, keepdim=True) - 2.0 * mxu_dot(q, E.T)
             + torch.sum(E * E, dim=-1)[None, :])
    assert torch.equal(model.score_all_o(params, s, p), want)


def test_unknown_distance_refused():
    with pytest.raises(ValueError, match="unknown distance"):
        RotatE(N_E, N_R, D, distance="l1")


def test_wrapper_refuses_and_counts_nothing():
    before = (cuda_rotate.launches, cuda_rotate.backward_launches)
    q, p = torch.zeros(3, 8), torch.zeros(4, 8)
    with pytest.raises(ValueError, match="card only"):
        cuda_rotate.rotate_pool(q, p)
    with pytest.raises(ValueError, match="want q"):
        cuda_rotate.rotate_pool(q, torch.zeros(4, 6))
    with pytest.raises(ValueError, match="2D wide"):
        cuda_rotate.rotate_pool(torch.zeros(3, 7), torch.zeros(4, 7))
    assert (cuda_rotate.launches, cuda_rotate.backward_launches) == before


@pytest.mark.parametrize("modes", [(0, 1), (1, 0), (1,)])
def test_modes_stacked_into_one_sweep(monkeypatch, modes):
    """`score_pool_modes` makes one sweep of the modes' stacked queries on
    every device, and each mode's part equals its own `score_pool`."""
    calls = []

    def counted(q, rows):
        calls.append(q.shape[0])
        return cuda_rotate.modulus_sweep(q, rows)

    params, model = _tables(12), _model()
    rows = _rows(params, *_ids(13))
    pool = params["E"][:K]
    want = [model.score_pool(rows, pool, {}, m) for m in modes]
    monkeypatch.setattr("skge_torch.models.rotate.modulus_sweep", counted)
    got = model.score_pool_modes(rows, pool, {}, modes)
    assert calls == [len(modes) * B]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=0)


def test_split_choice_at_the_cell_shapes():
    """132 SMs: the pool step's forward (2,048 x 256 outputs, 128 tiles)
    splits its 1,000 complex dimensions in 2; dq (2,048 rows) fills the
    card alone; dp (256 rows, 64 blocks) splits the 2,048 queries in 4; a
    serving batch's forward (3,744 tiles) does not split."""
    assert cuda_rotate.split_count(32 * 4, 1000, 132) == 2
    assert cuda_rotate.split_count(32 * 16, 256, 132) == 1
    assert cuda_rotate.split_count(4 * 16, 2048, 132) == 4
    assert cuda_rotate.split_count(16 * 234, 1000, 132) == 1
    assert cuda_rotate.split_count(1, 100, 132) == 1  # too short to split
    assert cuda_rotate._td(1000) == 2 and cuda_rotate._td(32) == 1


def test_counters_in_the_graphs_registry():
    assert {(cuda_rotate, "launches"), (cuda_rotate, "backward_launches")} <= set(_COUNTERS)


# --- on the card --------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _kernel_run(q, p, g):
    before = (cuda_rotate.launches, cuda_rotate.backward_launches)
    qq, pp = q.clone().requires_grad_(), p.clone().requires_grad_()
    s = cuda_rotate.rotate_pool(qq, pp)
    dq, dp = torch.autograd.grad(s, [qq, pp], g)
    torch.cuda.synchronize()
    assert (cuda_rotate.launches - before[0], cuda_rotate.backward_launches - before[1]) == (1, 2)
    return s.detach(), dq, dp


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,d", [(2_048, 256, 1_000), (64, 14_951, 1_000), (33, 97, 5),
                                   (1, 1, 1), (130, 65, 33), (5, 3_000, 129)])
def test_kernel_against_plain(b, k, d):
    dev = _card()
    gen_ = torch.Generator(device=dev).manual_seed(b + k + d)
    q = torch.randn(b, 2 * d, generator=gen_, device=dev)
    p = _with_zero_moduli(q, torch.randn(k, 2 * d, generator=gen_, device=dev)) if k > 1 and b > 1 \
        else torch.randn(k, 2 * d, generator=gen_, device=dev)
    g = torch.randn(b, k, generator=gen_, device=dev)
    s, dq, dp = _kernel_run(q, p, g)
    again = _kernel_run(q, p, g)
    assert all(torch.equal(x, y) for x, y in zip((s, dq, dp), again))
    u = 2.0**-24
    q64, p64, g64 = q.double(), p.double(), g.double()
    chunk = max(1, 2**26 // (k * 2 * d))
    dp_want = torch.zeros_like(p64)
    for lo in range(0, b, chunk):
        want = cuda_rotate.rotate_pool_reference(q64[lo:lo + chunk], p64)
        assert ((s[lo:lo + chunk].double() - want).abs() <= 8 * (d + 8) * u * want.abs()).all()
        dq_want, part = cuda_rotate.rotate_pool_backward_reference(q64[lo:lo + chunk], p64,
                                                                  g64[lo:lo + chunk])
        dp_want += part
        bound = 8 * (k + 64) * u * g64[lo:lo + chunk].abs().sum(1, keepdim=True)
        assert ((dq[lo:lo + chunk].double() - dq_want).abs() <= bound).all()
    assert ((dp.double() - dp_want).abs() <= 8 * (b + 64) * u * g64.abs().sum(0)[:, None]).all()
    if k > 1 and b > 1:
        assert s[0, 0] == 0 and torch.isfinite(dq).all() and torch.isfinite(dp).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_card_refuses_other_dtypes(dtype):
    """The route goes by device alone: on the card a sweep in another dtype
    than fp32 is refused by the kernels' wrapper, not sent to the plain
    version, and launches nothing."""
    dev = _card()
    before = (cuda_rotate.launches, cuda_rotate.backward_launches)
    q, p = torch.zeros(3, 8, dtype=dtype, device=dev), torch.zeros(4, 8, dtype=dtype, device=dev)
    with pytest.raises(TypeError, match="fp32-only"):
        cuda_rotate.modulus_sweep(q, p)
    model = RotatE(N_E, N_R, D, dtype="float64", distance="modulus")
    params = {k: v.to(dev, dtype) for k, v in _tables(14).items()}
    with pytest.raises(TypeError, match="fp32-only"):
        model.score_all_o(params, *(t.to(dev) for t in _ids(15)[::2]))
    assert (cuda_rotate.launches, cuda_rotate.backward_launches) == before


@pytest.mark.cuda
def test_model_routes_to_the_kernel():
    dev = _card()
    model = RotatE(N_E, N_R, D, distance="modulus")
    params = {k: v.float().to(dev) for k, v in _tables(10).items()}
    s, o, p = (t.to(dev) for t in _ids(11))
    rows = _rows(params, s, o, p)
    before = cuda_rotate.launches
    both = model.score_pool_modes(rows, params["E"][:K], {}, (0, 1))
    assert cuda_rotate.launches - before == 1
    want = _model().score_pool_modes({k: v.double().cpu() for k, v in rows.items()},
                                     params["E"][:K].double().cpu(), {}, (0, 1))
    for got, w in zip(both, want):
        torch.testing.assert_close(got.double().cpu(), w, rtol=1e-5, atol=1e-5)
