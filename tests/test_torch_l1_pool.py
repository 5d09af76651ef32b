"""K3, the L1 pool distance (skge_torch/ops/cuda_l1.py, csrc/l1_pool.cu).

On the CPU: the plain backward (`l1_pool_backward_reference`) against
autograd of the plain forward in fp64, exact-zero differences included;
TransE's CPU sweep (`_neg_l1_chunks`), which K3 leaves on its chunked
plain route, bit for bit the chunked code it had before K3; the
wrapper's refusal of CPU tensors; the backward's split choices at the
benchmark cells' shapes.

On the card (marked `cuda`, skipped without one): the kernels against the
plain versions in fp64 at the cells' shapes and at ragged ones, bit-for-bit
repeats, equal rows scoring bit-equal, the +1 sign at exact zeros, the
launch counts of one pool step and one serving batch, and the wrapper's
refusals. This file does not import JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_l1_pool.py
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from skge_torch.models import transe
from skge_torch.models.transe import TransE
from skge_torch.ops import cuda_l1

torch.set_num_threads(1)

U = 2.0**-24  # fp32's unit roundoff

# (B, K, d): ragged, d in {1, 7, 150, 151}
SHAPES = [(1, 1, 1), (3, 5, 7), (17, 9, 150), (6, 13, 151), (33, 1, 7), (1, 33, 150)]


def pool_inputs(b, k, d, seed, dtype=torch.float64):
    """q (b, d), p (k, d) on a coarse grid (many exact-zero differences),
    -0 and +0 entries, a pool row equal to a query row, and G (b, k) of
    mixed sign."""
    rng = np.random.default_rng(seed)
    q = np.round(rng.normal(size=(b, d)) * 4) / 4
    p = np.round(rng.normal(size=(k, d)) * 4) / 4
    q.flat[::5] = -0.0
    p.flat[::3] = 0.0
    p[k // 2] = q[b // 2]
    g = rng.normal(size=(b, k))
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (q, p, g))


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{b}x{k}x{d}" for b, k, d in SHAPES])
def test_plain_backward_is_autograd_of_plain_forward(shape):
    q, p, g = pool_inputs(*shape, seed=sum(shape))
    qq, pp = q.clone().requires_grad_(), p.clone().requires_grad_()
    want = torch.autograd.grad(torch.sum(g * cuda_l1.l1_pool_reference(qq, pp)), [qq, pp])
    got = cuda_l1.l1_pool_backward_reference(q, p, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_plain_backward_sign_is_plus_one_at_both_zeros():
    """q - p = +0 (equal values) and -0 (-0 - +0) both take s = +1."""
    q = torch.tensor([[0.0, -0.0, 1.5, -2.0]], dtype=torch.float64)
    p = torch.tensor([[0.0, 0.0, 1.5, 3.0]], dtype=torch.float64)
    assert torch.signbit(q - p)[0, 1]  # the -0 difference
    dq, dp = cuda_l1.l1_pool_backward_reference(q, p, torch.ones(1, 1, dtype=torch.float64))
    assert dq.tolist() == [[-1.0, -1.0, -1.0, 1.0]]
    assert dp.tolist() == [[1.0, 1.0, 1.0, -1.0]]


def _old_chunks(q, rows, chunk):
    """TransE's L1 sweep as it was before K3: chunks under checkpoint."""
    def blk(q, c):
        d = q[:, None, :] - c[None, :, :]
        return -torch.sum(torch.where(d >= 0, d, -d), dim=-1)

    def one(c):
        if torch.is_grad_enabled() and (q.requires_grad or c.requires_grad):
            return checkpoint(blk, q, c, use_reentrant=False)
        return blk(q, c)

    return torch.cat([one(c) for c in torch.split(rows, chunk)], dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chunk", [5, 512])
def test_cpu_sweep_bit_for_bit_the_chunked_code(dtype, chunk):
    q, p, g = pool_inputs(37, 23, 150, seed=4, dtype=dtype)
    q.mul_(1.0 + 1e-3 * torch.arange(150, dtype=dtype))  # off the grid too
    outs = []
    for fn in (transe._neg_l1_chunks, _old_chunks):
        qq, pp = q.clone().requires_grad_(), p.clone().requires_grad_()
        s = fn(qq, pp, chunk)
        outs.append((s.detach(), *torch.autograd.grad(torch.sum(g * s), [qq, pp])))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(transe._neg_l1_chunks(q, p, chunk), outs[1][0])


def test_cpu_score_pool_modes_is_each_mode():
    """On the CPU, `score_pool_modes` scores mode by mode, each bit for bit
    `score_pool`: no stacking off K3's route."""
    tm = TransE(40, 5, 150)
    q, p, _ = pool_inputs(12, 9, 150, seed=5, dtype=torch.float32)
    rows = {"es": q, "eo": q.flip(0), "rp": q.roll(1, 0)}
    got = tm.score_pool_modes(rows, p, {}, (0, 1))
    for mode, s in zip((0, 1), got):
        assert torch.equal(s, tm.score_pool(rows, p, {}, mode))


def test_wrapper_refuses_off_the_card():
    """`l1_pool` is the kernels' entry and nothing else: a CPU tensor
    raises (TransE's sweep routes it to the plain version), as do shapes
    that do not pair, without a launch."""
    q, p, _ = pool_inputs(5, 4, 7, seed=6, dtype=torch.float32)
    before = cuda_l1.launches, cuda_l1.backward_launches
    with pytest.raises(ValueError, match="on the card only"):
        cuda_l1.l1_pool(q, p)
    with pytest.raises(ValueError):
        cuda_l1.l1_pool(q, p[:, :6])
    with pytest.raises(ValueError):
        cuda_l1.l1_pool(q[0], p)
    assert (cuda_l1.launches, cuda_l1.backward_launches) == before


@pytest.mark.parametrize("case", [
    # (output rows, reduced rows, d, SMs): (td, nsplit)
    ((9_664, 1_024, 150, 132), (5, 4)),    # the pool cell's dq
    ((1_024, 9_664, 150, 132), (5, 33)),   # the pool cell's dp
    ((33, 100, 7, 132), (1, 1)),           # too few reduced rows to split
    ((5, 4_097, 152, 132), (5, 32)),
    ((4_097, 5, 1, 132), (1, 1)),
])
def test_grad_tiling(case):
    args, want = case
    assert cuda_l1.grad_tiling(*args) == want


# --- on the card ---------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _check_against_plain(q, p, g, chunk=512):
    """K3's forward and both gradients against the plain versions in fp64
    on the same fp32 inputs, within fp32's summation bounds: the forward
    sums d terms, each |q - p| rounded once, so |err| <= (d + 1) u sum_d
    |q - p|; a gradient adds +-G exactly, over the reduced rows in order
    within a split, then the splits (fewer than 64 here), so |err| <= (n +
    64) u sum |G| for n reduced rows."""
    qq, pp = q.clone().requires_grad_(), p.clone().requires_grad_()
    s = cuda_l1.l1_pool(qq, pp)
    dq, dp = torch.autograd.grad(s, [qq, pp], g)
    q64, p64, g64 = q.double(), p.double(), g.double()
    dp_want = torch.zeros_like(p64)
    for lo in range(0, q.shape[0], chunk):
        qs, gs = q64[lo:lo + chunk], g64[lo:lo + chunk]
        want = cuda_l1.l1_pool_reference(qs, p64)
        assert ((s[lo:lo + chunk].double() - want).abs()
                <= (q.shape[1] + 1) * U * want.abs()).all()
        dq_want, part = cuda_l1.l1_pool_backward_reference(qs, p64, gs)
        dp_want += part
        bound = (p.shape[0] + 64) * U * gs.abs().sum(1, keepdim=True)
        assert ((dq[lo:lo + chunk].double() - dq_want).abs() <= bound).all()
    bound = (q.shape[0] + 64) * U * g64.abs().sum(0)[:, None]
    assert ((dp.double() - dp_want).abs() <= bound).all()
    return s, dq, dp


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (4_832, 1_024, 150),   # the pool cell, a mode
    (9_664, 1_024, 150),   # the pool cell, both modes stacked
    (1_024, 14_951, 150),  # the serve cell's batch
    (1, 33, 150), (33, 1, 151), (4_097, 33, 152), (33, 4_097, 1), (1, 1, 1),
    (4_097, 1, 150), (1, 4_097, 151), (33, 33, 152),
])
def test_kernels_match_plain_on_card(shape):
    dev = _card()
    b, k, d = shape
    rng = np.random.default_rng(b + k + d)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
    p = torch.as_tensor(rng.normal(size=(k, d)).astype(np.float32), device=dev)
    g = torch.as_tensor(rng.normal(size=(b, k)).astype(np.float32), device=dev)
    _check_against_plain(q, p, g, chunk=max(1, 2**27 // max(k * d, 1)))
    # a 0/1 G, as the margin loss gives: every partial sum an exact integer
    g01 = (g > 0.5).to(torch.float32)
    _, dq, dp = _check_against_plain(q, p, g01, chunk=max(1, 2**27 // max(k * d, 1)))
    assert torch.equal(dq, dq.round()) and torch.equal(dp, dp.round())


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit_on_card():
    dev = _card()
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.normal(size=(9_664, 150)).astype(np.float32), device=dev)
    p = torch.as_tensor(rng.normal(size=(1_024, 150)).astype(np.float32), device=dev)
    g = torch.as_tensor(rng.normal(size=(9_664, 1_024)).astype(np.float32), device=dev)
    runs = []
    for _ in range(2):
        qq, pp = q.clone().requires_grad_(), p.clone().requires_grad_()
        s = cuda_l1.l1_pool(qq, pp)
        runs.append((s.detach(), *torch.autograd.grad(s, [qq, pp], g)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_equal_rows_score_bit_equal_on_card():
    """Copied table rows score bit-equal against every query (the serve
    check's lower-id rule on ties relies on it)."""
    dev = _card()
    rng = np.random.default_rng(2)
    e = rng.normal(size=(14_951, 150)).astype(np.float32)
    src = rng.choice(14_951, 64, replace=False)
    dst = rng.choice(np.setdiff1d(np.arange(14_951), src), 64, replace=False)
    e[dst] = e[src]
    q = torch.as_tensor(rng.normal(size=(1_024, 150)).astype(np.float32), device=dev)
    s = cuda_l1.l1_pool(q, torch.as_tensor(e, device=dev))
    assert torch.equal(s[:, dst], s[:, src])


@pytest.mark.cuda
def test_exact_zero_differences_take_plus_one_on_card():
    dev = _card()
    q = torch.tensor([[0.0, -0.0, 1.5, -2.0, 0.25]], device=dev).repeat(3, 1)
    p = torch.tensor([[0.0, 0.0, 1.5, 3.0, 0.25]], device=dev).repeat(2, 1)
    qq, pp = q.clone().requires_grad_(), p.clone().requires_grad_()
    s = cuda_l1.l1_pool(qq, pp)
    dq, dp = torch.autograd.grad(s, [qq, pp], torch.ones(3, 2, device=dev))
    assert s.tolist() == [[-5.0] * 2] * 3
    assert dq.tolist() == [[-2.0, -2.0, -2.0, 2.0, -2.0]] * 3
    assert dp.tolist() == [[3.0, 3.0, 3.0, -3.0, 3.0]] * 2


@pytest.mark.cuda
def test_launch_counts_of_a_pool_step_and_a_serve_batch_on_card():
    from skge_torch.models import MODELS
    from skge_torch.optim import AdaGrad
    from skge_torch.sampling import SharedNegativeSampler
    from skge_torch.serving import LinkPredictor
    from skge_torch.training import TrainState, make_pairwise_step

    dev = _card()
    n_e, n_r, d, b = 2_000, 30, 150, 512
    model = MODELS["transe"](n_e, n_r, d)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(gen)
    opt = AdaGrad(lr=0.1)
    step = make_pairwise_step(model, opt, SharedNegativeSampler(n_e, k=256, modes=(0, 1)),
                              margin=1.0, aggregate="dense")
    rng = np.random.default_rng(3)
    batch = torch.as_tensor(np.stack([rng.integers(0, n_e, b), rng.integers(0, n_e, b),
                                      rng.integers(0, n_r, b)], 1), device=dev)
    counts = lambda: (cuda_l1.launches, cuda_l1.backward_launches)
    before = counts()
    step(TrainState(params, opt.init(params), gen, 0), batch, torch.ones(b, device=dev))
    torch.cuda.synchronize()
    # both modes in one forward; dq and dp in the backward
    assert tuple(a - c for a, c in zip(counts(), before)) == (1, 2)
    lp = LinkPredictor(model, params, known=batch.cpu().numpy(),
                       batch_size=256, device=dev)
    before = counts()
    lp.top_k(np.stack([rng.integers(0, n_e, 200), rng.integers(0, n_r, 200)], 1), 10)
    assert tuple(a - c for a, c in zip(counts(), before)) == (1, 0)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernels_do_not_take_on_card():
    dev = _card()
    q = torch.zeros(8, 150, device=dev)
    p = torch.zeros(16, 150, device=dev)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError):
            cuda_l1.l1_pool(q.to(dtype), p.to(dtype))
    with pytest.raises(ValueError):
        cuda_l1.l1_pool(torch.zeros(150, 8, device=dev).T, p)
    with pytest.raises(ValueError):
        cuda_l1.l1_pool(q, torch.zeros(150, 16, device=dev).T)
    # TransE's sweep in bfloat16 on the card keeps the plain chunked route
    before = cuda_l1.launches
    transe._neg_l1_chunks(q.bfloat16(), p.bfloat16(), transe.POOL_CHUNK)
    assert cuda_l1.launches == before
