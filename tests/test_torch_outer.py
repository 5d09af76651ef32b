"""The port's segment outer sum (skge_torch/ops/cuda_outer.py) against the
JAX package's Pallas kernel `segment_outer_sum_pallas`, run in interpret
mode.

On the CPU the port's wrapper runs its plain version, which adds each
row's occurrences in order, as the TPU kernel does: in fp32 it equals the
loop below bit for bit, and the Pallas kernel at rtol 2e-5, atol 2e-4 as in
tests/test_factored.py. The CUDA kernel is checked on the card (marked
`cuda`) to equal that plain version bit for bit.

JAX is imported inside the parity test only, so that the card test also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_outer.py
"""

import numpy as np
import pytest
import torch

from skge_torch.ops import cuda_outer

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-4)

# name: (t, r, d, rank, low id, high id (exclusive))
CASES = {
    "rank1": (1024, 17, 16, 1, 0, 17),
    "rank2_ids_at_or_above_r_dropped": (2048, 17, 36, 2, 0, 20),
    "negative_ids_dropped": (1024, 11, 16, 2, -3, 11),
    "ragged_t": (1001, 40, 12, 2, 0, 40),
    "few_rows": (2048, 3, 20, 2, 0, 3),
}


def factors(seed, t, d, rank):
    rng = np.random.default_rng(seed)
    return (
        tuple(rng.standard_normal((t, d)).astype(np.float32) for _ in range(rank)),
        tuple(rng.standard_normal((t, d)).astype(np.float32) for _ in range(rank)),
    )


def loop_reference(idx, us, vs, r):
    d = us[0].shape[1]
    want = np.zeros((r, d, d), us[0].dtype)
    for t, i in enumerate(idx):
        if 0 <= i < r:
            want[i] += sum(np.outer(u[t], v[t]) for u, v in zip(us, vs))
    return want


def case_inputs(case):
    t, r, d, rank, lo, hi = CASES[case]
    seed = sum(map(ord, case))
    idx = np.random.default_rng(seed).integers(lo, hi, t)
    return idx, *factors(seed + 1, t, d, rank), r


@pytest.mark.parametrize("case", list(CASES))
def test_segment_outer_sum_plain_is_the_in_order_loop(case):
    idx, us, vs, r = case_inputs(case)
    got = cuda_outer.segment_outer_sum(
        torch.as_tensor(idx), tuple(map(torch.as_tensor, us)),
        tuple(map(torch.as_tensor, vs)), r,
    )
    assert np.array_equal(got.numpy(), loop_reference(idx, us, vs, r))


# name: (ids, num_rows)
GROUPS = {
    "mixed": ([3, -1, 0, 3, 5, 2, 0, -7, 3, 4], 5),
    "empty": ([], 4),
    "all_dropped": ([-2, 6, 9, -1, 6], 6),
    "one_row": ([1, 1, 1, 1], 3),
    "int16_keys": ([150, -1, 3, 150, 40_000, 199, 3], 200),
    "int32_keys": ([70_000, 5, 32_767, -9, 5, 39_999], 40_000),
}


@pytest.mark.parametrize("case", list(GROUPS))
def test_group_by_row_is_a_stable_order_with_exact_offsets(case):
    ids, r = GROUPS[case]
    idx = torch.tensor(ids, dtype=torch.int64)
    perm, offsets = cuda_outer.group_by_row(idx, r)
    assert offsets.dtype == torch.int64 and offsets.shape == (r + 1,)
    assert sorted(perm.tolist()) == list(range(len(ids)))
    for row in range(r):
        run = perm[offsets[row]:offsets[row + 1]].tolist()
        assert run == [t for t, i in enumerate(ids) if i == row]  # in order
    kept = perm[offsets[0]:offsets[r]].tolist()
    assert sorted(kept) == [t for t, i in enumerate(ids) if 0 <= i < r]
    assert all(ids[t] < 0 for t in perm[:offsets[0]].tolist())
    assert all(ids[t] >= r for t in perm[offsets[r]:].tolist())


@pytest.mark.parametrize("case", list(CASES))
def test_segment_outer_sum_matches_pallas(case):
    import jax.numpy as jnp
    from skge_tpu.ops.pallas_outer import segment_outer_sum_pallas

    idx, us, vs, r = case_inputs(case)
    d = us[0].shape[1]
    want = segment_outer_sum_pallas(
        jnp.asarray(idx, jnp.int32), tuple(map(jnp.asarray, us)),
        tuple(map(jnp.asarray, vs)), r, interpret=True,
    )
    got = cuda_outer.segment_outer_sum(
        torch.as_tensor(idx), tuple(map(torch.as_tensor, us)),
        tuple(map(torch.as_tensor, vs)), r,
    )
    assert got.dtype == torch.float32 and got.shape == (r, d, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segment_outer_sum_plain_takes_fp64_and_empty_input():
    rng = np.random.default_rng(5)
    idx = rng.integers(-2, 9, 120)
    us, vs = factors(6, 120, 5, 2)
    us, vs = tuple(u.astype(np.float64) for u in us), tuple(v.astype(np.float64) for v in vs)
    got = cuda_outer.segment_outer_sum(
        torch.as_tensor(idx), tuple(map(torch.as_tensor, us)),
        tuple(map(torch.as_tensor, vs)), 7,
    )
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), loop_reference(idx, us, vs, 7),
                               rtol=1e-12, atol=1e-12)
    empty = cuda_outer.segment_outer_sum(
        torch.zeros(0, dtype=torch.int64), (torch.zeros(0, 4),), (torch.zeros(0, 4),), 3
    )
    assert empty.shape == (3, 4, 4) and not empty.any()


def test_segment_outer_sum_rejects_bad_input():
    idx = torch.arange(6)
    u = torch.ones(6, 4)
    f = cuda_outer.segment_outer_sum
    with pytest.raises(TypeError):
        f(idx.to(torch.int32), (u,), (u,), 6)
    with pytest.raises(TypeError):
        f(idx, (u.half(),), (u.half(),), 6)
    with pytest.raises(TypeError):
        f(idx, (u,), (u.double(),), 6)
    with pytest.raises(ValueError):
        f(idx, (u, u), (u,), 6)
    with pytest.raises(ValueError):
        f(idx, (), (), 6)
    with pytest.raises(ValueError):
        f(idx[:-1], (u,), (u,), 6)
    with pytest.raises(ValueError):
        f(idx, (u,), (torch.ones(6, 5),), 6)
    with pytest.raises(ValueError):
        f(idx, (u,), (u,), -1)


@pytest.mark.cuda
def test_segment_outer_sum_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    rng = np.random.default_rng(7)
    for t, r, d, rank, lo, hi, skew in [
        (4832, 1345, 100, 2, 0, 1345, None),      # RESCAL at FB15k widths
        (4832, 18, 100, 2, 0, 18, None),          # WN18's 18 relations: long rows
        (4832, 18, 100, 2, 0, 18, "half"),        # half of T on row 0: slabs
        (4832, 18, 100, 1, 0, 18, "half"),
        (1001, 5, 37, 3, 0, 5, "half"),           # slabs with 4-byte staging
        (2000, 9, 12, 4, 0, 9, "half"),           # slabs past d: the last empty
        (4832, 18, 100, 2, 0, 1, None),           # all of T on row 0: the longest chain
        (3000, 4, 37, 3, 0, 1, None),
        (4832, 1345, 100, 2, 0, 1345, "zipf"),    # long rows with neighbouring ids
        (4832, 1345, 100, 2, -50, 1395, None),    # ids < 0 and >= R dropped
        (4832, 1345, 100, 1, 0, 1345, None),
        (1001, 40, 37, 2, 0, 40, None),           # ragged T, d = 37: 4-byte staging
        (300, 7, 1100, 3, 0, 7, None),            # 55 x 55 tiles of 20 x 20
        (500, 9, 12, 4, 0, 9, None),
        (40, 5000, 8, 2, 0, 5000, None),          # T < R: windows of empty rows
        (0, 10, 5, 2, 0, 10, None),
    ]:
        ids = rng.integers(lo, hi, t)
        if skew == "half":
            ids[rng.permutation(t)[: t // 2]] = 0
        if skew == "zipf":
            p = 1.0 / np.arange(1, r + 1)
            ids = rng.choice(r, size=t, p=p / p.sum())
        idx = torch.as_tensor(ids, device="cuda")
        us, vs = (tuple(torch.as_tensor(a, device="cuda") for a in fs)
                  for fs in factors(t + r, t, d, rank))
        before = cuda_outer.launches
        got = cuda_outer.segment_outer_sum(idx, us, vs, r)
        again = cuda_outer.segment_outer_sum(idx, us, vs, r)
        torch.cuda.synchronize()
        assert cuda_outer.launches == before + (2 if t else 0)
        want = cuda_outer.segment_outer_sum_reference(idx, us, vs, r)
        assert torch.equal(got, want), (t, r, d, rank)
        assert torch.equal(got, again), (t, r, d, rank)
    with pytest.raises(TypeError):
        u = torch.ones(3, 4, device="cuda", dtype=torch.float64)
        cuda_outer.segment_outer_sum(torch.arange(3, device="cuda"), (u,), (u,), 3)
    with pytest.raises(ValueError):
        u = torch.ones(3, 4, device="cuda")
        cuda_outer.segment_outer_sum(torch.arange(3, device="cuda"), (u,) * 5, (u,) * 5, 3)
