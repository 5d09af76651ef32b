"""The port's segment sum (skge_torch/ops/cuda_segment.py) against the JAX
package's Pallas kernel `segment_sum_pallas`, run in interpret mode: the
plain version, and the plain version in the deterministic variant's exact
order (`segment_sum_ordered_reference`, chunks of CHUNK occurrences), which
the variant equals bit for bit on the card. The grouping by row
(skge_torch/ops/grouping.py) against numpy's stable argsort.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
checked against that plain version on the card (marked `cuda`), on its
16-byte path (D % 4 == 0, aligned) and on its scalar path.
fp32, tolerance rtol = atol = 1e-5 as in tests/test_pallas.py.

JAX is imported inside the parity test only, so that the card test also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_segment.py
"""

import numpy as np
import pytest
import torch

from skge_torch.ops import cuda_segment

torch.set_num_threads(1)

# (name, t, r, d, low id, high id (exclusive), forced VMEM budget or None)
CASES = {
    "small": (64, 16, 8, 0, 16, None),
    "fb15k_width": (1000, 37, 152, 0, 37, None),
    "several_chunks": (4096, 200, 24, 0, 200, None),
    "out_of_range_dropped": (512, 20, 16, 0, 24, None),
    "negative_dropped": (512, 20, 16, -4, 20, None),
    "tail_chunk": (1500, 40, 8, 0, 40, None),
    "wide_column_tiles": (300, 17, 520, 0, 19, 2 << 20),
    # the deterministic variant's chunks: runs longer than CHUNK, all of T
    # on one row, rows with no occurrence
    "runs_longer_than_chunk": (1500, 6, 12, 0, 6, None),
    "all_on_one_row": (700, 9, 20, 4, 5, None),
    "empty_rows": (300, 2000, 8, 0, 2000, None),
}


def case_inputs(case):
    t, r, d, lo, hi, _ = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    idx = rng.integers(lo, hi, t)
    if case == "out_of_range_dropped":
        idx[::5] = r  # the padding convention
    if case == "runs_longer_than_chunk":
        idx[rng.permutation(t)[: t // 2]] = 2  # one row of > 5 chunks
    g = rng.normal(size=(t, d)).astype(np.float32)
    return idx, g, r


def pallas_sum(case, idx, g, r, monkeypatch):
    import jax.numpy as jnp
    from skge_tpu.ops import pallas_segment as ps

    t, _, d, _, _, budget = CASES[case]
    if budget is not None:
        monkeypatch.setattr(ps, "_VMEM_BUDGET", budget)  # forces column tiles
        assert ps._col_tile(r, d, 1024) < 640
    return np.asarray(ps.segment_sum_pallas(
        jnp.asarray(idx, jnp.int32), jnp.asarray(g), r, chunk=1024,
        interpret=True,
    ))


def in_order_sum(idx, g, r):
    """Each row's occurrences added one at a time, in order (numpy)."""
    out = np.zeros((r, g.shape[1]), g.dtype)
    for i, row in zip(idx, g):
        if 0 <= i < r:
            out[i] += row
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_segment_sum_matches_pallas(case, monkeypatch):
    idx, g, r = case_inputs(case)
    want = pallas_sum(case, idx, g, r, monkeypatch)
    got = cuda_segment.segment_sum(torch.as_tensor(idx), torch.as_tensor(g), r)
    assert got.dtype == torch.float32 and got.shape == (r, g.shape[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_segment_sum_ordered_matches_pallas(case, monkeypatch):
    """The deterministic variant's order: within 1e-5 of the TPU kernel, and
    bit for bit an in-order loop on every row of <= CHUNK occurrences."""
    idx, g, r = case_inputs(case)
    want = pallas_sum(case, idx, g, r, monkeypatch)
    got = cuda_segment.segment_sum_ordered_reference(
        torch.as_tensor(idx), torch.as_tensor(g), r).numpy()
    assert got.dtype == np.float32 and got.shape == (r, g.shape[1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    counts = np.bincount(idx[(idx >= 0) & (idx < r)], minlength=r)
    short = counts <= cuda_segment.CHUNK
    assert np.array_equal(got[short], in_order_sum(idx, g, r)[short])
    assert (counts > cuda_segment.CHUNK).any() == (case in (
        "runs_longer_than_chunk", "all_on_one_row"))


# name: (T, R, D, low id, high id): fp64, the chunked order against an
# in-order sum
ORDERED_FP64 = {
    "hot_row": (3000, 7, 5, 0, 7),
    "all_on_one_row": (1000, 4, 3, 2, 3),
    "dropped_and_empty": (900, 500, 4, -40, 540),
}


@pytest.mark.parametrize("case", list(ORDERED_FP64))
def test_segment_sum_ordered_fp64_against_in_order_sum(case):
    t, r, d, lo, hi = ORDERED_FP64[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    idx = rng.integers(lo, hi, t)
    if case == "hot_row":
        idx[rng.permutation(t)[: 2 * t // 3]] = 5
    g = rng.normal(size=(t, d))
    got = cuda_segment.segment_sum_ordered_reference(
        torch.as_tensor(idx), torch.as_tensor(g), r)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), in_order_sum(idx, g, r), rtol=1e-9, atol=1e-9)


# name: (ids, num_rows); ids as numpy draws (T, low, high) where a tuple
GROUPS = {
    "mixed": ([3, -1, 0, 3, 5, 2, 0, -7, 3, 4], 5),
    "empty": ([], 4),
    "all_dropped": ([-2, 6, 9, -1, 6], 6),
    "one_row_hot": ((2000, 3, 4), 9),
    "dropped_both_sides": ((3000, -100, 1100), 1000),
    "int32_keys": ((4000, -5, 70_000), 65_000),
}


@pytest.mark.parametrize("case", list(GROUPS))
def test_group_by_row_matches_numpy(case):
    from skge_torch.ops import grouping

    ids, r = GROUPS[case]
    if isinstance(ids, tuple):
        ids = np.random.default_rng(sum(map(ord, case))).integers(ids[1], ids[2], ids[0])
    ids = np.asarray(ids, np.int64)
    keys = np.clip(ids, -1, r)
    want_perm = np.argsort(keys, kind="stable")
    want_offsets = np.searchsorted(keys[want_perm], np.arange(r + 1), side="left")
    perm, offsets = grouping.group_by_row(torch.as_tensor(ids), r)
    assert perm.dtype == offsets.dtype == torch.int64
    assert np.array_equal(perm.numpy(), want_perm)
    assert np.array_equal(offsets.numpy(), want_offsets)


def test_segment_sum_plain_takes_fp64_and_rejects_bad_input():
    rng = np.random.default_rng(5)
    idx = torch.as_tensor(rng.integers(-2, 12, 300))
    g = torch.as_tensor(rng.normal(size=(300, 3)))
    out = cuda_segment.segment_sum(idx, g, 10)
    want = np.zeros((10, 3))
    for i, row in zip(idx.numpy(), g.numpy()):
        if 0 <= i < 10:
            want[i] += row
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError):
        cuda_segment.segment_sum(idx.to(torch.int32), g, 10)
    with pytest.raises(ValueError):
        cuda_segment.segment_sum(idx[:-1], g, 10)


@pytest.mark.cuda
def test_segment_sum_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    rng = np.random.default_rng(6)
    # (t, r, d, low id, high id, storage offset in floats, 16-byte path)
    for t, r, d, lo, hi, shift, vector in [
        (15_520, 16_296, 152, 0, 16_296, 0, True),
        (91_808, 16_296, 152, 0, 16_296, 0, True),   # the iid TransE step
        (15_520, 16_296, 152, -50, 16_346, 0, True),
        (15_520, 16_296, 151, 0, 16_296, 0, False),  # D % 4 != 0
        (15_520, 16_296, 152, 0, 16_296, 1, False),  # a misaligned view
        (1001, 40, 37, 0, 40, 0, False),
        (15_520, 16_296, 1, 0, 16_296, 0, False),
        (64, 17, 22_500, 0, 19, 0, True),
        (0, 10, 5, 0, 10, 0, False),
    ]:
        idx = torch.as_tensor(rng.integers(lo, hi, t), device="cuda")
        flat = torch.as_tensor(
            rng.normal(size=t * d + shift).astype(np.float32), device="cuda"
        )
        g = flat[shift:].view(t, d)
        before = cuda_segment.launches, cuda_segment.vector_launches
        got = cuda_segment.segment_sum(idx, g, r)
        torch.cuda.synchronize()
        launched = 1 if t else 0
        assert (cuda_segment.launches, cuda_segment.vector_launches) == (
            before[0] + launched, before[1] + (launched if vector else 0))
        want = cuda_segment.segment_sum_reference(idx, g, r)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_segment_sum_plain_under_deterministic_algorithms():
    """A CPU tensor takes the plain version whether or not deterministic
    algorithms are on, and launches nothing."""
    rng = np.random.default_rng(7)
    idx = torch.as_tensor(rng.integers(-3, 40, 2000))
    g = torch.as_tensor(rng.normal(size=(2000, 12)).astype(np.float32))
    before = (cuda_segment.launches, cuda_segment.deterministic_launches)
    torch.use_deterministic_algorithms(True)
    try:
        got = cuda_segment.segment_sum(idx, g, 37)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(got, cuda_segment.segment_sum_reference(idx, g, 37))
    assert (cuda_segment.launches, cuda_segment.deterministic_launches) == before


# rows of more occurrences than this (only the hot-row and one-row cases
# below, of 4,832 to 12,000) are held to their fp32 summation bound instead
# of 1e-5: two fp32 orders of 5,344 terms parted by 1.1e-4 on the card
LONG_ROW = 1024


def held_to_plain(got, idx, g, r, chunked):
    """Rows of at most LONG_ROW occurrences within 1e-5 of the plain
    version; a longer row against the fp64 sum within its fp32 summation
    error bound, (m - 1) * 2^-24 * sum |x| for m - 1 adds (CHUNK + chunks -
    2 in the chunked order): two fp32 orders of thousands of terms part by
    more than 1e-5."""
    want = cuda_segment.segment_sum_reference(idx, g, r)
    counts = torch.bincount(idx[(idx >= 0) & (idx < r)], minlength=r)
    short = counts <= LONG_ROW
    torch.testing.assert_close(got[short], want[short], rtol=1e-5, atol=1e-5)
    long = ~short
    if long.any():
        exact = cuda_segment.segment_sum_reference(idx, g.double(), r)[long]
        absum = cuda_segment.segment_sum_reference(idx, g.double().abs(), r)[long]
        n = counts[long]
        adds = (cuda_segment.CHUNK + (n + cuda_segment.CHUNK - 1) // cuda_segment.CHUNK
                if chunked else n + 1) - 2
        assert ((got[long].double() - exact).abs()
                <= adds[:, None] * 2.0**-24 * absum).all()


@pytest.mark.cuda
def test_segment_sum_deterministic_variant_on_card():
    """Under deterministic algorithms the deterministic variant runs: two
    calls equal bit for bit, equal bit for bit to the plain version in the
    same order, within 1e-5 of the plain version, on both paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    rng = np.random.default_rng(8)
    # (t, r, d, low id, high id, storage offset in floats, 16-byte path,
    # share of T moved to row 0)
    for t, r, d, lo, hi, shift, vector, hot in [
        (10_688, 14_951, 104, 0, 14_951, 0, True, 0.0),  # RESCAL's E, a hot pool
        (16_469, 505_128, 68, 0, 505_128, 0, True, 0.0),  # the 1M flagship's step
        (15_520, 16_296, 152, -50, 16_346, 0, True, 0.0),
        (15_520, 16_296, 151, 0, 16_296, 0, False, 0.0),
        (15_520, 16_296, 152, 0, 16_296, 1, False, 0.0),
        (4_832, 1_345, 1, 0, 1_345, 0, False, 0.0),
        (10_688, 14_951, 104, 0, 14_951, 0, True, 0.5),  # a hot row
        (10_688, 14_951, 104, 0, 1, 0, True, 0.0),  # all of T on one row
        (4_832, 1_345, 1, 0, 1, 0, False, 0.0),
        (40_000, 2_000, 8, 0, 2_000, 0, True, 0.3),  # 20 sorted tiles merged
        (64, 17, 22_500, 0, 19, 0, True, 0.0),  # wide rows
        (4_832, 1_345, 22_500, 0, 1_345, 0, True, 0.0),  # full-rank TransR's M
        (0, 10, 5, 0, 10, 0, False, 0.0),
    ]:
        idx = torch.as_tensor(rng.integers(lo, hi, t), device="cuda")
        if hot:
            idx[torch.as_tensor(rng.permutation(t)[: int(hot * t)], device="cuda")] = 0
        flat = torch.as_tensor(
            rng.normal(size=t * d + shift).astype(np.float32), device="cuda"
        )
        g = flat[shift:].view(t, d)
        before = (cuda_segment.launches, cuda_segment.vector_launches,
                  cuda_segment.deterministic_launches, cuda_segment.combine_launches)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            got = [cuda_segment.segment_sum(idx, g, r) for _ in range(2)]
        finally:
            torch.use_deterministic_algorithms(False)
        torch.cuda.synchronize()
        n = 2 if t else 0
        assert (cuda_segment.launches, cuda_segment.vector_launches,
                cuda_segment.deterministic_launches, cuda_segment.combine_launches) == (
            before[0] + n, before[1] + (n if vector else 0), before[2] + n,
            before[3] + (n if t > cuda_segment.CHUNK else 0))
        assert torch.equal(got[0], got[1])
        assert torch.equal(got[0], cuda_segment.segment_sum_ordered_reference(idx, g, r))
        held_to_plain(got[0], idx, g, r, chunked=True)


@pytest.mark.cuda
def test_group_by_row_kernel_on_card():
    """The grouping kernels equal the plain stable sort exactly, in int32
    and int64: one tile, tiles merged (up to 69 of them), and T=0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from skge_torch.ops import grouping

    rng = np.random.default_rng(9)
    for t, r, lo, hi in [(10_688, 14_951, 0, 14_951), (16_469, 505_128, -9, 505_200),
                         (4_832, 1_345, 0, 1), (20_480, 3, -2, 6), (1, 5, 0, 5),
                         (91_808, 16_296, 0, 16_296), (140_000, 16_296, -3, 16_300),
                         (0, 5, 0, 5)]:
        idx = torch.as_tensor(rng.integers(lo, hi, t), device="cuda")
        want_perm, want_offsets = grouping.group_by_row_reference(idx, r)
        before = grouping.launches
        for dtype in (torch.int32, torch.int64):
            keys, perm, offsets = grouping.group(idx, r, dtype)
            assert perm.dtype == offsets.dtype == dtype and keys.dtype == torch.int32
            assert torch.equal(perm.long(), want_perm)
            assert torch.equal(offsets.long(), want_offsets)
            assert torch.equal(keys.long(), idx.clamp(-1, r)[want_perm])
        assert grouping.launches - before == 2
