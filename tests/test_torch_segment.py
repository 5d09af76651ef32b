"""The port's segment sum (skge_torch/ops/cuda_segment.py) against the JAX
package's Pallas kernel `segment_sum_pallas`, run in interpret mode.

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
}


@pytest.mark.parametrize("case", list(CASES))
def test_segment_sum_matches_pallas(case, monkeypatch):
    import jax.numpy as jnp
    from skge_tpu.ops import pallas_segment as ps

    t, r, d, lo, hi, budget = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    idx = rng.integers(lo, hi, t)
    if case == "out_of_range_dropped":
        idx[::5] = r  # the padding convention
    g = rng.normal(size=(t, d)).astype(np.float32)
    if budget is not None:
        monkeypatch.setattr(ps, "_VMEM_BUDGET", budget)  # forces column tiles
        assert ps._col_tile(r, d, 1024) < 640
    want = ps.segment_sum_pallas(
        jnp.asarray(idx, jnp.int32), jnp.asarray(g), r, chunk=1024,
        interpret=True,
    )
    got = cuda_segment.segment_sum(torch.as_tensor(idx), torch.as_tensor(g), r)
    assert got.dtype == torch.float32 and got.shape == (r, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


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


@pytest.mark.cuda
def test_segment_sum_deterministic_variant_on_card():
    """Under deterministic algorithms the sorted variant runs: two calls
    equal bit for bit, within 1e-5 of the plain version, on both paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    rng = np.random.default_rng(8)
    # (t, r, d, low id, high id, storage offset in floats, 16-byte path)
    for t, r, d, lo, hi, shift, vector in [
        (10_688, 14_951, 104, 0, 14_951, 0, True),  # RESCAL's E, a hot pool
        (15_520, 16_296, 152, -50, 16_346, 0, True),
        (15_520, 16_296, 151, 0, 16_296, 0, False),
        (15_520, 16_296, 152, 0, 16_296, 1, False),
        (4_832, 1_345, 1, 0, 1_345, 0, False),
        (64, 17, 22_500, 0, 19, 0, True),
        (0, 10, 5, 0, 10, 0, False),
    ]:
        idx = torch.as_tensor(rng.integers(lo, hi, t), device="cuda")
        flat = torch.as_tensor(
            rng.normal(size=t * d + shift).astype(np.float32), device="cuda"
        )
        g = flat[shift:].view(t, d)
        before = (cuda_segment.launches, cuda_segment.vector_launches,
                  cuda_segment.deterministic_launches)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            got = [cuda_segment.segment_sum(idx, g, r) for _ in range(2)]
        finally:
            torch.use_deterministic_algorithms(False)
        torch.cuda.synchronize()
        n = 2 if t else 0
        assert (cuda_segment.launches, cuda_segment.vector_launches,
                cuda_segment.deterministic_launches) == (
            before[0] + n, before[1] + (n if vector else 0), before[2] + n)
        assert torch.equal(got[0], got[1])
        want = cuda_segment.segment_sum_reference(idx, g, r)
        torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)
