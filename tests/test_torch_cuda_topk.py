"""The top k of a score tile (skge_torch/ops/cuda_topk.py, csrc/top_k.cu)
and serving's route to it (`skge_torch.serving._top_k`).

On the CPU: the route takes the plain version, which is the rule the
engines had (a stable descending sort's first k), the epilogue's
(-inf, -1) for filtered winners, one route call a served tile on every
engine, the wrapper's refusals, and an import that builds nothing.

On the card (marked `cuda`, skipped without one): the kernel against the
plain version, values (sign bits too) and positions `torch.equal`, at the
serve cell's shape (1,024 x 14,951) with copied columns so that rows tie,
rows with NEG_INF cells and fewer eligible cells than k, a row of +0.0 and
-0.0, all-equal rows, k of 1, 10, 64, 1,000 and n, rows shorter than a
block, an fp64 tile, and the streamed fold's and the sharded merge's
shapes; one launch a call; one launch a batch through `LinkPredictor`.
This file does not import JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_topk.py
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from skge_torch import serving
from skge_torch.models import MODELS
from skge_torch.ops import cuda_topk

NEG_INF = cuda_topk.NEG_INF
ROOT = Path(__file__).resolve().parents[1]
plain = cuda_topk.top_k_reference


def stable_top(scores, k):
    """The first k of a stable descending sort: value, then column."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def tied_ints(seed=41, shape=(50, 40), dtype=torch.float64):
    """Integer-valued scores with many ties (the serving tie test's inputs)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 6, shape).astype(np.float64)).to(dtype)


def edge_rows(n, dtype=torch.float32, seed=0):
    """Rows that test the rule: copied columns, NEG_INF cells, fewer
    eligible cells than 10, +0.0 beside -0.0, all equal, -inf."""
    g = torch.Generator().manual_seed(seed)
    s = torch.randn(8, n, generator=g, dtype=dtype)
    half, w = n // 2, min(5, n // 2)
    s[:, half:half + w] = s[:, :w]
    s[1, ::3] = NEG_INF
    s[2, 4:] = NEG_INF
    s[3] = 0.0
    s[3, ::2] = -0.0
    s[4] = 2.5
    s[5, 3:] = -float("inf")
    s[6, 1::2] = s[6, ::2][: n // 2]
    return s


def equal(got, want):
    return (all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
            and torch.equal(torch.signbit(got[0]), torch.signbit(want[0])))


# --- on the CPU -------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 17, 40])
def test_reference_is_the_stable_sort_rule_on_the_tie_test_inputs(k):
    scores = tied_ints()
    want = stable_top(scores, k)
    assert equal(cuda_topk.top_k_reference(scores, k), want)
    assert equal(serving._top_k(scores, k), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 10, 37])
def test_route_off_the_card_takes_the_plain_version(dtype, k, monkeypatch):
    scores = edge_rows(37, dtype)
    calls = []
    real = cuda_topk.top_k_reference
    monkeypatch.setattr(cuda_topk, "top_k_reference",
                        lambda s, kk, mask=False: calls.append((kk, mask)) or real(s, kk, mask))
    before = cuda_topk.launches
    vals, pos = serving._top_k(scores, k)
    assert pos.dtype == torch.int64 and equal((vals, pos), stable_top(scores, k))
    mvals, ids = serving._top_k(scores, k, mask=True)
    bad = vals <= NEG_INF
    assert ids.dtype == torch.int32
    assert torch.equal(ids, torch.where(bad, -1, pos).to(torch.int32))
    assert torch.equal(mvals, torch.where(bad, -float("inf"), vals))
    assert calls == [(k, False), (k, True)] and cuda_topk.launches == before


def test_mask_invalid_marks_filtered_winners():
    vals = torch.tensor([[3.0, NEG_INF, -float("inf")], [NEG_INF * 0.999, -1e29, 0.0]])
    ids = torch.tensor([[4, 7, 9], [1, 2, 3]], dtype=torch.int32)
    mvals, mids = cuda_topk.mask_invalid(vals, ids)
    assert mids.tolist() == [[4, -1, -1], [1, 2, 3]]
    assert torch.isneginf(mvals[0, 1:]).all() and torch.equal(mvals[1], vals[1])


@pytest.mark.parametrize("engine", ["in-core", "streamed"])
def test_engines_route_one_top_k_a_served_tile(engine, monkeypatch):
    """One route call a batch (a chunk, streamed), with the epilogue folded
    into the in-core engine's only; the results those of a stable sort of
    the whole filtered tile."""
    n_e, n_r = 97, 5
    model = MODELS["transe"](n_e, n_r, 8)
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    q = np.stack([rng.integers(0, n_e, 37), rng.integers(0, n_r, 37)], 1)
    known = np.stack([rng.integers(0, n_e, 400), rng.integers(0, n_e, 400),
                      rng.integers(0, n_r, 400)], 1)
    calls = []
    real = serving._top_k
    monkeypatch.setattr(serving, "_top_k",
                        lambda s, k, mask=False: calls.append((s.shape[1], mask))
                        or real(s, k, mask))
    if engine == "in-core":
        pred = serving.LinkPredictor(model, params, known=known, batch_size=16, device="cpu")
    else:
        pred = serving.StreamedLinkPredictor(model, params, known=known, batch_size=16,
                                             chunk=40, device="cpu")
    res = pred.top_k(q, 6)
    if engine == "in-core":
        assert calls == [(n_e, True)] * 3  # batches of 16, 16, 5
    else:
        assert calls == [(6 + 40, False), (6 + 40, False), (6 + 17, False)] * 3
    qt = torch.as_tensor(q)
    full = model.score_pool(serving._query_rows(model, params, qt[:, 0], qt[:, 1], "o"),
                            params["E"], model.dense_params(params), 1)
    index = serving.known_index(known, n_r, "cpu", ("o",))["o"]
    full = serving.mask_known(full, qt[:, 0], qt[:, 1], index, 0, n_r)
    vals, pos = stable_top(full, 6)
    bad = vals <= NEG_INF
    np.testing.assert_array_equal(res.entities, torch.where(bad, -1, pos).numpy())
    np.testing.assert_array_equal(res.scores, torch.where(bad, -float("inf"), vals).numpy())


def test_wrapper_refuses_cpu_tensors():
    before = cuda_topk.launches
    with pytest.raises(ValueError, match="card only"):
        cuda_topk.top_k(torch.zeros(2, 5), 3)
    assert cuda_topk.launches == before


def test_module_imports_without_nvcc():
    """Importing the module (and serving) builds and loads nothing."""
    code = ("import skge_torch.serving, skge_torch.ops.cuda_topk as m; "
            "from skge_torch.ops import _build; "
            "assert m.launches == 0 and not _build._loaded; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env={**os.environ, "CUDA_HOME": ""})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# --- on the card --------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _on_card(scores, k, mask):
    before = cuda_topk.launches
    got = cuda_topk.top_k(scores, k, mask)
    assert cuda_topk.launches - before == 1
    return got


def _serve_tile(dev, seed=0):
    """The serve shape, 64 columns copied over others so every row ties,
    and the edge rows on top."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s = torch.randn(1_024, 14_951, generator=g, device=dev)
    s[:, 100:164] = s[:, 9_000:9_064]
    s[:8] = edge_rows(14_951).to(dev)
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 64, 1_000, 14_951])
@pytest.mark.parametrize("mask", [False, True])
def test_kernel_equals_plain_at_the_serve_shape(k, mask):
    scores = _serve_tile(_card())
    assert equal(_on_card(scores, k, mask), plain(scores, k, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 37, 255, 256, 4_097])
def test_kernel_equals_plain_on_short_and_odd_rows(dtype, n):
    dev = _card()
    rows = edge_rows(max(n, 8), dtype)[:, :n].contiguous().to(dev)
    ints = tied_ints(shape=(16, n), dtype=dtype).to(dev)
    for scores in (rows, ints):
        for k in sorted({1, min(10, n), n // 2 or 1, n}):
            for mask in (False, True):
                assert equal(_on_card(scores, k, mask), plain(scores, k, mask))


@pytest.mark.cuda
def test_kernel_equals_plain_at_the_fold_and_merge_shapes():
    """The streamed fold's (B, k + chunk), its frontier first, and the
    sharded merge's (B, M k) with ties across the ranks' frontiers."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    chunk = torch.randn(1_024, 4_096, generator=g, device=dev)
    start = torch.cat([torch.full((1_024, 10), -float("inf"), device=dev), chunk], 1)
    vals, _ = _on_card(start, 10, False)
    later = torch.cat([vals, chunk], 1)  # the frontier ties the chunk it came from
    fronts = torch.randn(1_024, 10, generator=g, device=dev).sort(1, descending=True)[0]
    merge = torch.cat([fronts, fronts.roll(1, 0), fronts, fronts.roll(2, 0)], 1)
    for scores in (start, later, merge, merge.double()):
        assert equal(_on_card(scores, 10, False), plain(scores, 10, False))


@pytest.mark.cuda
def test_one_launch_a_batch_through_the_engine_and_refusals(monkeypatch):
    """`LinkPredictor` on the card: one launch a batch, its answers those of
    the same engine with the plain version in the kernel's place."""
    dev = _card()
    model = MODELS["transe"](2_000, 20, 32)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    params["E"][1_000:1_100] = params["E"][:100]  # copied entities: tied scores
    rng = np.random.default_rng(0)
    q = np.stack([rng.integers(0, 2_000, 2_500), rng.integers(0, 20, 2_500)], 1)
    known = np.stack([rng.integers(0, 2_000, 9_000), rng.integers(0, 2_000, 9_000),
                      rng.integers(0, 20, 9_000)], 1)
    pred = serving.LinkPredictor(model, params, known=known, batch_size=1_024, device=dev)
    before = cuda_topk.launches
    got = pred.top_k(q, 10)
    assert cuda_topk.launches - before == 3
    monkeypatch.setattr(cuda_topk, "top_k", cuda_topk.top_k_reference)
    want = pred.top_k(q, 10)
    monkeypatch.undo()
    np.testing.assert_array_equal(got.entities, want.entities)
    np.testing.assert_array_equal(got.scores, want.scores)
    before = cuda_topk.launches
    for bad, err in ((torch.zeros(4, 9, dtype=torch.int32, device=dev), TypeError),
                     (torch.zeros(4, 9, dtype=torch.bfloat16, device=dev), TypeError),
                     (torch.zeros(9, 4, device=dev).t(), ValueError),
                     (torch.zeros(9, device=dev), ValueError)):
        with pytest.raises(err):
            cuda_topk.top_k(bad, 3)
    with pytest.raises(ValueError, match="1 <= k <= n"):
        cuda_topk.top_k(torch.zeros(4, 9, device=dev), 10)
    assert cuda_topk.launches == before
    empty = cuda_topk.top_k(torch.zeros(0, 9, device=dev), 3)
    assert empty[0].shape == (0, 3) and cuda_topk.launches == before
