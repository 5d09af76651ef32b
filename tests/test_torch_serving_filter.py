"""The serving filter (skge_torch/ops/cuda_filter.py, csrc/filter_known.cu)
and its index (`skge_torch.data.known_csr`).

On the CPU: `known_csr` against `true_triple_index` for every key in both
directions; `filter_known_reference` against the pair semantics the
engines had (a plain loop over `true_triple_index`'s lists, each answer
inside the tile's columns set to NEG_INF), bit for bit, on rows with no
answers, a hot key with a long list, out-of-range ids, an empty index, a
short batch, and the windows of the sharded and streamed engines; the
engines' one filter call a batch; the wrapper's refusal of CPU tensors.

On the card (marked `cuda`, skipped without one): the kernel against the
plain version at the serve cell's shape (1,024 Zipf queries against
FB15k's 14,951 entities, filtered by its 483,142 triples), bit-equal
tiles, the masked-cell counter equal to the plain version's pair count,
and one launch a batch through `LinkPredictor`. This file does not import
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_filter.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from skge_torch import serving
from skge_torch.data import known_csr, synthetic_kg, true_triple_index
from skge_torch.models import MODELS
from skge_torch.ops import cuda_filter

torch.set_num_threads(1)

N_E, N_R = 331, 7
HOT_ANSWERS = 300  # the hot key's list: longer than the kernel's block of 128 threads


def zipf_ids(rng, n, a, size):
    """Ids 0..n-1, rank r drawn with weight r^-a, ranks shuffled."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -a
    r = np.searchsorted(np.cumsum(w) / w.sum(), rng.random(size), side="right")
    return rng.permutation(n)[np.minimum(r, n - 1)]


def graph(seed=0, n=1_500, n_e=N_E, n_r=N_R, hot=True):
    """(n, 3) Zipf (s, o, p) triples with repeats, plus (when `hot`) one
    (s, p) with HOT_ANSWERS distinct objects and the (o, p) mirror."""
    rng = np.random.default_rng(seed)
    t = np.stack([zipf_ids(rng, n_e, 0.75, n), zipf_ids(rng, n_e, 0.75, n),
                  zipf_ids(rng, n_r, 1.0, n)], axis=1)
    if hot:
        objs = np.arange(HOT_ANSWERS)
        hot_sp = np.stack([np.full(HOT_ANSWERS, 3), objs, np.full(HOT_ANSWERS, 2)], 1)
        t = np.concatenate([t, hot_sp, hot_sp[:, [1, 0, 2]]])
    return t.astype(np.int64)


DIRS = {"o": 0, "s": 1}  # true_triple_index's (s, p) -> o and (o, p) -> s


def old_mask(scores, queries, known, direction, base=0):
    """The engines' filter as it was: for each query a plain lookup in
    `true_triple_index`, then NEG_INF at each answer inside the tile."""
    out = scores.clone()
    index = true_triple_index(known)[DIRS[direction]] if len(known) else {}
    width = scores.shape[1]
    for i, (e, r) in enumerate(np.asarray(queries).tolist()):
        for a in index.get((e, r), np.zeros(0, np.int32)).tolist():
            if base <= a < base + width:
                out[i, a - base] = cuda_filter.NEG_INF
    return out


def reference(scores, queries, known, direction, base=0, n_r=N_R):
    out = scores.clone()
    q = torch.as_tensor(np.asarray(queries, np.int64).reshape(-1, 2))
    index = [torch.from_numpy(a) for a in known_csr(known, n_r, direction)]
    cuda_filter.filter_known_reference(out, q[:, 0], q[:, 1], *index, base, n_r)
    return out


def tile(b, width, seed=1, dtype=torch.float32):
    return torch.randn(b, width, generator=torch.Generator().manual_seed(seed), dtype=dtype)


# --- the index ------------------------------------------------------------


@pytest.mark.parametrize("direction", ["o", "s"])
@pytest.mark.parametrize("case", ["zipf", "synthetic", "one", "repeats"])
def test_known_csr_equals_true_triple_index(case, direction):
    if case == "zipf":
        t, n_r = graph(), N_R
    elif case == "synthetic":
        ds = synthetic_kg(200, 9, 3_000, seed=4)
        t, n_r = ds.all_triples(), 9
    elif case == "one":
        t, n_r = np.array([[5, 6, 0]]), 1
    else:  # every triple three times, relations up to n_r - 1 only
        t, n_r = np.tile(graph(seed=2, hot=False), (3, 1)), N_R + 5
    keys, offsets, answers = known_csr(t, n_r, direction)
    assert keys.dtype == np.int64 and offsets.dtype == np.int64 and answers.dtype == np.int32
    assert np.all(np.diff(keys) > 0)
    assert offsets[0] == 0 and offsets[-1] == answers.size and np.all(np.diff(offsets) > 0)
    want = true_triple_index(t)[DIRS[direction]]
    assert len(want) == keys.size
    for i, key in enumerate(keys.tolist()):
        got = answers[offsets[i]:offsets[i + 1]]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want[divmod(key, n_r)])


def test_known_csr_empty_and_refusals():
    for empty in (np.zeros((0, 3), np.int64), []):
        keys, offsets, answers = known_csr(empty, N_R, "o")
        assert keys.size == 0 and answers.size == 0 and offsets.tolist() == [0]
    for bad in ([[1, 2, N_R]], [[1, 2, -1]], [[-1, 2, 0]], [[1, -2, 0]]):
        with pytest.raises(ValueError, match="relations in"):
            known_csr(np.array(bad), N_R, "o")
    with pytest.raises(ValueError, match="direction"):
        known_csr(graph(), N_R, "p")


def test_known_csr_at_fb15k_size_is_under_10mb_a_direction():
    """At FB15k's counts (483,142 distinct Zipf triples) each direction's
    index is 16 bytes a key, 4 an answer and 8 more: under 10 MB."""
    rng = np.random.default_rng(0)
    t = np.stack([zipf_ids(rng, 14_951, 0.75, 560_000), zipf_ids(rng, 14_951, 0.75, 560_000),
                  zipf_ids(rng, 1_345, 1.0, 560_000)], 1)
    _, first = np.unique(t, axis=0, return_index=True)
    t = t[np.sort(first)[:483_142]]
    assert len(t) == 483_142
    for d in "os":
        keys, offsets, answers = known_csr(t, 1_345, d)
        nbytes = keys.nbytes + offsets.nbytes + answers.nbytes
        assert nbytes == 16 * keys.size + 8 + 4 * len(t) < 10e6


# --- the plain version against the old pair semantics --------------------


def hot_queries(b, seed=5, n_e=N_E):
    """b Zipf queries with the hot key, rows with no answers and repeats."""
    rng = np.random.default_rng(seed)
    q = np.stack([zipf_ids(rng, n_e, 0.75, b), zipf_ids(rng, N_R, 1.0, b)], 1)
    q[::7] = (3, 2)  # the hot key
    q[1::11] = (N_E - 1, N_R - 1)
    return q.astype(np.int64)


@pytest.mark.parametrize("direction", ["o", "s"])
@pytest.mark.parametrize("b", [1, 13, 64])
def test_plain_filter_equals_the_pair_semantics(direction, b):
    t = graph()
    q = hot_queries(b)
    scores = tile(b, N_E)
    got = reference(scores, q, t, direction)
    assert torch.equal(got, old_mask(scores, q, t, direction))
    # row 0 asks the hot key: its whole list is masked
    assert int((got[0] == cuda_filter.NEG_INF).sum()) >= HOT_ANSWERS


def test_plain_filter_leaves_rows_with_no_answers():
    t = graph(hot=False)
    q = np.array([[0, 0], [N_E - 1, N_R - 1], [50, 3]])
    index = true_triple_index(t)[0]
    q = q[[(e, r) not in index for e, r in q.tolist()]]
    assert len(q)
    scores = tile(len(q), N_E)
    assert torch.equal(reference(scores, q, t, "o"), scores)


def test_plain_filter_out_of_range_ids_are_misses():
    """Negative ids, relations at or past n_relations (which would alias
    another key as entity * n_r + rel), entities past every key's."""
    t = graph()
    hot = [3, 2]
    q = np.array([hot, [-1, 2], [3, -1], [2, N_R + 2], [4, -5], [N_E + 3, 0], [2**40, 1],
                  [-(2**40), 3], hot])
    scores = tile(len(q), N_E)
    got = reference(scores, q, t, "o")
    assert torch.equal(got, old_mask(scores, q, t, "o"))
    assert torch.equal(got[1:-1], scores[1:-1])
    hot_mask = got[0] == cuda_filter.NEG_INF
    assert int(hot_mask.sum()) >= HOT_ANSWERS
    assert torch.equal(hot_mask, got[-1] == cuda_filter.NEG_INF)


def test_plain_filter_with_an_empty_index():
    q = hot_queries(9)
    scores = tile(9, N_E)
    assert torch.equal(reference(scores, q, np.zeros((0, 3), np.int64), "o"), scores)


@pytest.mark.parametrize("direction", ["o", "s"])
@pytest.mark.parametrize("windows", ["sharded", "streamed"])
def test_plain_filter_in_windows(direction, windows):
    """The sharded engine's blocks (base rank * S, width S) and the streamed
    engine's chunks (the last one short) together mask what the whole tile
    does, each in its own columns."""
    t, q = graph(seed=3), hot_queries(40, seed=8)
    whole = tile(len(q), N_E, seed=2)
    want = old_mask(whole, q, t, direction)
    width = -(-N_E // 4) if windows == "sharded" else 30
    parts = []
    for base in range(0, N_E, width):
        part = whole[:, base:base + width]
        got = reference(part, q, t, direction, base=base)
        assert torch.equal(got, old_mask(part, q, t, direction, base=base))
        parts.append(got)
    assert torch.equal(torch.cat(parts, dim=1), want)


def test_plain_filter_fp64_and_pair_count():
    t, q = graph(), hot_queries(32)
    scores = tile(32, N_E, dtype=torch.float64)
    got = reference(scores, q, t, "o")
    assert torch.equal(got, old_mask(scores, q, t, "o"))
    index = [torch.from_numpy(a) for a in known_csr(t, N_R, "o")]
    qt = torch.as_tensor(q)
    rows, cols = cuda_filter.known_pairs_reference(qt[:, 0], qt[:, 1], *index, 0, N_E, N_R)
    assert rows.numel() == int((got != scores).sum())


# --- the engines ----------------------------------------------------------


@pytest.mark.parametrize("engine", ["in-core", "streamed"])
def test_engines_filter_once_a_tile_and_never_unfiltered(engine, monkeypatch):
    """One filter call a batch (a chunk, streamed); none with
    filtered=False or without `known`; the results equal a brute-force
    filtered top k."""
    t, q = graph(), hot_queries(37)
    model = MODELS["transe"](N_E, N_R, 8)
    params = model.init_params(torch.Generator().manual_seed(0))
    calls = []
    real = cuda_filter.filter_known_reference

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(serving, "filter_known_reference", counted)

    def make(known):
        if engine == "in-core":
            return serving.LinkPredictor(model, params, known=known, batch_size=16,
                                         device="cpu")
        return serving.StreamedLinkPredictor(model, params, known=known, batch_size=16,
                                             chunk=40, device="cpu")

    pred = make(t)
    res = pred.top_k(q, 5)
    tiles = 3 * (1 if engine == "in-core" else -(-N_E // 40))  # batches of 16, 16, 5
    assert len(calls) == tiles
    pred.top_k(q, 5, filtered=False)
    make(None).top_k(q, 5)
    assert len(calls) == tiles
    full = model.score_pool(serving._query_rows(model, params, torch.as_tensor(q[:, 0]),
                                                torch.as_tensor(q[:, 1]), "o"),
                            params["E"], model.dense_params(params), 1)
    top = torch.topk(old_mask(full, q, t, "o"), 5, dim=1).values.numpy()
    np.testing.assert_array_equal(res.scores, np.where(top <= cuda_filter.NEG_INF, -np.inf, top))


def test_wrapper_refuses_cpu_tensors():
    index = [torch.from_numpy(a) for a in known_csr(graph(), N_R, "o")]
    q = torch.as_tensor(hot_queries(4))
    before = cuda_filter.launches
    with pytest.raises(ValueError, match="card only"):
        cuda_filter.filter_known(tile(4, N_E), q[:, 0], q[:, 1], *index, 0, N_R)
    assert cuda_filter.launches == before


def test_index_checked_once_where_it_is_built(monkeypatch):
    """`check_index` passes `known_csr`'s arrays and refuses any other
    index; the engines check theirs once, at construction, not a batch."""
    index = [torch.from_numpy(a) for a in known_csr(graph(), N_R, "o")]
    cuda_filter.check_index(*index)
    keys, offsets, answers = index
    for bad, match in (((keys.int(), offsets, answers), "keys"),
                       ((keys, offsets[:-1], answers), "offsets"),
                       ((keys, offsets, answers.long()), "answers"),
                       ((keys, offsets, answers.view(-1, 1)), "answers"),
                       ((keys, offsets, torch.stack([answers, answers], 1)[:, 0]),
                        "contiguous")):
        with pytest.raises(ValueError, match=match):
            cuda_filter.check_index(*bad)
    checked = []
    monkeypatch.setattr(serving, "check_index", lambda *a: checked.append(len(a[0])))
    model = MODELS["transe"](N_E, N_R, 8)
    pred = serving.LinkPredictor(model, model.init_params(torch.Generator().manual_seed(0)),
                                 known=graph(), batch_size=16, device="cpu")
    assert len(checked) == 2  # one index a direction
    pred.top_k(hot_queries(37), 5)
    pred.top_k(hot_queries(37), 5, direction="s")
    assert len(checked) == 2


# --- on the card ----------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _serve_cell(seed=2_654_435_761):
    """The serve cell's graph and one batch of its Zipf queries."""
    from kgebench import gen

    root = Path(__file__).resolve().parents[1] / "kgebench"
    cfg = json.loads((root / "configs" / "transe_l1_fb15k.json").read_text())
    batch = json.loads((root / "traffic" / "serve.json").read_text())["batch"]
    return cfg, gen.kg(cfg, seed), gen.queries(cfg, seed, 4 * batch)


def _on_card(scores, q, index, base, n_r, dev):
    qt = torch.as_tensor(q, device=dev)
    out = scores.to(dev)
    before = cuda_filter.masked_pairs(dev).item()
    cuda_filter.filter_known(out, qt[:, 0].contiguous(), qt[:, 1].contiguous(),
                             *(a.to(dev) for a in index), base, n_r)
    return out.cpu(), cuda_filter.masked_pairs(dev).item() - before


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["o", "s"])
def test_kernel_equals_plain_at_the_serve_cell(direction):
    dev = _card()
    cfg, known, queries = _serve_cell()
    n_e, n_r = cfg["entities"], cfg["relations"]
    index = [torch.from_numpy(a) for a in known_csr(known, n_r, direction)]
    for lo in range(0, len(queries), 1_024):
        q = queries[lo:lo + 1_024]
        scores = tile(len(q), n_e, seed=lo)
        want = reference(scores, q, known, direction, n_r=n_r)
        launches = cuda_filter.launches
        got, masked = _on_card(scores, q, index, 0, n_r, dev)
        assert cuda_filter.launches - launches == 1
        assert torch.equal(got, want)
        qt = torch.as_tensor(q)
        rows, _ = cuda_filter.known_pairs_reference(qt[:, 0], qt[:, 1], *index, 0, n_e, n_r)
        assert masked == rows.numel() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("windows", ["sharded", "streamed"])
def test_kernel_in_windows_and_edge_cases_on_card(windows):
    """Windows, out-of-range ids, the hot key's long list, an empty index,
    one query, fp64 scores."""
    dev = _card()
    t = graph()
    q = np.concatenate([hot_queries(50), [[-1, 2], [3, N_R + 1], [2**40, 1], [3, -2]]])
    width = -(-N_E // 4) if windows == "sharded" else 30
    for direction in ("o", "s"):
        index = [torch.from_numpy(a) for a in known_csr(t, N_R, direction)]
        whole = tile(len(q), N_E)
        for base in range(0, N_E, width):
            part = whole[:, base:base + width].contiguous()
            got, _ = _on_card(part, q, index, base, N_R, dev)
            assert torch.equal(got, reference(part, q, t, direction, base=base))
    empty = [torch.from_numpy(a) for a in known_csr(np.zeros((0, 3)), N_R, "o")]
    scores = tile(len(q), N_E)
    assert torch.equal(_on_card(scores, q, empty, 0, N_R, dev)[0], scores)
    one = tile(1, N_E, dtype=torch.float64)
    index = [torch.from_numpy(a) for a in known_csr(t, N_R, "o")]
    got, masked = _on_card(one, q[:1], index, 0, N_R, dev)
    assert torch.equal(got, reference(one, q[:1], t, "o")) and masked >= HOT_ANSWERS // 2


@pytest.mark.cuda
def test_one_launch_a_batch_through_the_engine():
    dev = _card()
    cfg, known, queries = _serve_cell()
    model = MODELS["transe"](cfg["entities"], cfg["relations"], cfg["ncomp"])
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    pred = serving.LinkPredictor(model, params, known=known, batch_size=1_024, device=dev)
    before = cuda_filter.launches
    got = pred.top_k(queries, 10)
    assert cuda_filter.launches - before == 4
    pred.top_k(queries, 10, filtered=False)
    assert cuda_filter.launches - before == 4
    # the same K3 scores, masked by the old pair semantics on the host
    q = queries[:1_024]
    with torch.no_grad():
        full = model.score_pool(serving._query_rows(
            model, params, *(torch.as_tensor(a, device=dev) for a in (q[:, 0], q[:, 1])),
            "o"), params["E"], model.dense_params(params), 1).cpu()
    top = torch.topk(old_mask(full, q, known, "o"), 10, dim=1).values.numpy()
    np.testing.assert_array_equal(got.scores[:1_024], top)


@pytest.mark.cuda
def test_wrapper_refusals_on_card():
    dev = _card()
    index = [torch.from_numpy(a).to(dev) for a in known_csr(graph(), N_R, "o")]
    q = torch.as_tensor(hot_queries(4), device=dev)
    ent, rel = q[:, 0].contiguous(), q[:, 1].contiguous()
    s = torch.zeros(4, N_E, device=dev)
    before = cuda_filter.launches
    with pytest.raises(TypeError):
        cuda_filter.filter_known(s.half(), ent, rel, *index, 0, N_R)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_filter.filter_known(torch.zeros(N_E, 4, device=dev).T, ent, rel, *index, 0, N_R)
    with pytest.raises(ValueError, match="ent"):
        cuda_filter.filter_known(s, ent.int(), rel, *index, 0, N_R)
    with pytest.raises(ValueError, match="rows"):
        cuda_filter.filter_known(s, ent[:3], rel[:3], *index, 0, N_R)
    with pytest.raises(ValueError, match="offsets"):
        cuda_filter.check_index(index[0], index[1][:-1], index[2])
    with pytest.raises(ValueError, match="answers"):
        cuda_filter.check_index(index[0], index[1], index[2].cpu())
    assert cuda_filter.launches == before
