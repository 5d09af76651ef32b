"""The serving filter (skge_torch/ops/cuda_filter.py, csrc/filter_known.cu)
and its index (`skge_torch.data.known_csr`).

On the CPU: `known_csr` against `true_triple_index` for every key in both
directions; `filter_known_reference` against the pair semantics the
engines had (a plain loop over `true_triple_index`'s lists, each answer
inside the tile's columns set to NEG_INF), bit for bit, on rows with no
answers, a hot key with a long list, out-of-range ids, an empty index, a
short batch, and the windows of the sharded and streamed engines; the
engines' one filter call a batch; the wrapper's refusal of CPU tensors.
The rankers (`FilteredRankingEval` on one device and sharded over a gloo
world of two processes, `OutOfCoreTrainer.evaluate` over three parts)
against ranks counted on each whole tile masked by that plain loop, with
and without the test triples among the known ones, a candidate mask,
reciprocal relations and both tie rules.

On the card (marked `cuda`, skipped without one): the kernel against the
plain version at the serve cell's shape (1,024 Zipf queries against
FB15k's 14,951 entities, filtered by its 483,142 triples), bit-equal
tiles, the masked-cell counter equal to the plain version's pair count,
one launch a batch through `LinkPredictor` and two a batch through
`FilteredRankingEval`. This file does not import JAX; the gloo world runs
it as a script:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_filter.py
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from skge_torch import serving
from skge_torch.data import known_csr, synthetic_kg, true_triple_index
from skge_torch.evaluation import FilteredRankingEval, ReciprocalEvalWrapper
from skge_torch.models import MODELS
from skge_torch.ops import cuda_filter
from skge_torch.optim import AdaGrad
from skge_torch.outofcore import OutOfCoreTrainer
from skge_torch.parallel import distributed

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

    monkeypatch.setattr(cuda_filter, "filter_known_reference", counted)

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
    monkeypatch.setattr(cuda_filter, "check_index", lambda *a: checked.append(len(a[0])))
    model = MODELS["transe"](N_E, N_R, 8)
    pred = serving.LinkPredictor(model, model.init_params(torch.Generator().manual_seed(0)),
                                 known=graph(), batch_size=16, device="cpu")
    assert len(checked) == 2  # one index a direction
    pred.top_k(hot_queries(37), 5)
    pred.top_k(hot_queries(37), 5, direction="s")
    assert len(checked) == 2


# --- the rankers ----------------------------------------------------------

RANK_E, RANK_R = 60, 5  # the top relation, RANK_R - 1, only in the test split
RANK_CASES = ["known_has_test", "known_without_test", "candidate_mask", "reciprocal"]
WORLD_TIMEOUT_S = 150


def rank_case(case):
    """(model, params, test, known, candidate mask or None, reciprocal).
    Integer-valued fp64 tables, so every TransE score is an exact integer
    and ties are common; Zipf train triples below the top relation; test
    triples with repeated keys, the top relation, and keys no known triple
    has."""
    rng = np.random.default_rng(11)
    train = np.stack([zipf_ids(rng, RANK_E, 0.75, 400), zipf_ids(rng, RANK_E, 0.75, 400),
                      zipf_ids(rng, RANK_R - 1, 1.0, 400)], 1)
    test = np.concatenate([train[:12], np.stack([zipf_ids(rng, RANK_E, 0.75, 16),
                                                 zipf_ids(rng, RANK_E, 0.75, 16),
                                                 rng.integers(0, RANK_R, 16)], 1)])
    test[-4:, 2] = RANK_R - 1
    test[-1, :2] = test[-2, :2] = (RANK_E - 1, RANK_E - 2)
    if case == "known_without_test":
        known = train[~(train[:, None, :] == test[None]).all(-1).any(1)]
    else:
        known = np.concatenate([train, test])
    reciprocal = case == "reciprocal"
    n_r = 2 * RANK_R if reciprocal else RANK_R
    model = MODELS["transe"](RANK_E, n_r, 4, dtype="float64")
    params = {"E": torch.as_tensor(rng.integers(-2, 3, (RANK_E, 4)), dtype=torch.float64),
              "R": torch.as_tensor(rng.integers(-2, 3, (n_r, 4)), dtype=torch.float64)}
    cmask = None
    if case == "candidate_mask":
        cmask = rng.random(RANK_E) < 0.6
        cmask[test[:, :2].ravel()] = True
    return model, params, test.astype(np.int64), known.astype(np.int64), cmask, reciprocal


def plain_ranks(case, ties):
    """(filtered, raw) (2, n) ranks of each test triple, object then subject
    direction, counted on the whole score tile: non-candidates at NEG_INF,
    then `old_mask` for the filtered ranks. Mean ties count the target among
    the equal scores wherever the filter leaves it (raw ranks: never)."""
    model, params, test, known, cmask, reciprocal = rank_case(case)
    t = torch.as_tensor(test)
    s, o, p = t[:, 0], t[:, 1], t[:, 2]
    filt, raw = [], []
    for d, ent, target in (("o", s, o), ("s", o, s)):
        if d == "o":
            tile = model.score_all_o(params, s, p)
        elif reciprocal:
            tile = model.score_all_o(params, o, torch.where(p < RANK_R, p + RANK_R, p - RANK_R))
        else:
            tile = model.score_all_s(params, o, p)
        if cmask is not None:
            tile = torch.where(torch.as_tensor(cmask), tile, cuda_filter.NEG_INF)
        tgt = tile[torch.arange(len(test)), target][:, None]
        masked = old_mask(tile, torch.stack([ent, p], 1).numpy(), known, d)
        for out, m, self_in in ((filt, masked, 0), (raw, tile, 1)):
            g, e = (m > tgt).sum(1).numpy(), (m == tgt).sum(1).numpy()
            out.append(1.0 + g if ties == "optimistic"
                       else 1.0 + g + np.maximum(e - self_in, 0) * 0.5)
    return np.stack(filt), np.stack(raw)


def rank_with(ranker, case, ties, group=None):
    """(filtered, raw) ranks of `ranker`: 'single' or 'group'
    `FilteredRankingEval` (batches of 8, the last one short), 'streamed'
    `OutOfCoreTrainer.evaluate` over 3 parts with the same tables."""
    model, params, test, known, cmask, reciprocal = rank_case(case)
    if ranker == "streamed":
        tr = OutOfCoreTrainer(model, AdaGrad(lr=0.1), known, n_parts=3, k=8, nbatches=2,
                              seed=0, device="cpu")
        assert tr.part_size < RANK_E  # a part's tile starts past entity 0
        tr.e_host["param"][torch.as_tensor(tr.new_of_old)] = params["E"]
        tr.dev_params["R"] = params["R"]
        res = tr.evaluate(test, known, batch_size=8, ties=ties, reciprocal=reciprocal)
    else:
        ev = FilteredRankingEval(ReciprocalEvalWrapper(model) if reciprocal else model,
                                 test, known, batch_size=8, ties=ties, group=group,
                                 candidate_mask=cmask)
        res = ev(params)
    return res.ranks, res.ranks_raw


def world_worker(out_dir):
    """One rank of the gloo world: every case's sharded ranks to an npz."""
    torch.set_num_threads(1)
    distributed.initialize(device="cpu", timeout_s=WORLD_TIMEOUT_S)
    group = distributed.make_shard_mesh("cpu")
    out = {}
    for case in RANK_CASES:
        for ties in ("mean", "optimistic"):
            out[f"{case}/{ties}/filt"], out[f"{case}/{ties}/raw"] = rank_with(
                "group", case, ties, group)
    np.savez(os.path.join(out_dir, f"rank{group.rank}.npz"), **out)
    distributed.destroy()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' sharded ranks: 30 entities a rank, the second's block at
    base 30."""
    tmp = tmp_path_factory.mktemp("ranking_world")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = distributed.launch_local([sys.executable, os.path.abspath(__file__), str(tmp)],
                                     2, WORLD_TIMEOUT_S, store_dir=str(tmp), env=env)
    for rank, (rc, _, err) in enumerate(procs):
        assert rc == 0, f"rank {rank}: {err[-3000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("ties", ["mean", "optimistic"])
@pytest.mark.parametrize("ranker, case", [
    (ranker, case) for ranker in ("single", "group", "streamed") for case in RANK_CASES
    if not (ranker == "streamed" and case == "candidate_mask")])  # no such option there
def test_rankers_filter_the_known_answers(ranker, case, ties, request):
    """Each ranker's filtered and raw ranks equal the plain count's exactly."""
    want_filt, want_raw = plain_ranks(case, ties)
    if ranker == "group":
        got = [(r[f"{case}/{ties}/filt"], r[f"{case}/{ties}/raw"])
               for r in request.getfixturevalue("world")]
    else:
        got = [rank_with(ranker, case, ties)]
    for filt, raw in got:
        np.testing.assert_array_equal(filt, want_filt)
        np.testing.assert_array_equal(raw, want_raw)
    if case != "known_without_test":  # every target among its own known answers
        assert np.all(want_filt <= want_raw)
    if ties == "mean":
        assert np.any(want_filt % 1 == 0.5), "the tables must make ties"


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
def test_two_launches_a_batch_through_the_ranking():
    """`FilteredRankingEval` on the card: one `filter_known` launch a batch
    and direction, the ranks those of the CPU."""
    dev = _card()
    model, params, test, known, _, _ = rank_case("known_has_test")
    ev = FilteredRankingEval(model, test, known, batch_size=8)
    want = ev(params)
    before = cuda_filter.launches
    got = ev({k: v.to(dev) for k, v in params.items()})
    assert cuda_filter.launches - before == 2 * ev.n_batches == 8
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.ranks_raw, want.ranks_raw)


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


if __name__ == "__main__":
    world_worker(sys.argv[1])
