"""The port's quality suite (skge_torch/quality_suite.py) against the JAX
package's (scripts/quality_suite.py):

- the sweep and early-stopping tests of test_quality_suite_sweep.py, on
  the port at the same tiny sizes;
- `successive_halving` and `parse_args` equal to JAX's;
- the configuration tables, the JSON lines and the `--out` lines of both
  `main`s with their training and ranking stubbed out, per loss and
  sampler;
- the slice as a whole: margin TransE-L2, selfadv TransE-L2 and margin
  RESCAL through `Suite.train_eval`, fed JAX's permutations and pools, in
  fp64: every validation MRR, the best epoch and the test metrics within
  1e-9 of the same pipeline composed from the JAX package;
- the best checkpoint's copy, the latent-KG cache and the GPU default;
- `skge_torch.quality_ties`: the same rows, ranked again with optimistic
  ties.
"""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import skge_tpu
import skge_tpu.data as jdata
import skge_tpu.evaluation as jevaluation
from skge_tpu import training as jtraining
from skge_tpu.models import ERMLP as JERMLP
from skge_tpu.models import RESCAL as JRESCAL
from skge_tpu.models import HolE as JHolE
from skge_tpu.models import TransE as JTransE
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_tpu.sampling import SharedNegativeSampler as JSampler
from skge_torch import quality_suite as qs
from skge_torch import quality_ties as qt
from skge_torch.convert import state_from_numpy
from skge_torch.data import Dataset, latent_kg

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts")
)

import quality_suite as jqs  # noqa: E402

torch.set_num_threads(1)

TINY = ["--cpu", "--entities", "600", "--relations", "8", "--ntrain", "2000",
        "--latent-dim", "8", "--nbatches", "5"]


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "cache"
    monkeypatch.setattr(qs, "CACHE_DIR", d)
    return d


# ---------------------------------------------------------------------------
# tests/test_quality_suite_sweep.py, on the port
# ---------------------------------------------------------------------------

def test_successive_halving_selects_best_and_doubles_budget():
    grid = [{"id": i} for i in range(6)]
    calls = []

    def run_fn(cfg, epochs):
        calls.append((cfg["id"], epochs))
        return 1.0 if cfg["id"] == 4 else 0.1 * cfg["id"]

    best, hist = qs.successive_halving(grid, run_fn, rung0=2, full_epochs=16)
    assert best["id"] == 4
    assert sorted({e for _, e in calls}) == [2, 4, 8]
    assert sum(1 for _, e in calls if e == 2) == 6
    assert sum(1 for _, e in calls if e == 4) == 3
    assert sum(1 for _, e in calls if e == 8) == 2
    assert [h["budget"] for h in hist] == [2, 4, 8]


def test_single_config_grid_runs_nothing():
    best, hist = qs.successive_halving(
        [{"only": True}], lambda c, e: 1.0, rung0=2, full_epochs=16
    )
    assert best == {"only": True} and hist == []


def test_sweep_end_to_end_tiny_cpu(tmp_path):
    out = tmp_path / "table.md"
    qs.main(TINY + [
        "--models", "TransE-L2", "--epochs", "8", "--sweep",
        "--sweep-rung0", "2", "--eval-every", "2", "--patience", "3",
        "--k", "64", "--out", str(out),
    ])
    text = out.read_text()
    assert "TransE-L2" in text and "best@" in text and "m=" in text
    cells = [c.strip() for c in text.strip().splitlines()[-1].split("|")]
    assert float(cells[2]) > 0.0


def test_early_stopping_reports_best_epoch(tmp_path):
    out = tmp_path / "t.md"
    qs.main(TINY + [
        "--models", "TransE-L2", "--epochs", "6",
        "--eval-every", "2", "--patience", "1", "--k", "64",
        "--out", str(out),
    ])
    line = out.read_text().strip().splitlines()[-1]
    assert "best@" in line
    best_ep = int(line.split("best@")[1].split()[0])
    assert 1 <= best_ep <= 6


def test_sampled_ce_suite_path_tiny_cpu(tmp_path):
    out = tmp_path / "s.md"
    qs.main(TINY + [
        "--models", "TransE-L2", "--epochs", "4", "--loss", "sampled_ce",
        "--k", "64", "--out", str(out),
    ])
    line = out.read_text().strip().splitlines()[-1]
    assert "sampledCE+Adam reciprocal k=64" in line
    cells = [c.strip() for c in line.split("|")]
    assert float(cells[2]) > 0.0


# ---------------------------------------------------------------------------
# successive_halving and parse_args against JAX's
# ---------------------------------------------------------------------------

HALVING_CASES = {
    # scores with ties: the earlier config wins a tie at every rung
    "ties": ([{"id": i} for i in range(7)],
             lambda c, e: round(0.3 - 0.1 * (c["id"] % 3) + 0.001 * e, 6), 3, 40),
    "all-equal": ([{"id": i} for i in range(5)], lambda c, e: 0.5, 1, 8),
    "budget-first": ([{"id": i} for i in range(8)],
                     lambda c, e: (c["id"] * 37 % 11) / 11.0, 4, 8),
    "one-config": ([{"only": True}], lambda c, e: 1.0, 2, 16),
    "rung0-zero": ([{"id": i} for i in range(3)], lambda c, e: -c["id"], 0, 3),
}


@pytest.mark.parametrize("case", sorted(HALVING_CASES))
def test_successive_halving_equals_jax(case):
    grid, score, rung0, full = HALVING_CASES[case]
    calls = {"port": [], "jax": []}

    def run(who):
        def run_fn(cfg, epochs):
            calls[who].append((json.dumps(cfg), epochs))
            return score(cfg, epochs)
        return run_fn

    want = jqs.successive_halving(grid, run("jax"), rung0, full)
    got = qs.successive_halving(grid, run("port"), rung0, full)
    assert got == want
    assert calls["port"] == calls["jax"]


PARSE_CASES = [
    [],
    ["--loss", "selfadv"],
    ["--loss", "sampled_ce"],
    ["--loss", "ce", "--k", "77"],
    ["--sweep"],
    ["--sweep", "--eval-every", "25", "--sweep-rung0", "25", "--patience", "2"],
    ["--sampler", "random-mode", "--negatives", "5", "--models", "RESCAL,HolE",
     "--epochs", "500"],
    ["--loss", "selfadv", "--models", "TransE-L2", "--k", "8192",
     "--adv-alpha", "2.0", "--epochs", "400", "--train-seed", "2"],
    ["--kg", "bilinear", "--dim", "64", "--cpu", "--out", "x.md",
     "--entities", "2000", "--relations", "12", "--ntrain", "16000",
     "--latent-dim", "8", "--nbatches", "20"],
]


@pytest.mark.parametrize("argv", PARSE_CASES, ids=lambda a: " ".join(a) or "defaults")
def test_parse_args_equals_jax(argv):
    assert vars(qs.parse_args(argv)) == vars(jqs.parse_args(argv))


def test_selfadv_with_random_mode_is_an_error_in_both(capsys):
    argv = ["--loss", "selfadv", "--sampler", "random-mode"]
    with pytest.raises(SystemExit) as jexc:
        jqs.parse_args(argv)
    jerr = capsys.readouterr().err
    with pytest.raises(SystemExit) as texc:
        qs.parse_args(argv)
    terr = capsys.readouterr().err
    assert texc.value.code == jexc.value.code == 2
    assert terr.splitlines()[-1] == jerr.splitlines()[-1]


# ---------------------------------------------------------------------------
# The configuration tables, JSON lines and --out lines: both mains with the
# training and the ranking stubbed out
# ---------------------------------------------------------------------------

def _fields(obj):
    if obj is None:
        return None
    out = {"class": type(obj).__name__}
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name == "logits" or f.name == "schedule":
                v = v is None
            out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


class _Recorder:
    """Stubs for what each main imports: the step factories record their
    arguments, the epoch does nothing, and the evaluator returns scripted
    metrics from one counter, so both mains see the same numbers if they
    ask in the same order."""

    def __init__(self):
        self.builds = []
        self.evals = []
        self.calls = 0

    def factory(self, kind):
        def make(model, opt, sampler=None, **kw):
            self.builds.append({
                "factory": kind, "model": _fields(model),
                "opt": {"class": type(opt).__name__, "lr": opt.lr},
                "sampler": _fields(sampler), **{k: v for k, v in sorted(kw.items())},
            })
            return None
        return make

    def epoch_fn(self, step, n, nbatches, **kw):
        self.builds[-1]["epoch"] = (n, nbatches)

        def epoch(state, xs, perm=None):
            return state, types.SimpleNamespace(loss=np.zeros(1))
        return epoch

    def init_state(self, model, opt, key):
        return types.SimpleNamespace(params={})

    def evaluator(self, model, data, known, batch_size=1024, **kw):
        self.evals.append((type(getattr(model, "model", model)).__name__,
                           len(data), len(known), batch_size))
        rec = self

        class Ev:
            def __call__(self, params):
                rec.calls += 1
                i = rec.calls
                return types.SimpleNamespace(
                    mrr=((i * 7919) % 101) / 1000.0 + 1e-3,
                    mrr_raw=((i * 104729) % 97) / 1000.0,
                    hits={1: (i % 7) / 10.0, 3: (i % 5) / 7.0, 10: (i % 3) / 3.0},
                    mean_rank=17.0 + i * 3.14159,
                )
        return Ev()


def _stub_dataset(args):
    rng = np.random.default_rng(11)
    n_e, n_r = args.entities, args.relations

    def triples(n):
        return np.stack([rng.integers(0, n_e, n), rng.integers(0, n_e, n),
                         rng.integers(0, n_r, n)], axis=1).astype(np.int32)

    return triples(args.ntrain), triples(20), triples(20)


def _run_jax_stubbed(argv, monkeypatch, capsys):
    rec = _Recorder()
    with monkeypatch.context() as m:
        for kind in ("pairwise", "selfadv", "ce", "sampled_ce"):
            m.setattr(skge_tpu, f"make_{kind}_step", rec.factory(kind))
        m.setattr(skge_tpu, "make_epoch_fn", rec.epoch_fn)
        m.setattr(skge_tpu, "init_state", rec.init_state)
        m.setattr(jevaluation, "FilteredRankingEval", rec.evaluator)
        m.setattr(jax, "jit", lambda f, **kw: f)
        m.setattr(np, "savez", lambda *a, **k: None)  # no file in JAX's cache
        m.setattr(jqs, "time", types.SimpleNamespace(perf_counter=lambda: 0.0))

        def fake_latent_kg(n_entities, n_relations, n_train, n_valid, n_test,
                           latent_dim, seed, kind):
            tr, va, te = _stub_dataset(jqs.parse_args(argv))
            return jdata.Dataset(tr, va, te, n_entities, n_relations)
        m.setattr(jdata, "latent_kg", fake_latent_kg)
        capsys.readouterr()
        jqs.main(argv)
        out = capsys.readouterr().out
    return rec, out


def _run_port_stubbed(argv, monkeypatch, capsys):
    rec = _Recorder()
    with monkeypatch.context() as m:
        for kind in ("pairwise", "selfadv", "ce", "sampled_ce"):
            m.setattr(qs, f"make_{kind}_step", rec.factory(kind))
        m.setattr(qs, "make_epoch_fn", rec.epoch_fn)
        m.setattr(qs, "init_state", lambda model, opt, gen: rec.init_state(model, opt, gen))
        m.setattr(qs, "FilteredRankingEval", rec.evaluator)
        m.setattr(qs, "time", types.SimpleNamespace(perf_counter=lambda: 0.0))

        def fake_latent_kg(n_entities, n_relations, n_train, n_valid, n_test,
                           latent_dim, seed, kind, device):
            tr, va, te = _stub_dataset(qs.parse_args(argv))
            return Dataset(tr, va, te, n_entities, n_relations)
        m.setattr(qs, "latent_kg", fake_latent_kg)
        capsys.readouterr()
        qs.main(argv)
        out = capsys.readouterr().out
    return rec, out


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


BASE = ["--cpu", "--entities", "50", "--relations", "4", "--ntrain", "200",
        "--latent-dim", "4", "--nbatches", "2", "--epochs", "3"]
TABLE_CASES = {
    "margin": [],
    "margin-wn18-widths": ["--entities", "2500"],
    "margin-dim": ["--dim", "12", "--train-seed", "4"],
    "random-mode": ["--sampler", "random-mode", "--negatives", "3"],
    "selfadv": ["--loss", "selfadv", "--adv-alpha", "2.0"],
    "selfadv-wn18-widths": ["--loss", "selfadv", "--entities", "2500", "--k", "512"],
    "ce": ["--loss", "ce"],
    "ce-wn18-widths": ["--loss", "ce", "--entities", "2500"],
    "ce-random-mode": ["--loss", "ce", "--sampler", "random-mode"],
    "sampled-ce": ["--loss", "sampled_ce", "--k", "32"],
    "sampled-ce-random-mode": ["--loss", "sampled_ce", "--sampler", "random-mode"],
    "margin-sweep": ["--sweep", "--models", "TransE-L2,ConvE,HolE",
                     "--sweep-rung0", "1", "--epochs", "5", "--patience", "2"],
    "selfadv-sweep": ["--loss", "selfadv", "--sweep", "--models", "TransE-L2",
                      "--sweep-rung0", "1", "--epochs", "9", "--eval-every", "2",
                      "--train-seed", "1"],
    "ce-sweep-early-stop": ["--loss", "ce", "--sweep", "--models", "TuckER,ComplEx",
                            "--epochs", "4", "--eval-every", "1", "--patience", "1"],
    "random-mode-early-stop": ["--sampler", "random-mode", "--models", "RESCAL,HolE",
                               "--eval-every", "1", "--patience", "1", "--epochs", "6"],
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_configuration_tables_and_lines_equal_jax(case, tmp_path, monkeypatch, capsys):
    extra = TABLE_CASES[case]
    jout, tout = tmp_path / "jax.md", tmp_path / "port.md"
    jrec, jtext = _run_jax_stubbed(BASE + extra + ["--out", str(jout)],
                                   monkeypatch, capsys)
    trec, ttext = _run_port_stubbed(BASE + extra + ["--out", str(tout)],
                                    monkeypatch, capsys)
    assert len(jrec.builds) > 0
    assert trec.builds == jrec.builds
    assert trec.evals == jrec.evals
    assert _json_lines(ttext) == _json_lines(jtext)
    assert tout.read_text() == jout.read_text()
    # the module-level table names the same models in the same order
    args = qs.parse_args(BASE + extra)
    names = [c[0] for c in qs.configs(args, args.entities, args.relations)]
    assert names == [r["model"] for r in _json_lines(jtext) if "model" in r]


# ---------------------------------------------------------------------------
# The slice as a whole against JAX, JAX's draws replayed, fp64
# ---------------------------------------------------------------------------

class ReplayPool:
    """A `pool`-protocol sampler that hands out given pools in order."""

    def __init__(self, pools, modes=(0, 1)):
        self.pools = list(pools)
        self.modes = modes

    def pool(self, generator, pos, mask):
        return torch.as_tensor(self.pools.pop(0), device=pos.device)


SLICE_N_E, SLICE_N_R, SLICE_EPOCHS = 120, 6, 3


@pytest.fixture(scope="module")
def slice_kg():
    return latent_kg(SLICE_N_E, SLICE_N_R, 420, n_valid=40, n_test=40,
                     latent_dim=4, seed=2, device="cpu")


def _jax_pipeline(jm, loss, margin, lr, k, alpha, ds, nbatches, epochs, seed):
    """quality_suite.py:294-411's composition of the JAX package's pieces,
    with the draws it makes."""
    jopt = JAdaGrad(lr=lr)
    sampler = JSampler(ds.n_entities, k=k)
    if loss == "selfadv":
        step = jtraining.make_selfadv_step(jm, jopt, sampler, margin=margin,
                                           alpha=alpha, aggregate="dense")
    else:
        step = jtraining.make_pairwise_step(jm, jopt, sampler, margin=margin,
                                            aggregate="dense")
    n = ds.train.shape[0]
    epoch = jax.jit(jtraining.make_epoch_fn(step, n, nbatches))
    state = jtraining.init_state(jm, jopt, jax.random.PRNGKey(seed))
    start = jax.device_get(state)
    key, perms, pools = state.key, [], []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(pk, n)))
        for _ in range(nbatches):
            key, sk = jax.random.split(key)
            pools.append(np.array(sampler.pool(sk, None, None)))
    known = ds.all_triples()
    val_ev = jevaluation.FilteredRankingEval(jm, ds.valid, known, batch_size=1024)
    xs = jnp.asarray(ds.train)
    history, best = [], (-1.0, 0, None)
    for e in range(1, epochs + 1):
        state, _ = epoch(state, xs)
        vm = val_ev(state.params).mrr
        history.append((e, vm))
        if vm > best[0]:
            best = (vm, e, jax.tree.map(jnp.copy, state.params))
    test = jevaluation.FilteredRankingEval(jm, ds.test, known, batch_size=1024)(best[2])
    return start, perms, pools, history, best[1], test


@pytest.mark.parametrize("loss,name", [("margin", "TransE-L2"),
                                       ("selfadv", "TransE-L2"),
                                       ("margin", "RESCAL"),
                                       ("margin", "ER-MLP"),
                                       ("margin", "HolE")])
def test_suite_slice_with_jax_draws_equals_jax(loss, name, slice_kg, monkeypatch):
    ds = slice_kg
    argv = ["--cpu", "--entities", str(SLICE_N_E), "--relations", str(SLICE_N_R),
            "--nbatches", "4", "--k", "16", "--loss", loss, "--adv-alpha", "2.0"]
    args = qs.parse_args(argv)
    _, model, margin, lr, k = next(
        c for c in qs.configs(args, ds.n_entities, ds.n_relations) if c[0] == name)
    model = dataclasses.replace(model, dtype="float64")
    jcls = {"TransE": JTransE, "RESCAL": JRESCAL, "ERMLP": JERMLP,
            "HolE": JHolE}[type(model).__name__]
    jm = jcls(**{f.name: getattr(model, f.name) for f in dataclasses.fields(model)})
    start, perms, pools, jhist, jbest, jtest = _jax_pipeline(
        jm, loss, margin, lr, k or args.k, args.adv_alpha, ds, args.nbatches,
        SLICE_EPOCHS, args.train_seed)

    suite = qs.Suite(args, ds, "cpu")
    # JAX's initial state, and a record of every validation
    monkeypatch.setattr(qs, "init_state", lambda m, opt, gen: state_from_numpy(start, "cpu"))
    hist, get_eval = [], suite.get_eval

    def recording(eval_model, which):
        ev = get_eval(eval_model, which)
        if which != "valid":
            return ev

        def validate(params):
            r = ev(params)
            hist.append((len(hist) + 1, r.mrr))
            return r
        return validate

    monkeypatch.setattr(suite, "get_eval", recording)
    row, r = suite.train_eval(
        name, model, margin, lr, k, args.adv_alpha, 0.0, SLICE_EPOCHS,
        eval_every=1, patience=SLICE_EPOCHS, sampler=ReplayPool(pools),
        perms=lambda e: torch.as_tensor(perms[e]))

    assert [e for e, _ in hist] == [e for e, _ in jhist]
    np.testing.assert_allclose([v for _, v in hist], [v for _, v in jhist],
                               rtol=1e-9, atol=1e-12)
    assert len({round(v, 6) for _, v in jhist}) > 1  # validation moved
    assert row["epochs"] == jbest and row["epochs_run"] == SLICE_EPOCHS
    np.testing.assert_allclose(
        [r.mrr, r.mrr_raw, r.mean_rank, r.hits[1], r.hits[3], r.hits[10]],
        [jtest.mrr, jtest.mrr_raw, jtest.mean_rank, jtest.hits[1], jtest.hits[3],
         jtest.hits[10]], rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(r.ranks, np.asarray(jtest.ranks))


# ---------------------------------------------------------------------------
# The best checkpoint, the cache, the device
# ---------------------------------------------------------------------------

def test_row_is_the_best_checkpoints_when_validation_peaks_early(slice_kg,
                                                                monkeypatch):
    ds = slice_kg
    args = qs.parse_args(["--cpu", "--entities", str(SLICE_N_E), "--relations",
                          str(SLICE_N_R), "--nbatches", "4", "--k", "16"])
    name, model, margin, lr, k = qs.configs(args, ds.n_entities, ds.n_relations)[1]
    suite = qs.Suite(args, ds, "cpu")
    real = suite.get_eval
    scripted = iter([0.9, 0.5, 0.4, 0.3])

    def get_eval(eval_model, which):
        if which == "valid":
            return lambda params: types.SimpleNamespace(mrr=next(scripted))
        return real(eval_model, which)

    monkeypatch.setattr(suite, "get_eval", get_eval)
    row, r = suite.train_eval(name, model, margin, lr, k, 1.0, 0.0, 4,
                              eval_every=1, patience=0)
    assert row["epochs"] == 1 and row["epochs_run"] == 4
    once, r1 = qs.Suite(args, ds, "cpu").train_eval(name, model, margin, lr, k,
                                                    1.0, 0.0, 1)
    four, r4 = qs.Suite(args, ds, "cpu").train_eval(name, model, margin, lr, k,
                                                    1.0, 0.0, 4)
    np.testing.assert_array_equal(r.ranks, r1.ranks)
    assert not np.array_equal(r1.ranks, r4.ranks)  # later epochs moved the ranks
    assert {k: v for k, v in row.items() if k not in ("train_s", "epochs_run")} == \
        {k: v for k, v in once.items() if k not in ("train_s", "epochs_run")}


def test_cache_never_reads_jax_file_and_appears_only_complete(cache_dir, monkeypatch,
                                                              capsys):
    args = qs.parse_args(["--cpu", "--entities", "200", "--relations", "4",
                          "--ntrain", "300", "--latent-dim", "4"])
    key = "translational-e200-r4-t300-h50-l4-s0"
    cache_dir.mkdir(parents=True)
    decoy = cache_dir / f"latent_kg_{key}.npz"   # the JAX suite's file name
    np.savez(decoy, train=np.zeros((1, 3), np.int32), valid=np.zeros((1, 3), np.int32),
             test=np.zeros((1, 3), np.int32))
    path = qs.cache_path(args, torch.device("cpu"))
    assert path.parent == cache_dir and path != decoy and "cpu" in path.name

    loads, replaces = [], []
    real_load, real_replace = np.load, os.replace
    monkeypatch.setattr(np, "load", lambda p, *a, **k: loads.append(str(p))
                        or real_load(p, *a, **k))

    def replace(src, dst):
        assert not os.path.exists(dst)
        with real_load(src) as z:  # whole before it takes its name
            assert z["train"].shape == (300, 3) and z["test"].shape == (50, 3)
        replaces.append((src, str(dst)))
        real_replace(src, dst)
    monkeypatch.setattr(os, "replace", replace)

    built = qs.load_kg(args, torch.device("cpu"))
    assert "built in" in capsys.readouterr().out
    assert replaces and replaces[0][1] == str(path) and not os.path.exists(replaces[0][0])
    assert sorted(os.listdir(cache_dir)) == sorted([decoy.name, path.name])
    again = qs.load_kg(args, torch.device("cpu"))
    assert "loaded from cache" in capsys.readouterr().out
    assert loads == [str(path)]
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(again, split), getattr(built, split))
    want = latent_kg(200, 4, 300, n_valid=50, n_test=50, latent_dim=4, seed=0,
                     device="cpu")
    np.testing.assert_array_equal(built.train, want.train)


def test_without_a_gpu_and_without_cpu_it_exits_naming_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        qs.main(TINY[1:] + ["--models", "TransE-L2", "--epochs", "1"])
    assert "--cpu" in str(exc.value.code)


# ---------------------------------------------------------------------------
# skge_torch.quality_ties: the suite's rows ranked again, optimistic ties
# ---------------------------------------------------------------------------

def test_tied_with_target_counts_equal_scores():
    from skge_torch.models import TransE

    rng = np.random.default_rng(3)
    model = TransE(30, 4, 6, dtype="float64")
    params = {"E": torch.as_tensor(rng.normal(size=(30, 6))),
              "R": torch.as_tensor(rng.normal(size=(4, 6)))}
    params["E"][[5, 9, 17]] = params["E"][2].clone()  # four entities tied everywhere
    test = np.array([[0, 2, 1], [1, 9, 0], [3, 4, 2], [7, 17, 3]], np.int32)
    got = qt.tied_with_target(model, params, test, batch=3)
    scores = model.score_all_o(params, torch.as_tensor(test[:, 0]).long(),
                               torch.as_tensor(test[:, 2]).long()).numpy()
    want = [int((scores[i] == scores[i, o]).sum()) - 1 for i, o in enumerate(test[:, 1])]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [3, 3, 0, 3])


def test_quality_ties_keeps_the_suites_rows(capsys):
    argv = TINY + ["--models", "TransE-L2", "--epochs", "3", "--k", "64",
                   "--eval-every", "1", "--patience", "1"]
    want = qs.main(argv)
    capsys.readouterr()
    lines = qt.main(argv)
    rows = [r for r in _json_lines(capsys.readouterr().out) if "ties" not in r]
    strip = lambda r: {k: v for k, v in r.items() if k != "train_s"}  # noqa: E731
    assert [strip(r) for r in rows] == [strip(r) for r in want]
    (line,) = lines
    assert line["model"] == "TransE-L2" and line["ties"] == "optimistic"
    assert line["mrr"] >= want[0]["mrr"]  # optimistic ranks are never worse
    assert line["queries_with_ties"] == 0.0 and line["tied_max"] == 0
