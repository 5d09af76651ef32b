"""The port's experiment CLI (skge_torch/experiment.py) against the JAX
package's: the shared flags keep their defaults; the four loss families
run end to end on the CPU on a tiny synthetic KG and give a finite MRR,
and so do RotatE, TransH, TransR, PairRE and ConvE (ConvE on reciprocal
relations unasked), the factorization models with `--n3` and
`--synthetic-kind latent`, and ConvE's CE recipe; `--model` takes the JAX
CLI's 14 choices; the `--fout` checkpoint loads in the JAX package; `--n3`
outside the factorization models and ConvE's pairwise scale-out exit with
a message that names them; without `--cpu` and a GPU the CLI exits
instead of running on the CPU. `--trainer outofcore` trains, validates
through the streamed ranking, keeps its best checkpoint directory and
ranks the test split, and its CE recipe runs with reciprocal relations.
`--trainer partitioned` does the same on the sharded table, in a world of
one and in two processes joined through the SKGE_* variables.
"""

import ast
import math
import os
import sys

import pytest
import torch

from skge_tpu import experiment as jexperiment
from skge_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from skge_torch import experiment
from skge_torch.parallel import distributed

torch.set_num_threads(1)

TINY = ["--cpu", "--synthetic-entities", "40", "--synthetic-relations", "4",
        "--synthetic-train", "400", "--ncomp", "8", "--nb", "4", "--me", "2",
        "--test-all", "1", "--eval-batch", "64"]


def test_shared_flags_keep_their_defaults():
    want = vars(jexperiment.make_parser().parse_args([]))
    got = vars(experiment.make_parser().parse_args([]))
    assert set(want) == set(got)
    for name, value in want.items():
        assert got[name] == value, name


@pytest.mark.parametrize("flags", [
    ["--sampler", "random-mode", "--aggregate", "dense_pallas"],
    ["--model", "transe", "--l2", "--selfadv", "--sampler", "shared", "--k", "16",
     "--margin", "3.0", "--adv-alpha", "2.0"],
    ["--model", "rescal", "--ce", "--reciprocal", "--optimizer", "adam", "--lr", "0.01",
     "--label-smoothing", "0.1", "--schedule", "cosine", "--warmup", "2"],
    ["--sampled-ce", "--sampler", "shared", "--k", "16", "--optimizer", "adam",
     "--lr", "0.01", "--reciprocal", "--aggregate", "dense_pallas"],
], ids=["margin", "selfadv", "ce", "sampled_ce"])
def test_main_runs_each_loss(flags, tmp_path, capsys):
    fout = str(tmp_path / "best.npz")
    assert experiment.main(TINY + flags + ["--fout", fout]) == 0
    result = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["epochs"] == 2
    assert math.isfinite(result["mrr"]) and 0.0 < result["mrr"] <= 1.0
    jstate, meta = jload_checkpoint(fout)
    assert meta["epoch"] in (1, 2) and int(jstate.step) == 4 * meta["epoch"]
    n_rel = 8 if "--reciprocal" in flags else 4
    assert jstate.params["E"].shape == (40, 8)
    assert next(v for k, v in jstate.params.items() if k != "E").shape[0] == n_rel


@pytest.mark.parametrize("flags, message", [
    (["--model", "conve", "--trainer", "partitioned", "--cpu"],
     "ConvE on --trainer partitioned/outofcore requires --ce or --sampled-ce"),
    (["--model", "conve", "--trainer", "outofcore"],
     "ConvE on --trainer partitioned/outofcore requires --ce or --sampled-ce"),
    (["--n3", "0.1"], "--n3 is not supported for --model hole"),
    (["--model", "transe", "--n3", "0.1"], "--n3 is not supported for --model transe"),
])
def test_unported_options_exit_naming_them(flags, message):
    try:
        with pytest.raises(SystemExit, match=message):
            experiment.main(TINY + flags)
    finally:
        distributed.destroy()  # --trainer partitioned joined a world of one


def test_model_choices_are_the_jax_packages():
    def choices(parser):
        return next(a.choices for a in parser._actions if a.dest == "model")

    assert choices(experiment.make_parser()) == choices(jexperiment.make_parser())
    assert len(choices(experiment.make_parser())) == 14


@pytest.mark.parametrize("model", ["rotate", "transh", "transr", "pairre", "conve"])
def test_zoo_models_run_from_the_cli(model, tmp_path, capsys):
    """Each model the JAX CLI takes trains and ranks through the port's,
    with the JAX CLI's wiring: `rparam` for RotatE and ConvE; ConvE on
    reciprocal relations without `--reciprocal`, corrupting objects only
    and ranking subjects through its own inverse routing; TransR full
    rank."""
    fout = str(tmp_path / "best.npz")
    flags = TINY + ["--model", model, "--rparam", "0.01", "--fout", fout]
    exp = experiment.Experiment(experiment.make_parser().parse_args(flags))
    conve = model == "conve"
    assert exp.model.regularization == (0.01 if model in ("rotate", "conve") else 0.0)
    assert exp.ds.n_relations == (8 if conve else 4)
    assert exp.trainer.sampler.modes == ((1,) if conve else (0, 1))
    assert exp.trainer.config.ce_directions == (("o",) if conve else ("o", "s"))
    assert exp._eval_model is exp.model
    if model == "transr":
        assert not exp.model.factored and exp.model.sweep == "quadratic"
    assert experiment.main(flags) == 0
    result = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["epochs"] == 2
    assert math.isfinite(result["mrr"]) and 0.0 < result["mrr"] <= 1.0
    jstate, meta = jload_checkpoint(fout)
    assert meta["model"] == model
    assert set(jstate.params) == set(exp.model.init_params(torch.Generator()))
    assert jstate.params["R"].shape[0] == (8 if conve else 4)


LATENT = ["--cpu", "--synthetic-kind", "latent", "--latent-dim", "8",
          "--synthetic-entities", "120", "--synthetic-relations", "4",
          "--synthetic-train", "160", "--ncomp", "6", "--nb", "4", "--me", "2",
          "--test-all", "1", "--eval-batch", "64"]


@pytest.mark.parametrize("flags", [
    ["--model", "complex", "--ce", "--reciprocal", "--optimizer", "adam", "--lr", "0.01",
     "--label-smoothing", "0.1", "--n3", "1e-3"],
    ["--model", "tucker", "--sampler", "shared", "--k", "16", "--aggregate",
     "dense_pallas", "--n3", "1e-3", "--rparam", "1e-3"],
    ["--model", "quate", "--sampled-ce", "--sampler", "shared", "--k", "16",
     "--optimizer", "adam", "--lr", "0.01", "--n3", "1e-3"],
    ["--model", "conve", "--ce", "--reciprocal", "--optimizer", "adam", "--lr", "0.01",
     "--label-smoothing", "0.1", "--rparam", "1e-3", "--ncomp", "8"],
], ids=["complex-ce-n3", "tucker-margin", "quate-sampled_ce", "conve-ce"])
def test_factorization_models_on_a_latent_kg(flags, tmp_path, capsys):
    """The latent KG is JAX's for the same flags; the model takes `n3` and
    `rparam`; the checkpoint loads in the JAX package. ConvE's is
    RECIPES.md's CE recipe, without `--n3`."""
    from skge_tpu.data import latent_kg as jlatent_kg

    fout = str(tmp_path / "best.npz")
    args = experiment.make_parser().parse_args(LATENT + flags + ["--fout", fout])
    exp = experiment.Experiment(args)
    assert exp.model.regularization_n3 == (0.0 if "conve" in flags else 1e-3)
    assert exp.model.rparam == args.rparam
    want = jlatent_kg(120, 4, 160, n_valid=50, n_test=50, latent_dim=8, seed=0)
    for got, w in ((exp.ds.valid, want.valid), (exp.ds.test, want.test)):
        assert (got == w).all()
    assert experiment.main(LATENT + flags + ["--fout", fout]) == 0
    result = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["epochs"] == 2
    assert math.isfinite(result["mrr"]) and 0.0 < result["mrr"] <= 1.0
    jstate, meta = jload_checkpoint(fout)
    assert meta["model"] == flags[1]
    assert set(jstate.params) == set(exp.model.init_params(torch.Generator()))


def test_no_gpu_without_cpu_flag_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(experiment.Trainer, "fit", lambda *a, **k: ran.append(1))
    with pytest.raises(SystemExit, match="no CUDA device"):
        experiment.main([a for a in TINY if a != "--cpu"])
    assert not ran


@pytest.mark.parametrize("flags", [
    ["--sampler", "shared", "--k", "16", "--margin", "1.0"],
    ["--model", "hole", "--sampled-ce", "--reciprocal", "--optimizer", "adam",
     "--lr", "0.01", "--k", "16"],
], ids=["margin", "sampled_ce_reciprocal"])
def test_outofcore_trainer_from_the_cli(flags, tmp_path, capsys, caplog):
    fout = str(tmp_path / "best.npz")
    caplog.set_level("INFO", logger="skge_torch.experiment")
    assert experiment.main(TINY + ["--trainer", "outofcore", "--parts", "2",
                                   "--fout", fout] + flags) == 0
    result = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["epochs"] == 2
    assert math.isfinite(result["mrr"]) and 0.0 < result["mrr"] <= 1.0
    text = caplog.text
    assert text.count("VALID epoch") == 2 and "TEST: MRR" in text
    assert sorted(os.listdir(fout + ".sharded")) == [
        "manifest.json", "part_00000.npz", "part_00001.npz", "replicated.npz"]
    if "--sampled-ce" in flags:
        assert "ignores: --sampler random-mode (shared pool only)" in text


PARTITIONED = ["--trainer", "partitioned", "--sampler", "shared", "--k", "16"]


def test_partitioned_trainer_from_the_cli_world_of_one(tmp_path, capsys, caplog):
    """`--trainer partitioned --cpu` with no launch variables: a gloo world
    of one, validation and the test ranking on the sharded table, the
    best model's sharded checkpoint directory."""
    fout = str(tmp_path / "best.npz")
    caplog.set_level("INFO", logger="skge_torch.experiment")
    try:
        assert experiment.main(TINY + PARTITIONED + ["--fout", fout]) == 0
    finally:
        distributed.destroy()
    result = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["epochs"] == 2
    assert math.isfinite(result["mrr"]) and 0.0 < result["mrr"] <= 1.0
    assert caplog.text.count("VALID epoch") == 2 and "TEST: MRR" in caplog.text
    assert sorted(os.listdir(fout + ".sharded")) == [
        "manifest.json", "replicated.npz", "shard_00000.npz"]


def test_partitioned_trainer_from_the_cli_two_processes(tmp_path):
    """Two processes joined through the SKGE_* variables (a file store):
    both finish with the same result, and each wrote its own shard."""
    fout = str(tmp_path / "best.npz")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = distributed.launch_local(
        [sys.executable, "-m", "skge_torch.experiment"] + TINY + PARTITIONED
        + ["--fout", fout], 2, 150, store_dir=str(tmp_path), env=env)
    results = []
    for rc, so, se in out:
        assert rc == 0, se[-3000:]
        results.append(ast.literal_eval(so.strip().splitlines()[-1]))
    a, b = results
    assert a["epochs"] == b["epochs"] == 2 and a["mrr"] == b["mrr"]
    assert 0.0 < a["mrr"] <= 1.0
    assert sorted(os.listdir(fout + ".sharded")) == [
        "manifest.json", "replicated.npz", "shard_00000.npz", "shard_00001.npz"]
