#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`skge_torch`) on one NVIDIA GPU.

Drives the port's two slices once at full width on FB15k-shaped synthetic
data (14,951 entities, 1,345 relations, 483,142 train triples) against a
shared pool of 1,024 negatives, AdaGrad, aggregate="dense_pallas":

- TransE-L1, ncomp=150, pairwise margin loss (`python bench.py`'s
  default); every gradient scatter in the CUDA kernel `segment_sum`
  (skge_torch/csrc/segment_sum.cu);
- RESCAL, ncomp=100, pairwise (`bench.py --model rescal --ncomp 100`) and
  pointwise; W's factored gradient scatter in the CUDA kernel
  `segment_outer_sum` (skge_torch/csrc/segment_outer_sum.cu), E's and the
  counts in `segment_sum`.

Phases, each fatal:

1. environment: versions, the card's name and power limit; no GPU -> exit 2;
2. build both kernels from source with nvcc, in parallel;
3. each kernel against its plain PyTorch version on the card, at the
   slices' shapes and at edge shapes, and both timed;
4. training, each path with the launch counts set to 0 just before it and
   read just after: TransE 2 epochs of 100 steps (4), RESCAL pairwise 2
   epochs of 100 steps (4b), RESCAL pointwise 10 steps (4c); exact launch
   counts, finite losses and params on the card;
5. one step on the card against the same step on the CPU, TransE (5) and
   RESCAL (5b), from the initial params with the trained run's AdaGrad
   accumulators;
6. filtered ranking of 1,000 held-out triples, TransE (6) and RESCAL (6b).

Prints one JSON line with the kernel table, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py          # from the root of the repository
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from skge_torch import (RESCAL, AdaGrad, FilteredRankingEval,
                        SharedNegativeSampler, TrainState, TransE, init_state,
                        make_epoch_fn, make_pairwise_step, make_pointwise_step)
from skge_torch.data import synthetic_kg
from skge_torch.ops import _build, cuda_outer, cuda_segment

# the data every path trains on: FB15k's shape
DATA = SimpleNamespace(n_entities=14_951, n_relations=1_345, n_train=483_142,
                       n_test=1_000, seed=0)
# the TransE slice: `python bench.py` defaults (TransE-L1, shared pool)
TRANSE = SimpleNamespace(
    model="transe", loss="pairwise", ncomp=150, k=1024, margin=1.0, lr=0.1,
    nbatches=100, epochs=2, seed=0,
)
# the RESCAL slice: `python bench.py --model rescal --ncomp 100`
RESCAL_PAIRWISE = SimpleNamespace(**{**vars(TRANSE), "model": "rescal",
                                     "ncomp": 100, "rparam": 0.0})
RESCAL_POINTWISE = SimpleNamespace(**{**vars(RESCAL_PAIRWISE),
                                      "loss": "pointwise", "epochs": 1,
                                      "steps": 10})
KERNELS = {  # name: (wrapper module, source, the TPU kernel it replaces)
    "segment_sum": (cuda_segment, "skge_torch/csrc/segment_sum.cu",
                    "skge_tpu/ops/pallas_segment.py:109"),
    "segment_outer_sum": (cuda_outer, "skge_torch/csrc/segment_outer_sum.cu",
                          "skge_tpu/ops/pallas_outer.py:128"),
}
RTOL = ATOL = 1e-5  # segment_sum: fp32 sums in atomic order, as in tests/test_pallas.py
OUTER_TOL = dict(rtol=2e-5, atol=2e-4)  # segment_outer_sum, as in tests/test_factored.py
# one step, card against CPU, params and p2. The step starts from warm
# AdaGrad accumulators: from p2 = 0 an update is lr*g/max(|g|, 1e-6), which
# turns an fp32 difference d in a gradient below 1e-6 into a param
# difference of lr*d/1e-6 (RESCAL's E: 1.3e-4 from d ~ 1e-9).
STEP_TOL = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def log(*args) -> None:
    print(*args, flush=True)


def environment() -> str:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    return smi


def build() -> None:
    """One nvcc per source, all started together."""
    def one(name):
        t0 = time.perf_counter()
        path, out = _build.build(name)
        return name, path, out, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(one, KERNELS))
    for name, path, out, dt in built:
        log(f"[2] {name}: {'built' if out is not None else 'cached'} {path.name} "
            f"in {dt:.2f} s")
        for line in (out or "").splitlines():
            if "registers" in line or "spill" in line:
                log("    ptxas:", line.strip())
        KERNELS[name][0]._lib()  # loads, binds the C interface


def call_ms(fn, inputs, n=50):
    """Per call, CUDA events around each call: includes the wrapper's host
    time whenever the host is slower than the card."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in pairs:
        start.record()
        fn(*inputs)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e_) for s, e_ in pairs)


def device_ms(fn, inputs, n=50):
    """Per call, the card's own time: the summed durations of every kernel
    and memset the calls ran (torch.profiler), no host time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn(*inputs)
        torch.cuda.synchronize()
    us = sum(e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    check(us > 0, "the profiler saw the card's kernels")
    return us / n / 1e3


def time_against_plain(kernel, plain, inputs, what) -> tuple[float, float]:
    """Medians of 4 alternating rounds (plain, kernel, kernel, plain) of 50
    calls; returns (kernel, plain) device ms per call."""
    fns = {"kernel": kernel, "plain": plain}
    for fn in fns.values():
        call_ms(fn, inputs, 10)  # warm-up
    times = {(name, how): [] for name in fns for how in ("device", "call")}
    for order in (("plain", "kernel"), ("kernel", "plain")) * 2:
        for name in order:
            times[name, "device"].append(device_ms(fns[name], inputs))
            times[name, "call"].append(call_ms(fns[name], inputs))
    med = {key: statistics.median(v) for key, v in times.items()}
    log(f"[3] {what}, medians of 4 rounds of 50 calls: device time "
        f"kernel {med['kernel', 'device']:.4f} ms, plain "
        f"{med['plain', 'device']:.4f} ms; per-call time with host "
        f"kernel {med['kernel', 'call']:.4f} ms, plain {med['plain', 'call']:.4f} ms")
    return med["kernel", "device"], med["plain", "device"]


def _batch_size(cfg, n=None) -> int:
    return -(-(DATA.n_train if n is None else n) // cfg.nbatches)


def segment_sum_checks(dev) -> tuple[float, float, float]:
    """`segment_sum` against `segment_sum_reference` on the same card
    inputs; returns (max abs error, kernel ms, plain ms) at the TransE
    slice's shape."""
    e, r = DATA.n_entities, DATA.n_relations
    t_slice, rows, width = 3 * _batch_size(TRANSE) + TRANSE.k, e + r, TRANSE.ncomp + 1
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [
        ("slice", t_slice, rows, width, 0, rows),
        ("ids<0 and >=R dropped", t_slice, rows, width, -50, rows + 50),
        ("ragged last block", 1001, 40, 37, 0, 40),
        ("D=1", t_slice, rows, 1, 0, rows),
        ("wide D=22500", 64, 17, 22_500, 0, 19),
        ("T=0", 0, 10, 5, 0, 10),
    ]
    worst = 0.0
    slice_inputs = None
    for name, t, nrows, d, lo, hi in cases:
        idx = torch.randint(lo, hi, (t,), generator=gen, device=dev)
        grads = torch.randn(t, d, generator=gen, device=dev)
        got = cuda_segment.segment_sum(idx, grads, nrows)
        want = cuda_segment.segment_sum_reference(idx, grads, nrows)
        torch.cuda.synchronize()
        check(got.shape == (nrows, d), f"segment_sum shape for {name}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        worst = max(worst, err)
        ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
        log(f"[3] segment_sum {name:24s} T={t:6d} R={nrows:6d} D={d:6d}  "
            f"max|err|={err:.3e}  {'ok' if ok else 'MISMATCH'}")
        check(ok, f"segment_sum against its plain version ({name})")
        if name == "slice":
            slice_inputs = (idx, grads, nrows)
    k_ms, p_ms = time_against_plain(
        cuda_segment.segment_sum, cuda_segment.segment_sum_reference,
        slice_inputs, f"segment_sum at T={t_slice}, R={rows}, D={width}",
    )
    return worst, k_ms, p_ms


def segment_outer_sum_checks(dev) -> tuple[float, float, float]:
    """`segment_outer_sum` against `segment_outer_sum_reference` on the same
    card inputs; returns (max abs error, kernel ms, plain ms) at the RESCAL
    slice's shape (T = one batch, R = relations, d = ncomp, rank 2). Also
    times WN18's 18 relations, where ~268 occurrences land on every row."""
    t_slice, r, d = _batch_size(RESCAL_PAIRWISE), DATA.n_relations, RESCAL_PAIRWISE.ncomp
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [
        ("slice", t_slice, r, d, 2, 0, r),
        ("WN18 R=18", t_slice, 18, d, 2, 0, 18),
        ("ids<0 and >=R dropped", t_slice, r, d, 2, -50, r + 50),
        ("rank 1", t_slice, r, d, 1, 0, r),
        ("ragged T, d=37", 1001, 40, 37, 2, 0, 40),
        ("T=0", 0, 10, 5, 2, 0, 10),
    ]
    worst = 0.0
    timed = {}
    for name, t, nrows, dd, rank, lo, hi in cases:
        idx = torch.randint(lo, hi, (t,), generator=gen, device=dev)
        us, vs = ([torch.randn(t, dd, generator=gen, device=dev) for _ in range(rank)]
                  for _ in range(2))
        got = cuda_outer.segment_outer_sum(idx, us, vs, nrows)
        want = cuda_outer.segment_outer_sum_reference(idx, us, vs, nrows)
        torch.cuda.synchronize()
        check(got.shape == (nrows, dd, dd), f"segment_outer_sum shape for {name}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        worst = max(worst, err)
        ok = bool(torch.allclose(got, want, **OUTER_TOL))
        log(f"[3] segment_outer_sum {name:22s} T={t:5d} R={nrows:5d} d={dd:4d} "
            f"rank={rank}  max|err|={err:.3e}  {'ok' if ok else 'MISMATCH'}")
        check(ok, f"segment_outer_sum against its plain version ({name})")
        if name in ("slice", "WN18 R=18"):
            timed[name] = (idx, us, vs, nrows)
    k_ms, p_ms = time_against_plain(
        cuda_outer.segment_outer_sum, cuda_outer.segment_outer_sum_reference,
        timed["slice"], f"segment_outer_sum at T={t_slice}, R={r}, d={d}, rank 2",
    )
    time_against_plain(
        cuda_outer.segment_outer_sum, cuda_outer.segment_outer_sum_reference,
        timed["WN18 R=18"], f"segment_outer_sum at T={t_slice}, R=18, d={d}, rank 2",
    )
    return worst, k_ms, p_ms


def make_model(cfg, ds):
    if cfg.model == "transe":
        return TransE(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp)
    return RESCAL(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp, rparam=cfg.rparam)


def make_step(cfg, model, opt, sampler):
    if cfg.loss == "pairwise":
        return make_pairwise_step(model, opt, sampler, margin=cfg.margin,
                                  aggregate="dense_pallas")
    return make_pointwise_step(model, opt, sampler, aggregate="dense_pallas")


def train(cfg, ds, dev, tag="4"):
    """Phase 4: one path of the port. Returns (model, opt, initial state,
    trained state, {kernel: launches during training})."""
    model = make_model(cfg, ds)
    opt = AdaGrad(lr=cfg.lr)
    step = make_step(cfg, model, opt, SharedNegativeSampler(ds.n_entities, k=cfg.k))
    state0 = init_state(model, opt, torch.Generator(device=dev).manual_seed(cfg.seed))
    xs = torch.as_tensor(ds.train, dtype=torch.int64, device=dev)
    n = xs.shape[0]
    b = _batch_size(cfg, n)
    if cfg.loss == "pairwise":
        epoch = make_epoch_fn(step, n, cfg.nbatches)
        runs, steps = [epoch] * cfg.epochs, cfg.nbatches
    else:
        # a few steps over the first batches of one shuffle
        perm = torch.randperm(n, generator=state0.generator, device=dev)
        batches = xs[perm[: cfg.steps * b]].reshape(cfg.steps, b, 3)
        mask = torch.ones(b, device=dev)

        def some_steps(state, xs):
            ms = []
            for i in range(cfg.steps):
                state, m = step(state, batches[i], mask)
                ms.append(m)
            return state, SimpleNamespace(
                loss=torch.stack([m.loss for m in ms]),
                nviolations=torch.stack([m.nviolations for m in ms]))

        runs, steps = [some_steps], cfg.steps
    # bench.py's work units per epoch: 2 scored triples per margin-ranked pair
    scored = 2 * 2 * cfg.k * n
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = state0
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
    for e, run in enumerate(runs):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = run(state, xs)
        _sync(dev)
        dt = time.perf_counter() - t0
        check(bool(torch.isfinite(m.loss).all()), f"{cfg.model} finite losses, run {e}")
        rate = (f"  {scored / dt:.6e} scored triples/s"
                if cfg.loss == "pairwise" else "")
        log(f"[{tag}] {cfg.model} {cfg.loss} run {e} ({steps} steps): violations "
            f"{int(m.nviolations.sum())}  loss {float(m.loss.sum()):.6e}  "
            f"{dt:.3f} s  step {1e3 * dt / steps:.3f} ms{rate}")
    launches = {name: mod.launches for name, (mod, _, _) in KERNELS.items()}
    if dev.type == "cuda":
        log(f"[{tag}] peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    for name, p in state.params.items():
        check(p.device == xs.device, f"params[{name!r}] stayed on {xs.device}")
        check(bool(torch.isfinite(p).all()), f"params[{name!r}] finite")
    log(f"[{tag}] kernel launches {launches} for {len(runs) * steps} steps")
    if cfg.model == "transe":
        norm = float(state.params["E"].norm(dim=1).max())
        log(f"[{tag}] max row norm of E {norm:.7f}")
        check(norm <= 1.0 + 1e-5, "normless1: max row norm of E <= 1 + 1e-5")
    return model, opt, state0, state, launches


def expected_launches(cfg) -> dict:
    """Per step: TransE's E and R share one segment_sum; RESCAL runs one
    segment_outer_sum (W) and two segment_sum (E with its count channel,
    W's counts)."""
    steps = cfg.epochs * cfg.nbatches if cfg.loss == "pairwise" else cfg.steps
    if cfg.model == "transe":
        return {"segment_sum": steps, "segment_outer_sum": 0}
    return {"segment_sum": 2 * steps, "segment_outer_sum": steps}


class FixedPool:
    """A `pool`-protocol sampler that always hands out the same ids."""

    def __init__(self, ids, modes=(0, 1)):
        self.ids, self.modes = ids, modes

    def pool(self, generator, pos, mask):
        return self.ids.to(pos.device)


def _state_on(state: TrainState, dev) -> TrainState:
    return TrainState(
        params={k: v.to(dev) for k, v in state.params.items()},
        opt_state={k: {s: v.to(dev) for s, v in slots.items()}
                   for k, slots in state.opt_state.items()},
        generator=torch.Generator(device=dev),
        step=state.step,
    )


def step_against_cpu(cfg, ds, model, opt, start, dev, tag="5") -> None:
    """Phase 5: one step from the same state, batch and pool, on the card
    (kernels) and on the CPU (plain versions). At the initial params every
    pair violates by a wide margin, so the violation counts must agree."""
    gen = torch.Generator().manual_seed(cfg.seed + 2)
    b = _batch_size(cfg, ds.train.shape[0])
    rows = torch.randperm(ds.train.shape[0], generator=gen)[:b]
    batch = torch.as_tensor(ds.train, dtype=torch.int64)[rows]
    pool = torch.randint(0, ds.n_entities, (cfg.k,), generator=gen)
    mask = torch.ones(b)
    step = make_step(cfg, model, opt, FixedPool(pool))
    t0 = time.perf_counter()
    dev_state, dev_m = step(_state_on(start, dev), batch.to(dev), mask.to(dev))
    _sync(dev)
    t1 = time.perf_counter()
    cpu_state, cpu_m = step(_state_on(start, torch.device("cpu")), batch, mask)
    t2 = time.perf_counter()
    nv_dev, nv_cpu = int(dev_m.nviolations), int(cpu_m.nviolations)
    with torch.no_grad():
        p = {k: v.to(dev) for k, v in start.params.items()}
        r = model.gather_rows(p, *(batch.to(dev)[:, i] for i in range(3)))
        gp = model.score_from_rows(r, {})
        near = sum(
            int(((model.score_pool(r, p["E"][pool.to(dev)], {}, mode)
                  + cfg.margin - gp[:, None]).abs() < 1e-4).sum())
            for mode in (0, 1)
        )
    log(f"[{tag}] {cfg.model}: violations card {nv_dev} cpu {nv_cpu}; pairs "
        f"within 1e-4 of the margin {near}; step {t1 - t0:.3f} s card, "
        f"{t2 - t1:.3f} s cpu")
    for name in start.params:
        diff = float((dev_state.params[name].cpu() - cpu_state.params[name]).abs().max())
        cpu_p2 = cpu_state.opt_state[name]["p2"]
        dp2 = float((dev_state.opt_state[name]["p2"].cpu() - cpu_p2).abs().max())
        p2_max = float(cpu_p2.max())
        moved = float((cpu_state.params[name] - start.params[name].cpu()).abs().max())
        log(f"[{tag}] max|d{name}| {diff:.3e}  max|d p2[{name}]| {dp2:.3e} "
            f"(max p2 {p2_max:.3e}; max update of {name} {moved:.3e})")
        # p2 sums squares and grows with training: held relative to its size
        check(diff <= STEP_TOL and dp2 <= STEP_TOL * max(1.0, p2_max),
              f"one {cfg.model} step card vs CPU: {name} within {STEP_TOL}")
    check(nv_dev == nv_cpu, f"one {cfg.model} step card vs CPU: same violation count")


def evaluate(ds, model, state, dev, tag="6") -> None:
    t0 = time.perf_counter()
    res = FilteredRankingEval(model, ds.test, ds.all_triples())(state.params)
    _sync(dev)
    dt = time.perf_counter() - t0
    for ranks in (res.ranks, res.ranks_raw):
        check(ranks.shape == (2, len(ds.test)), "rank array shape")
        check(bool(np.all((ranks >= 1) & (ranks <= ds.n_entities))),
              "ranks lie in [1, n_entities]")
    log(f"[{tag}] {model.name}: filtered ranking of {len(ds.test)} held-out "
        f"triples in {dt:.2f} s: "
        + json.dumps({k: round(v, 6) for k, v in res.summary().items()}))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    smi = environment()
    dev = torch.device("cuda", 0)
    build()
    checks = {"segment_sum": segment_sum_checks(dev),
              "segment_outer_sum": segment_outer_sum_checks(dev)}
    ds = synthetic_kg(DATA.n_entities, DATA.n_relations, DATA.n_train,
                      n_test=DATA.n_test, seed=DATA.seed, clustered=False)
    launches = dict.fromkeys(KERNELS, 0)
    trained = {}
    for cfg, tag in ((TRANSE, "4"), (RESCAL_PAIRWISE, "4b"), (RESCAL_POINTWISE, "4c")):
        *run, counts = train(cfg, ds, dev, tag)
        check(counts == expected_launches(cfg),
              f"{cfg.model} {cfg.loss}: launches {counts}, want {expected_launches(cfg)}")
        for name in KERNELS:
            launches[name] += counts[name]
        trained.setdefault(cfg.model, (cfg, *run))
    for (cfg, model, opt, state0, state), tag in zip(trained.values(), ("", "b")):
        start = state0._replace(opt_state=state.opt_state)
        step_against_cpu(cfg, ds, model, opt, start, dev, "5" + tag)
        evaluate(ds, model, state, dev, "6" + tag)
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": checks[name][0],
        "ms": checks[name][1],
        "plain_ms": checks[name][2],
    } for name, (_, source, replaces) in KERNELS.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
