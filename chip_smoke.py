#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`skge_torch`) on one NVIDIA GPU.

Drives the port's main path once at full width: TransE-L1 (ncomp=150)
trained with the pairwise margin loss against a shared pool of 1,024
negatives on FB15k-shaped synthetic data (14,951 entities, 1,345
relations, 483,142 train triples; the `python bench.py` configuration),
AdaGrad, with every gradient scatter in the hand-written CUDA kernel
`segment_sum` (skge_torch/csrc/segment_sum.cu). Phases, each fatal:

1. environment: versions, the card's name and power limit; no GPU -> exit 2;
2. build the kernel from source with nvcc;
3. the kernel against its plain PyTorch version on the card, at the
   slice's shape and at edge shapes, and both timed;
4. training, 2 epochs of 100 steps: exactly one kernel launch per step,
   finite losses, params on the card, entity rows inside the unit ball;
5. one step on the card against the same step on the CPU;
6. filtered ranking of 1,000 held-out triples.

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
from types import SimpleNamespace

import numpy as np
import torch

from skge_torch import (AdaGrad, FilteredRankingEval, SharedNegativeSampler,
                        TrainState, TransE, init_state, make_epoch_fn,
                        make_pairwise_step)
from skge_torch.data import synthetic_kg
from skge_torch.ops import _build, cuda_segment

# the slice: `python bench.py` defaults (TransE-L1, shared pool)
SLICE = SimpleNamespace(
    n_entities=14_951, n_relations=1_345, n_train=483_142, n_test=1_000,
    ncomp=150, k=1024, margin=1.0, lr=0.1, nbatches=100, epochs=2, seed=0,
)
RTOL = ATOL = 1e-5  # fp32 sums in atomic order, as in tests/test_pallas.py
STEP_TOL = 1e-5     # one step, card against CPU


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
    t0 = time.perf_counter()
    path, out = _build.build("segment_sum")
    dt = time.perf_counter() - t0
    log(f"[2] segment_sum: {'built' if out is not None else 'cached'} {path.name} "
        f"in {dt:.2f} s")
    for line in (out or "").splitlines():
        if "registers" in line or "spill" in line:
            log("    ptxas:", line.strip())
    cuda_segment._lib()  # loads, binds the C interface


def kernel_checks(dev) -> tuple[float, float, float]:
    """The kernel against `segment_sum_reference` on the same card inputs;
    returns (max abs error, kernel ms, plain ms) at the slice's shape."""
    e, r, k = SLICE.n_entities, SLICE.n_relations, SLICE.k
    b = -(-SLICE.n_train // SLICE.nbatches)
    t_slice, rows, width = 3 * b + k, e + r, SLICE.ncomp + 1
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
        log(f"[3] {name:24s} T={t:6d} R={nrows:6d} D={d:6d}  "
            f"max|err|={err:.3e}  {'ok' if ok else 'MISMATCH'}")
        check(ok, f"segment_sum against its plain version ({name})")
        if name == "slice":
            slice_inputs = (idx, grads, nrows)

    def call_ms(fn, n=50):
        """Per call, CUDA events around each call: includes the wrapper's
        host time whenever the host is slower than the card."""
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for start, end in pairs:
            start.record()
            fn(*slice_inputs)
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e_) for s, e_ in pairs)

    def device_ms(fn, n=50):
        """Per call, the card's own time: the summed durations of every
        kernel and memset the calls ran (torch.profiler), no host time."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn(*slice_inputs)
            torch.cuda.synchronize()
        us = sum(e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        check(us > 0, "the profiler saw the card's kernels")
        return us / n / 1e3

    fns = {"kernel": cuda_segment.segment_sum,
           "plain": cuda_segment.segment_sum_reference}
    for fn in fns.values():
        call_ms(fn, 10)  # warm-up
    times = {(name, how): [] for name in fns for how in ("device", "call")}
    for order in (("plain", "kernel"), ("kernel", "plain")) * 2:
        for name in order:
            times[name, "device"].append(device_ms(fns[name]))
            times[name, "call"].append(call_ms(fns[name]))
    med = {key: statistics.median(v) for key, v in times.items()}
    log(f"[3] slice shape, medians of 4 rounds of 50 calls: device time "
        f"kernel {med['kernel', 'device']:.4f} ms, plain index_add_ "
        f"{med['plain', 'device']:.4f} ms; per-call time with host "
        f"kernel {med['kernel', 'call']:.4f} ms, plain {med['plain', 'call']:.4f} ms")
    return worst, med["kernel", "device"], med["plain", "device"]


def train(cfg, dev):
    """Phase 4: the main path. Returns (dataset, model, opt, initial state,
    trained state, kernel launches during training)."""
    ds = synthetic_kg(cfg.n_entities, cfg.n_relations, cfg.n_train,
                      n_test=cfg.n_test, seed=cfg.seed, clustered=False)
    model = TransE(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp)
    opt = AdaGrad(lr=cfg.lr)
    step = make_pairwise_step(
        model, opt, SharedNegativeSampler(ds.n_entities, k=cfg.k),
        margin=cfg.margin, aggregate="dense_pallas",
    )
    epoch = make_epoch_fn(step, ds.train.shape[0], cfg.nbatches)
    state0 = init_state(model, opt, torch.Generator(device=dev).manual_seed(cfg.seed))
    xs = torch.as_tensor(ds.train, dtype=torch.int64, device=dev)
    scored = 2 * 2 * cfg.k * ds.train.shape[0]  # bench.py's work units per epoch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cuda_segment.launches = 0
    state = state0
    for e in range(cfg.epochs):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = epoch(state, xs)
        _sync(dev)
        dt = time.perf_counter() - t0
        check(bool(torch.isfinite(m.loss).all()), f"finite losses, epoch {e}")
        log(f"[4] epoch {e}: violations {int(m.nviolations.sum())}  "
            f"loss {float(m.loss.sum()):.6e}  {dt:.3f} s  "
            f"step {1e3 * dt / cfg.nbatches:.3f} ms  "
            f"{scored / dt:.6e} scored triples/s")
    launches = cuda_segment.launches
    if dev.type == "cuda":
        log(f"[4] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    for name, p in state.params.items():
        check(p.device == xs.device, f"params[{name!r}] stayed on {xs.device}")
    norm = float(state.params["E"].norm(dim=1).max())
    log(f"[4] max row norm of E {norm:.7f}; kernel launches {launches} "
        f"for {cfg.epochs * cfg.nbatches} steps")
    check(norm <= 1.0 + 1e-5, "normless1: max row norm of E <= 1 + 1e-5")
    return ds, model, opt, state0, state, launches


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


def step_against_cpu(cfg, ds, model, opt, state0, dev) -> None:
    """Phase 5: one step from the same state, batch and pool, on the card
    (kernel) and on the CPU (plain version)."""
    gen = torch.Generator().manual_seed(cfg.seed + 2)
    b = -(-ds.train.shape[0] // cfg.nbatches)
    rows = torch.randperm(ds.train.shape[0], generator=gen)[:b]
    batch = torch.as_tensor(ds.train, dtype=torch.int64)[rows]
    pool = torch.randint(0, ds.n_entities, (cfg.k,), generator=gen)
    mask = torch.ones(b)
    step = make_pairwise_step(model, opt, FixedPool(pool), cfg.margin,
                              aggregate="dense_pallas")
    t0 = time.perf_counter()
    dev_state, dev_m = step(_state_on(state0, dev), batch.to(dev), mask.to(dev))
    _sync(dev)
    t1 = time.perf_counter()
    cpu_state, cpu_m = step(_state_on(state0, torch.device("cpu")), batch, mask)
    t2 = time.perf_counter()
    nv_dev, nv_cpu = int(dev_m.nviolations), int(cpu_m.nviolations)
    with torch.no_grad():
        p = {k: v.to(dev) for k, v in state0.params.items()}
        r = model.gather_rows(p, *(batch.to(dev)[:, i] for i in range(3)))
        gp = model.score_from_rows(r, {})
        near = sum(
            int(((model.score_pool(r, p["E"][pool.to(dev)], {}, mode)
                  + cfg.margin - gp[:, None]).abs() < 1e-4).sum())
            for mode in (0, 1)
        )
    log(f"[5] violations card {nv_dev} cpu {nv_cpu}; pairs within 1e-4 of "
        f"the margin {near}; step {t1 - t0:.3f} s card, {t2 - t1:.3f} s cpu")
    for name in ("E", "R"):
        diff = float((dev_state.params[name].cpu() - cpu_state.params[name]).abs().max())
        dp2 = float((dev_state.opt_state[name]["p2"].cpu()
                     - cpu_state.opt_state[name]["p2"]).abs().max())
        log(f"[5] max|d{name}| {diff:.3e}  max|d p2[{name}]| {dp2:.3e}")
        check(diff <= STEP_TOL and dp2 <= STEP_TOL,
              f"one step card vs CPU: {name} within {STEP_TOL}")
    check(nv_dev == nv_cpu, "one step card vs CPU: same violation count")


def evaluate(ds, model, state, dev) -> None:
    t0 = time.perf_counter()
    res = FilteredRankingEval(model, ds.test, ds.all_triples())(state.params)
    _sync(dev)
    dt = time.perf_counter() - t0
    for ranks in (res.ranks, res.ranks_raw):
        check(ranks.shape == (2, len(ds.test)), "rank array shape")
        check(bool(np.all((ranks >= 1) & (ranks <= ds.n_entities))),
              "ranks lie in [1, n_entities]")
    log(f"[6] filtered ranking of {len(ds.test)} held-out triples in {dt:.2f} s: "
        + json.dumps({k: round(v, 6) for k, v in res.summary().items()}))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    smi = environment()
    dev = torch.device("cuda", 0)
    build()
    worst, k_ms, p_ms = kernel_checks(dev)
    ds, model, opt, state0, state, launches = train(SLICE, dev)
    check(launches == SLICE.epochs * SLICE.nbatches,
          "exactly one segment_sum launch per training step")
    step_against_cpu(SLICE, ds, model, opt, state0, dev)
    evaluate(ds, model, state, dev)
    log(json.dumps({"kernels": [{
        "name": "segment_sum",
        "route": "cuda",
        "source": "skge_torch/csrc/segment_sum.cu",
        "replaces": "skge_tpu/ops/pallas_segment.py:109",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
