#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`skge_torch`) on one NVIDIA GPU.

Drives the port's paths once at full width, AdaGrad lr 0.1, 100 batches
per epoch, aggregate="dense_pallas", fp32 with TF32 off, on two synthetic
graphs: FB15k's shape (14,951 entities, 1,345 relations, 483,142 train
triples) and WN18's (40,943 entities, 18 relations, 141,442 train
triples). Every gradient scatter runs in the CUDA kernel `segment_sum`
(skge_torch/csrc/segment_sum.cu), and RESCAL's factored shared-pool W
gradient in `segment_outer_sum` (skge_torch/csrc/segment_outer_sum.cu).

Shared negative pool of 1,024 (`python bench.py`'s scheme), FB15k:
- TransE-L1, ncomp=150, margin 1.0 (`python bench.py`'s default);
- RESCAL, ncomp=100 (`bench.py --model rescal --ncomp 100`), pairwise and
  pointwise.
Reference-exact iid negatives (`pairwise_grads_fused`):
- TransE-L1 on FB15k with 16 random-mode negatives per positive
  (`bench.py --sampler random-mode --negatives 8 --aggregate dense_pallas`);
- HolE, ncomp=150, sigmoid before the margin 0.2, on WN18, one random-mode
  negative per positive and mode (`experiment.py`'s defaults);
- ER-MLP, ncomp=150, nhidden=10, margin 0.2, on FB15k with the Bernoulli
  sampler;
- HolE on WN18 with the LCWA and the corrupted sampler, the iid pointwise
  step, and the shared pool at k=4,096 (`bench.py --model hole --k 4096`).

Phases, each fatal:

1. environment: versions, the card's name and power limit; no GPU -> exit 2;
2. build both kernels from source with nvcc, in parallel;
3. each kernel against its plain PyTorch version on the card, at the
   paths' shapes and at edge shapes, and timed beside its bound (the bytes
   it must move at 3.35 TB/s, or its fp32 operations at 67 TFLOP/s).
   `segment_sum` on its 16-byte path (D = 152) and its scalar path (D =
   151, a misaligned view, D = 1), within 1e-5, also at the iid TransE
   step's 91,808 occurrences, and timed beside `index_add_` alone;
   `segment_sum`'s scalar path also timed alone at D = 151 and at RESCAL's
   W counts (D = 1); `segment_outer_sum` equal bit for bit to its in-order
   plain version and to itself in a second call, also at ranks 1, 3 and 4,
   d = 37, 12 and 1,100, and with half of the occurrences on one row at
   ranks 1, 3 and 4; timed at WN18's 18 relations, with half and with all
   of the occurrences on one row and with Zipf-distributed ids, beside its
   grouping alone;
4. training, each path with the launch counts set to 0 just before it and
   read just after, exact launch counts (every gradient scatter on K1's
   16-byte path), finite losses and params on the
   card: TransE (4), RESCAL pairwise (4b), 2 epochs of 100 steps each;
   RESCAL pointwise 10 steps (4c); iid TransE (4d), HolE (4e) and ER-MLP
   (4f), 2 epochs of 100 steps each, with the device's busy time per step
   (also for 4b);
   HolE's LCWA, corrupted, pointwise and k=4,096 paths, 10
   steps each (4g);
5. one step on the card against the same step on the CPU, TransE (5),
   RESCAL (5b), HolE (5c, and the card's `unique` aggregation against its
   `dense_pallas`) and ER-MLP (5d), from the initial params with the
   trained run's AdaGrad accumulators;
6. filtered ranking of 1,000 held-out triples, TransE (6), RESCAL (6b),
   HolE (6c) and ER-MLP (6d).

Prints one JSON line with the kernel table, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py          # from the root of the repository

`--kernel-times` runs phases 1-2 and phase 3's timings alone, on the same
inputs and without the checks, and prints no result line. Copied into an
older tree of the repository and run there, it times that tree's kernels
at this tree's shapes: parent against change on one card.
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

from skge_torch import (ERMLP, RESCAL, AdaGrad, BernoulliSampler,
                        CorruptedSampler, FilteredRankingEval, HolE,
                        LCWASampler, RandomModeSampler, SharedNegativeSampler,
                        TrainState, TransE, init_state, make_epoch_fn,
                        make_pairwise_step, make_pointwise_step)
from skge_torch.data import (bernoulli_probs, sorted_train_keys, synthetic_kg,
                             type_index_arrays)
from skge_torch.models.base import ACTIVATIONS
from skge_torch.ops import _build, cuda_outer, cuda_segment

# the graphs the paths train on: FB15k's shape (DATA) and WN18's
DATA = SimpleNamespace(n_entities=14_951, n_relations=1_345, n_train=483_142,
                       n_test=1_000, seed=0)
WN18 = SimpleNamespace(n_entities=40_943, n_relations=18, n_train=141_442,
                       n_test=1_000, seed=0)
# the TransE slice: `python bench.py` defaults (TransE-L1, shared pool)
TRANSE = SimpleNamespace(
    model="transe", loss="pairwise", sampler="shared", ncomp=150, k=1024,
    margin=1.0, lr=0.1, nbatches=100, epochs=2, steps=0, seed=0, data="fb15k",
    profile=False,
)
# the RESCAL slice: `python bench.py --model rescal --ncomp 100`
RESCAL_PAIRWISE = SimpleNamespace(**{**vars(TRANSE), "model": "rescal",
                                     "ncomp": 100, "rparam": 0.0, "profile": True})
RESCAL_POINTWISE = SimpleNamespace(**{**vars(RESCAL_PAIRWISE),
                                      "loss": "pointwise", "steps": 10,
                                      "profile": False})
# the iid slice. `bench.py --sampler random-mode --negatives 8`: 16 pairs
# per positive
TRANSE_IID = SimpleNamespace(**{**vars(TRANSE), "sampler": "random-mode",
                                "negatives": 8, "profile": True})
# `experiment.py`'s defaults: HolE, sigmoid before the margin 0.2, one
# random-mode negative per positive and mode; "HolE on WN18" of BASELINE.json
HOLE = SimpleNamespace(**{**vars(TRANSE), "model": "hole", "sampler": "random-mode",
                          "negatives": 1, "margin": 0.2, "rparam": 0.0,
                          "data": "wn18", "profile": True})
# "ER-MLP on FB15k with Bernoulli negative sampling" of BASELINE.json
ERMLP_BERNOULLI = SimpleNamespace(**{**vars(TRANSE), "model": "ermlp",
                                     "sampler": "bernoulli", "nhidden": 10,
                                     "margin": 0.2, "profile": True})
HOLE_LCWA = SimpleNamespace(**{**vars(HOLE), "sampler": "lcwa", "ntries": 100,
                               "steps": 10, "profile": False})
HOLE_CORRUPTED = SimpleNamespace(**{**vars(HOLE_LCWA), "sampler": "corrupted"})
HOLE_POINTWISE = SimpleNamespace(**{**vars(HOLE_LCWA), "sampler": "random-mode",
                                    "loss": "pointwise"})
# `bench.py`'s ALL_ROWS row `--model hole --k 4096`
HOLE_SHARED = SimpleNamespace(**{**vars(HOLE_LCWA), "sampler": "shared", "k": 4096})
PATHS = (  # (config, phase)
    (TRANSE, "4"), (RESCAL_PAIRWISE, "4b"), (RESCAL_POINTWISE, "4c"),
    (TRANSE_IID, "4d"), (HOLE, "4e"), (ERMLP_BERNOULLI, "4f"),
    (HOLE_LCWA, "4g"), (HOLE_CORRUPTED, "4g"), (HOLE_POINTWISE, "4g"),
    (HOLE_SHARED, "4g"),
)
KERNELS = {  # name: (wrapper module, source, the TPU kernel it replaces)
    "segment_sum": (cuda_segment, "skge_torch/csrc/segment_sum.cu",
                    "skge_tpu/ops/pallas_segment.py:109"),
    "segment_outer_sum": (cuda_outer, "skge_torch/csrc/segment_outer_sum.cu",
                          "skge_tpu/ops/pallas_outer.py:128"),
}
RTOL = ATOL = 1e-5  # segment_sum: fp32 sums in atomic order, as in tests/test_pallas.py
# the least time of a call: its bytes at the HBM rate, or its fp32
# operations at the rate outside the tensor cores (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
VECTOR = "segment_sum 16-byte path"  # the launch count of K1's float4 path
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


def device_ms(fn, inputs, n=50, tries=3):
    """Per call, the card's own time: the summed durations of every kernel
    and memset the calls ran (torch.profiler), no host time. A profile that
    saw no kernel at all (the profiler now and then drops a profile's
    device records) is taken again, up to `tries` times."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn(*inputs)
            torch.cuda.synchronize()
        us = sum(e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / n / 1e3
        log(f"[3] the profiler saw no kernel of {n} calls (try {attempt + 1} of {tries})")
    check(False, "the profiler saw the card's kernels")


def time_rounds(fns, inputs, what, n=50, n_plain=None) -> dict:
    """Medians of 4 alternating rounds (in order, then reversed, twice) of
    `n` calls of each of `fns` {name: fn} (`n_plain` of "plain", whose
    many small ops make the profiler slow); returns {name: device ms per
    call}."""
    t0 = time.perf_counter()
    calls = {name: n_plain if name == "plain" and n_plain else n for name in fns}
    for name, fn in fns.items():
        call_ms(fn, inputs, min(calls[name], 10))  # warm-up
    times = {(name, how): [] for name in fns for how in ("device", "call")}
    for order in (list(fns), list(fns)[::-1]) * 2:
        for name in order:
            times[name, "device"].append(device_ms(fns[name], inputs, calls[name]))
            times[name, "call"].append(call_ms(fns[name], inputs, calls[name]))
    med = {key: statistics.median(v) for key, v in times.items()}
    log(f"[3] {what}, medians of 4 rounds of " + ", ".join(
        f"{calls[name]} calls of {name}" for name in fns) + ": device time " + ", ".join(
        f"{name} {med[name, 'device']:.4f} ms" for name in fns)
        + "; per-call time with host " + ", ".join(
        f"{name} {med[name, 'call']:.4f} ms" for name in fns)
        + f" ({time.perf_counter() - t0:.1f} s)")
    return {name: med[name, "device"] for name in fns}


def bound(nbytes, flops) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes at the HBM rate and the
    operations at the fp32 rate."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def timed_shape(what, times, nbytes, flops) -> dict:
    """One timed shape of a kernel: its times, its bound and its share."""
    b_ms, b_by = bound(nbytes, flops)
    shape = {"shape": what, "ms": times["kernel"], "plain_ms": times.get("plain"),
             "library_ms": times.get("library"), "bound_ms": b_ms, "bound_by": b_by,
             "bound_share": b_ms / times["kernel"]}
    if "grouping" in times:  # K2's index preparation, part of "ms"
        shape["grouping_ms"] = times["grouping"]
    log(f"[3] {what}: bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB, "
        f"{flops / 1e6:.1f} MFLOP), kernel at {100 * shape['bound_share']:.1f}% of it")
    return shape


def _batch_size(cfg, n=None) -> int:
    return -(-(DATA.n_train if n is None else n) // cfg.nbatches)


def check_segment_sum(name, idx, grads, nrows, vector) -> float:
    """One case: `segment_sum` against `segment_sum_reference` on the same
    card inputs, on the path it must take; returns the max abs error."""
    t, d = grads.shape
    before = cuda_segment.vector_launches
    got = cuda_segment.segment_sum(idx, grads, nrows)
    want = cuda_segment.segment_sum_reference(idx, grads, nrows)
    torch.cuda.synchronize()
    check(got.shape == (nrows, d), f"segment_sum shape for {name}")
    check(cuda_segment.vector_launches - before == int(vector and t > 0),
          f"segment_sum took the {'16-byte' if vector else 'scalar'} path ({name})")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
    log(f"[3] segment_sum {name:24s} T={t:6d} R={nrows:6d} D={d:6d} "
        f"{'16-byte' if vector else 'scalar '}  max|err|={err:.3e}  "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"segment_sum against its plain version ({name})")
    return err


def segment_sum_checks(dev, verify=True) -> tuple[float, list]:
    """`segment_sum` against `segment_sum_reference` on the same card
    inputs, on the 16-byte and the scalar path (`verify`); returns (max abs
    error, [timed shapes]): the TransE slice's shape first, then the iid
    TransE step's (s, o and 16 corruptions into E, and R, in one scatter),
    each beside `index_add_` alone on the same (in-range) ids."""
    e, r = DATA.n_entities, DATA.n_relations
    width = TRANSE.ncomp + 1 + (-(TRANSE.ncomp + 1) % 4)  # aggregate's padded count channel
    t_slice, rows = 3 * _batch_size(TRANSE) + TRANSE.k, e + r
    t_iid = (3 + 2 * TRANSE_IID.negatives) * _batch_size(TRANSE_IID)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [  # name, T, R, D, low id, high id, storage offset, 16-byte path
        ("slice", t_slice, rows, width, 0, rows, 0, True),
        ("iid", t_iid, rows, width, 0, rows, 0, True),
        ("ids<0 and >=R dropped", t_slice, rows, width, -50, rows + 50, 0, True),
        ("D=151 scalar path", t_slice, rows, width - 1, 0, rows, 0, False),
        ("misaligned view", t_slice, rows, width, 0, rows, 1, False),
        ("ragged last block", 1001, 40, 37, 0, 40, 0, False),
        ("D=1", t_slice, rows, 1, 0, rows, 0, False),
        ("RESCAL's W counts, D=1", _batch_size(RESCAL_PAIRWISE), r, 1, 0, r, 0, False),
        ("wide D=22500", 64, 17, 22_500, 0, 19, 0, True),
        ("T=0", 0, 10, 5, 0, 10, 0, False),
    ]
    worst = 0.0
    timed = {}
    for name, t, nrows, d, lo, hi, shift, vector in cases:
        idx = torch.randint(lo, hi, (t,), generator=gen, device=dev)
        grads = torch.randn(t * d + shift, generator=gen, device=dev)[shift:].view(t, d)
        if verify:
            worst = max(worst, check_segment_sum(name, idx, grads, nrows, vector))
        if name in ("slice", "iid", "D=151 scalar path", "RESCAL's W counts, D=1"):
            timed[name] = (idx, grads, nrows)
    shapes = []
    for name, (idx, grads, nrows) in timed.items():
        t, d = grads.shape
        table = torch.zeros(nrows, d, device=dev)
        fns = {"kernel": cuda_segment.segment_sum}
        if name in ("slice", "iid"):  # the scalar path: the kernel alone
            fns["plain"] = cuda_segment.segment_sum_reference
            fns["library"] = lambda i, g, _: table.index_add_(0, i, g)
        times = time_rounds(fns, timed[name], f"segment_sum at T={t}, R={nrows}, D={d} ({name})")
        shapes.append(timed_shape(
            f"T={t}, R={nrows}, D={d}" + ("" if "plain" in fns else ", scalar path"), times,
            nbytes=8 * t + 4 * t * d + 4 * nrows * d, flops=t * d))
    return worst, shapes


def check_segment_outer_sum(name, idx, us, vs, nrows) -> float:
    """One case: `segment_outer_sum` bit-equal to
    `segment_outer_sum_reference` on the same card inputs and to itself in
    a second call; returns the max abs error."""
    t, dd = us[0].shape
    got = cuda_outer.segment_outer_sum(idx, us, vs, nrows)
    again = cuda_outer.segment_outer_sum(idx, us, vs, nrows)
    want = cuda_outer.segment_outer_sum_reference(idx, us, vs, nrows)
    torch.cuda.synchronize()
    check(got.shape == (nrows, dd, dd), f"segment_outer_sum shape for {name}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = bool(torch.equal(got, want)) and bool(torch.equal(got, again))
    counts = torch.bincount(idx[(idx >= 0) & (idx < nrows)], minlength=nrows)
    long = counts > 64  # rows longer than a window of the kernel's stream
    log(f"[3] segment_outer_sum {name:22s} T={t:5d} R={nrows:5d} d={dd:4d} "
        f"rank={len(us)} longest row {int(counts.max()) if t else 0:5d}, "
        f"{int(long.sum())} rows of > 64 hold {int(counts[long].sum())} of T  "
        f"{'equal to the plain version and to itself' if ok else 'MISMATCH'}")
    check(ok, f"segment_outer_sum bit-equal to its plain version and itself ({name})")
    return err


def segment_outer_sum_checks(dev, verify=True) -> tuple[float, list]:
    """`segment_outer_sum` against `segment_outer_sum_reference` on the
    same card inputs, bit for bit, and against itself in a second call
    (`verify`); returns (max abs error, [timed shapes]): the RESCAL
    slice's shape first (T = one batch, R = relations, d = ncomp, rank 2),
    then WN18's 18
    relations (~268 occurrences on every row), half and all of the
    occurrences on row 0 (the longest serial chain there can be), and
    Zipf-distributed ids (P(r) ~ 1 / (r + 1): the long rows have
    neighbouring ids); the plain version is timed at the first only. Each
    timed shape also times the grouping (`group_by_row`) alone."""
    t_slice, r, d = _batch_size(RESCAL_PAIRWISE), DATA.n_relations, RESCAL_PAIRWISE.ncomp
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [  # name, T, R, d, rank, low id, high id
        ("slice", t_slice, r, d, 2, 0, r),
        ("WN18 R=18", t_slice, 18, d, 2, 0, 18),
        ("half on row 0", t_slice, 18, d, 2, 0, 18),
        ("all on row 0", t_slice, 18, d, 2, 0, 1),
        ("Zipf", t_slice, r, d, 2, 0, r),
        ("ids<0 and >=R dropped", t_slice, r, d, 2, -50, r + 50),
        ("rank 1", t_slice, r, d, 1, 0, r),
        ("ragged T, d=37", 1001, 40, 37, 2, 0, 40),
        ("d=1100, rank 3", 300, 7, 1100, 3, 0, 7),
        ("d=12, rank 4", 500, 9, 12, 4, 0, 9),
        # a long row, walked in slabs, at the other ranks and staging widths
        ("half on row 0, rank 1", t_slice, 18, d, 1, 0, 18),
        ("half on row 0, d=37, rank 3", 1001, 5, 37, 3, 0, 5),
        ("half on row 0, d=12, rank 4", 2000, 9, 12, 4, 0, 9),
        ("T=0", 0, 10, 5, 2, 0, 10),
    ]
    worst = 0.0
    timed = {}
    for name, t, nrows, dd, rank, lo, hi in cases:
        idx = torch.randint(lo, hi, (t,), generator=gen, device=dev)
        if name.startswith("half on row 0"):
            idx[torch.randperm(t, generator=gen, device=dev)[: t // 2]] = 0
        if name == "Zipf":
            p = 1.0 / torch.arange(1, nrows + 1, device=dev)
            idx = torch.multinomial(p, t, replacement=True, generator=gen)
        us, vs = ([torch.randn(t, dd, generator=gen, device=dev) for _ in range(rank)]
                  for _ in range(2))
        if verify:
            worst = max(worst, check_segment_outer_sum(name, idx, us, vs, nrows))
        if name in ("slice", "WN18 R=18", "half on row 0", "all on row 0", "Zipf"):
            timed[name] = (idx, us, vs, nrows)
    shapes = []
    for name, (idx, us, vs, nrows) in timed.items():
        t, dd = us[0].shape
        fns = {"kernel": cuda_outer.segment_outer_sum}
        if hasattr(cuda_outer, "group_by_row"):  # an older tree's K2 takes no grouping
            fns["grouping"] = lambda i, _u, _v, n: cuda_outer.group_by_row(i, n)
        if name == "slice":
            fns["plain"] = cuda_outer.segment_outer_sum_reference
        times = time_rounds(fns, timed[name], f"segment_outer_sum at T={t}, R={nrows}, "
                            f"d={dd}, rank 2 ({name})", n_plain=3)
        shapes.append(timed_shape(
            f"T={t}, R={nrows}, d={dd}, rank 2"
            + ("" if name in ("slice", "WN18 R=18") else f", {name}"),
            times, nbytes=8 * t + 2 * len(us) * 4 * t * dd + 4 * nrows * dd * dd,
            flops=2 * len(us) * t * dd * dd))
    return worst, shapes


def make_model(cfg, ds):
    if cfg.model == "transe":
        return TransE(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp)
    if cfg.model == "rescal":
        return RESCAL(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp, rparam=cfg.rparam)
    if cfg.model == "hole":
        return HolE(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp, rparam=cfg.rparam)
    return ERMLP(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp, nhidden=cfg.nhidden)


def make_sampler(cfg, ds, dev):
    """The path's sampler, its index arrays on `dev`."""
    n_e, n_r = ds.n_entities, ds.n_relations
    if cfg.sampler == "shared":
        return SharedNegativeSampler(n_e, k=cfg.k)
    if cfg.sampler == "random-mode":
        return RandomModeSampler(n_e, modes=(0, 1) * cfg.negatives)
    if cfg.sampler == "bernoulli":
        return BernoulliSampler(
            n_e, torch.as_tensor(bernoulli_probs(ds.train, n_r), device=dev))
    if cfg.sampler == "lcwa":
        return LCWASampler(n_e, n_r, torch.as_tensor(sorted_train_keys(ds), device=dev),
                           ntries=cfg.ntries)
    return CorruptedSampler(n_e, *(torch.as_tensor(a, device=dev)
                                   for a in type_index_arrays(ds.train, n_r)))


def pairs_per_positive(cfg) -> int:
    """Margin-ranked pairs (or appended negatives) per positive, as
    `bench.py` counts them."""
    if cfg.sampler == "shared":
        return 2 * cfg.k
    if cfg.sampler == "random-mode":
        return 2 * cfg.negatives
    return 1 if cfg.sampler == "bernoulli" else 2


def make_step(cfg, model, opt, sampler, aggregate="dense_pallas"):
    if cfg.loss == "pairwise":
        return make_pairwise_step(model, opt, sampler, margin=cfg.margin,
                                  aggregate=aggregate)
    return make_pointwise_step(model, opt, sampler, aggregate=aggregate)


def profile(step, state, batches, mask, step_ms, tag) -> None:
    """The card's busy time per step over 5 steps (torch.profiler), its
    share of the unprofiled step time, and the operators that take it."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(5):
            state, _ = step(state, batches[i], mask)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 5e3
    check(busy > 0, "the profiler saw the card's kernels")
    log(f"[{tag}] device busy {busy:.4f} ms per step ({len(kernels) / 5:.0f} device "
        f"events per step): {100 * busy / step_ms:.2f}% of the {step_ms:.3f} ms "
        f"step, idle {100 - 100 * busy / step_ms:.2f}%")
    # the kernels' time, by the operator that launched them
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in ops)
    log(f"[{tag}] device time by operator: " + ", ".join(
        f"{e.key} {e.self_device_time_total / 5e3:.4f} ms "
        f"({100 * e.self_device_time_total / total:.1f}%)" for e in ops[:10]))


def train(cfg, ds, dev, tag="4"):
    """Phase 4: one path of the port. Returns (model, opt, initial state,
    trained state, {kernel: launches during training})."""
    model = make_model(cfg, ds)
    opt = AdaGrad(lr=cfg.lr)
    step = make_step(cfg, model, opt, make_sampler(cfg, ds, dev))
    state0 = init_state(model, opt, torch.Generator(device=dev).manual_seed(cfg.seed))
    xs = torch.as_tensor(ds.train, dtype=torch.int64, device=dev)
    n = xs.shape[0]
    b = _batch_size(cfg, n)
    # a few steps over the first full batches of one shuffle
    perm = torch.randperm(n, generator=state0.generator, device=dev)
    batches = xs[perm[: max(cfg.steps, 5) * b]].reshape(-1, b, 3)
    mask = torch.ones(b, device=dev)
    if cfg.steps == 0:
        epoch = make_epoch_fn(step, n, cfg.nbatches)
        runs, steps, triples = [epoch] * cfg.epochs, cfg.nbatches, n
    else:
        def some_steps(state, xs):
            ms = []
            for i in range(cfg.steps):
                state, m = step(state, batches[i], mask)
                ms.append(m)
            return state, SimpleNamespace(
                loss=torch.stack([m.loss for m in ms]),
                nviolations=torch.stack([m.nviolations for m in ms]))

        runs, steps, triples = [some_steps], cfg.steps, cfg.steps * b
    # bench.py's work units: 2 scored triples per margin-ranked pair; a
    # pointwise step scores each positive and each negative once
    per = 2 * pairs_per_positive(cfg) if cfg.loss == "pairwise" else 1 + pairs_per_positive(cfg)
    scored = per * triples
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = state0
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
    cuda_segment.vector_launches = 0
    for e, run in enumerate(runs):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = run(state, xs)
        _sync(dev)
        dt = time.perf_counter() - t0
        check(bool(torch.isfinite(m.loss).all()), f"{cfg.model} finite losses, run {e}")
        log(f"[{tag}] {cfg.model} {cfg.loss} {cfg.sampler} run {e} ({steps} steps): "
            f"violations {int(m.nviolations.sum())}  loss {float(m.loss.sum()):.6e}  "
            f"{dt:.3f} s  step {1e3 * dt / steps:.3f} ms  "
            f"{scored / dt:.6e} scored triples/s")
    launches = {name: mod.launches for name, (mod, _, _) in KERNELS.items()}
    launches[VECTOR] = cuda_segment.vector_launches
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
    if cfg.profile and dev.type == "cuda":
        profile(step, state, batches, mask, 1e3 * dt / steps, tag)
    return model, opt, state0, state, launches


def expected_launches(cfg) -> dict:
    """Per step: the row params of TransE, HolE and ER-MLP (E and R) share
    one segment_sum, ER-MLP's dense W and C take no scatter; RESCAL's
    shared-pool path runs one segment_outer_sum (W) and two segment_sum (E
    with its count channel, W's counts). Every gradient scatter (the one
    with the count channel, padded to a multiple of 4 columns) takes K1's
    16-byte path; W's counts (D = 1) the scalar one."""
    steps = cfg.steps or cfg.epochs * cfg.nbatches
    if cfg.model == "rescal":
        return {"segment_sum": 2 * steps, "segment_outer_sum": steps, VECTOR: steps}
    return {"segment_sum": steps, "segment_outer_sum": 0, VECTOR: steps}


class FixedPool:
    """A `pool`-protocol sampler that always hands out the same ids."""

    def __init__(self, ids, modes=(0, 1)):
        self.ids, self.modes = ids, modes

    def pool(self, generator, pos, mask):
        return self.ids.to(pos.device)


class FixedCorruptions:
    """A `corruptions`-protocol sampler that always hands out the same
    corruptions."""

    def __init__(self, corruptions):
        self.corr = corruptions

    def corruptions(self, generator, pos, mask):
        return [(m, r.to(pos.device), v.to(pos.device)) for m, r, v in self.corr]


def _state_on(state: TrainState, dev) -> TrainState:
    return TrainState(
        params={k: v.to(dev) for k, v in state.params.items()},
        opt_state={k: {s: v.to(dev) for s, v in slots.items()}
                   for k, slots in state.opt_state.items()},
        generator=torch.Generator(device=dev),
        step=state.step,
    )


@torch.no_grad()
def near_margin(cfg, model, params, batch, sampler) -> int:
    """Pairs whose transformed scores lie within 1e-4 of the margin test's
    edge: the ones fp32 rounding may flip between two devices."""
    af = ACTIVATIONS[model.pairwise_af][0]
    r = model.gather_rows(params, *(batch[:, i] for i in range(3)))
    dense = model.dense_params(params)
    gp = af(model.score_from_rows(r, dense))
    if isinstance(sampler, FixedPool):
        pool = params["E"][sampler.ids.to(batch.device)]
        gns = [af(model.score_pool(r, pool, dense, mode)) for mode in (0, 1)]
        gp = gp[:, None]
    else:
        gns = [af(model.score_from_rows({**r, "es" if mode == 0 else "eo":
                                         params["E"][repl.to(batch.device)]}, dense))
               for mode, repl, _ in sampler.corr]
    return sum(int(((gn + cfg.margin - gp).abs() < 1e-4).sum()) for gn in gns)


def step_against_cpu(cfg, ds, model, opt, start, dev, tag="5", unique_too=False):
    """Phase 5: one step from the same state, batch and negatives, on the
    card (kernels) and on the CPU (plain versions). At the initial params
    every pair violates by a wide margin, so the violation counts must
    agree. `unique_too`: also the card's `unique` aggregation (no kernel)
    against its `dense_pallas`."""
    gen = torch.Generator().manual_seed(cfg.seed + 2)
    b = _batch_size(cfg, ds.train.shape[0])
    rows = torch.randperm(ds.train.shape[0], generator=gen)[:b]
    batch = torch.as_tensor(ds.train, dtype=torch.int64)[rows]
    mask = torch.ones(b)
    if cfg.sampler == "shared":
        sampler = FixedPool(torch.randint(0, ds.n_entities, (cfg.k,), generator=gen))
    else:
        cpu = torch.device("cpu")
        sampler = FixedCorruptions(
            make_sampler(cfg, ds, cpu).corruptions(gen, batch, mask))
    step = make_step(cfg, model, opt, sampler)
    t0 = time.perf_counter()
    dev_state, dev_m = step(_state_on(start, dev), batch.to(dev), mask.to(dev))
    _sync(dev)
    t1 = time.perf_counter()
    cpu_state, cpu_m = step(_state_on(start, torch.device("cpu")), batch, mask)
    t2 = time.perf_counter()
    nv_dev, nv_cpu = int(dev_m.nviolations), int(cpu_m.nviolations)
    near = near_margin(cfg, model, {k: v.to(dev) for k, v in start.params.items()},
                       batch.to(dev), sampler)
    log(f"[{tag}] {cfg.model}: violations card {nv_dev} cpu {nv_cpu}; pairs "
        f"within 1e-4 of the margin {near}; step {t1 - t0:.3f} s card, "
        f"{t2 - t1:.3f} s cpu")
    others = [("cpu", cpu_state, nv_cpu)]
    if unique_too:
        u_state, u_m = make_step(cfg, model, opt, sampler, aggregate="unique")(
            _state_on(start, dev), batch.to(dev), mask.to(dev))
        others.append(("card unique", u_state, int(u_m.nviolations)))
    for what, other, nv in others:
        for name in start.params:
            want = other.params[name].to(dev)
            diff = float((dev_state.params[name] - want).abs().max())
            other_p2 = other.opt_state[name]["p2"].to(dev)
            dp2 = float((dev_state.opt_state[name]["p2"] - other_p2).abs().max())
            p2_max = float(other_p2.max())
            moved = float((want - start.params[name].to(dev)).abs().max())
            log(f"[{tag}] against {what}: max|d{name}| {diff:.3e}  max|d p2[{name}]| "
                f"{dp2:.3e} (max p2 {p2_max:.3e}; max update of {name} {moved:.3e})")
            # p2 sums squares and grows with training: held relative to its size
            check(diff <= STEP_TOL and dp2 <= STEP_TOL * max(1.0, p2_max),
                  f"one {cfg.model} step card vs {what}: {name} within {STEP_TOL}")
        check(nv_dev == nv, f"one {cfg.model} step card vs {what}: same violation count")


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


def main(argv) -> int:
    if argv not in ([], ["--kernel-times"]):
        print("usage: python3 chip_smoke.py [--kernel-times]", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = environment()
    dev = torch.device("cuda", 0)
    build()
    t_build = time.perf_counter()
    verify = not argv
    checks = {"segment_sum": segment_sum_checks(dev, verify),
              "segment_outer_sum": segment_outer_sum_checks(dev, verify)}
    t_kernels = time.perf_counter()
    if not verify:  # phase 3's timings alone: no check, no result line
        log(json.dumps({name: shapes for name, (_, shapes) in checks.items()}))
        log(smi)
        return 0
    graphs = {name: synthetic_kg(g.n_entities, g.n_relations, g.n_train,
                                 n_test=g.n_test, seed=g.seed, clustered=False)
              for name, g in (("fb15k", DATA), ("wn18", WN18))}
    launches = dict.fromkeys([*KERNELS, VECTOR], 0)
    trained = {}
    for cfg, tag in PATHS:
        *run, counts = train(cfg, graphs[cfg.data], dev, tag)
        check(counts == expected_launches(cfg),
              f"{cfg.model} {cfg.loss} {cfg.sampler}: launches {counts}, "
              f"want {expected_launches(cfg)}")
        for name in launches:
            launches[name] += counts[name]
        trained.setdefault(cfg.model, (cfg, *run))
    t_train = time.perf_counter()
    for (cfg, model, opt, state0, state), tag in zip(trained.values(),
                                                     ("", "b", "c", "d")):
        start = state0._replace(opt_state=state.opt_state)
        ds = graphs[cfg.data]
        step_against_cpu(cfg, ds, model, opt, start, dev, "5" + tag,
                         unique_too=cfg.model == "hole")
        evaluate(ds, model, state, dev, "6" + tag)
    t_end = time.perf_counter()
    log(f"[time] phases 1-2 {t_build - t0:.1f} s, 3 {t_kernels - t_build:.1f} s, "
        f"4 {t_train - t_kernels:.1f} s (graphs included), 5-6 {t_end - t_train:.1f} s")
    # each kernel at the TransE or RESCAL slice's shape, its other timed
    # shapes under "shapes"
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": checks[name][0],
        **{key: checks[name][1][0][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bound_share")},
        "shapes": checks[name][1],
    } for name, (_, source, replaces) in KERNELS.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
