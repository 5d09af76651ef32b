"""The traced span of a `--trace 1` run: `torch.profiler` over a fixed
stretch of work right after the window, read back from its Chrome trace.
Part of the yardstick.

- busy: the union of the intervals in which a kernel, copy or fill ran on
  the card (overlapping streams counted once);
- the longest idle stretches between them, summed by what the host was
  doing: the innermost host operation running at the gap's midpoint;
- device time by kernel name;
- K1's calls: while the span runs, the program's `segment_sum` is
  wrapped to keep each call's ids and width; after the span, each call's
  (T, D, U), U the distinct in-range rows it touched, which its bytes
  follow from.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 160


@dataclass
class Span:
    """What a traced span read; the drivers add the work it held."""

    card: str = ""  # the device's name, which the peaks are looked up by
    kind: str = ""
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: list = field(default_factory=list)  # (name, start us, end us)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    k1_calls: list = field(default_factory=list)  # (T, D, U)
    model_flops: float = 0.0
    window: dict = field(default_factory=dict)  # the run's window figures


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    """A kernel or operation name cut to NAME_CHARS, the anonymous
    namespaces taken out (the functor's name follows them)."""
    return name.replace("(anonymous namespace)::", "")[:NAME_CHARS]


def read_trace(events: list, span: Span) -> None:
    """Fill `span`'s busy time, kernels, device ops and idle gaps from
    Chrome-trace events."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    span.kernels = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in dev]
    merged = _union([(a, b) for _, a, b in span.kernels])
    span.busy_s = sum(b - a for a, b in merged) * 1e-6
    by_name = defaultdict(float)
    for name, a, b in span.kernels:
        by_name[_short(name)] += (b - a) * 1e-6
    span.device_ops = sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10]

    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    if host:
        counts = defaultdict(int)
        for e in host:
            counts[e.get("tid")] += 1
        main = max(counts, key=counts.get)
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                      for e in host if e.get("tid") == main)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + start)
        name = "host outside any operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[_short(name)] += (start - end) * 1e-6
    span.idle_gaps = sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:10]


@contextlib.contextmanager
def k1_recorder(calls: list):
    """Record (T, D, U) of each `segment_sum` call while the block runs:
    every module of the program that holds the function gets a wrapper,
    which keeps the call's ids; U is counted when the block has ended."""
    from skge_torch.ops import cuda_segment

    orig = cuda_segment.segment_sum
    held_calls = []

    def recorded(indices, grads, num_rows):
        held_calls.append((indices, int(grads.shape[1]), int(num_rows)))
        return orig(indices, grads, num_rows)

    held = [m for name, m in list(sys.modules.items())
            if name.split(".")[0] == "skge_torch" and getattr(m, "segment_sum", None) is orig]
    for m in held:
        m.segment_sum = recorded
    try:
        yield
    finally:
        for m in held:
            m.segment_sum = orig
    for ids, d, r in held_calls:
        touched = torch.unique(ids[(ids >= 0) & (ids < r)]).numel()
        calls.append((int(ids.shape[0]), d, int(touched)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def traced(device: torch.device, kind: str, label: str):
    """Profile the block; yields the `Span`, filled when the block ends.
    The block's host time runs from a synchronize to a synchronize."""
    span = Span(kind=kind)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with k1_recorder(span.k1_calls), torch.profiler.profile(activities=acts) as prof:
        _sync(device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(label):
            yield span
        _sync(device)
        span.window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    read_trace(trace.get("traceEvents", []), span)


def power_limit_w() -> Optional[float]:
    """The card's power limit from `nvidia-smi`, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None
