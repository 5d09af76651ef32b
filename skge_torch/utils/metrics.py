"""Per-epoch metrics records, a wall-clock timer, a profiler context, and
named spans inside the program.

Every epoch of the `Trainer` logs one record (epoch, loss, violations, wall
time, triples/s) to an in-memory history and, with a path, to a JSONL
file. `profile_trace` records a `torch.profiler` trace (host and card) into
a directory.

`span(name)` marks a stretch of the program (the training step and its
sampler, scoring, aggregation and optimizer; a serving batch and its
filter, sweep, top-k and fetch). Spans record only while a
`torch.profiler` profile records: then each is a `user_annotation` in the
profile's trace, on the kernels' clock, and adds its calls, host seconds
and (on the card) the stream's seconds between two CUDA events to a store
that `span_totals()` reads. Otherwise `span` returns a shared null context:
no annotation, no event, no clock read. The store holds the latest
profiled stretch: the first span that finds the profiler on after one that
found it off empties it (two profiles with no span between them make one
stretch).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass
class MetricsLogger:
    jsonl_path: Optional[str] = None
    history: List[Dict[str, Any]] = field(default_factory=list)

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record, time=time.time())
        self.history.append(record)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def last(self) -> Dict[str, Any]:
        return self.history[-1] if self.history else {}


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """`torch.profiler` over the block, the host and (when there is one)
    the card, written as `logdir/trace.json` (Chrome trace format); no-op
    when logdir is None."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock seconds since construction or the last `reset`."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def reset(self) -> float:
        dt = self.elapsed()
        self.t0 = time.perf_counter()
        return dt


@dataclass
class _SpanRecord:
    calls: int = 0
    host_s: float = 0.0
    stream_s: Optional[float] = None
    pending: list = field(default_factory=list)  # (start, end) CUDA events


_NULL_SPAN = contextlib.nullcontext()
_spans: Dict[str, _SpanRecord] = {}
_profiled = False  # whether the latest span found the profiler on


def span(name: str):
    """A context that records the block as the span `name` while a
    `torch.profiler` profile records, and does nothing otherwise."""
    global _profiled
    if not _autograd_profiler._is_profiler_enabled:
        _profiled = False
        return _NULL_SPAN
    if not _profiled:
        _spans.clear()
        _profiled = True
    return _recorded(name)


@contextlib.contextmanager
def _recorded(name: str):
    rec = _spans.setdefault(name, _SpanRecord())
    with torch.profiler.record_function(name):
        start = None
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        yield
        rec.host_s += time.perf_counter() - t0
        rec.calls += 1
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.pending.append((start, end))


def span_totals() -> Dict[str, Tuple[int, float, Optional[float]]]:
    """{name: (calls, host_s, stream_s)} of the latest profiled stretch.
    `stream_s` is the current stream's seconds between each call's two
    events, summed (None off CUDA): the device's time where the card ran
    behind the host, and any wait of the card for the host inside the
    span besides."""
    if any(rec.pending for rec in _spans.values()):
        torch.cuda.synchronize()
    for rec in _spans.values():
        if rec.pending:
            rec.stream_s = (rec.stream_s or 0.0) + 1e-3 * sum(
                a.elapsed_time(b) for a, b in rec.pending)
            rec.pending.clear()
    return {name: (rec.calls, rec.host_s, rec.stream_s) for name, rec in _spans.items()}
