"""Per-epoch metrics records, a wall-clock timer, and a profiler context.

Every epoch of the `Trainer` logs one record (epoch, loss, violations, wall
time, triples/s) to an in-memory history and, with a path, to a JSONL
file. `profile_trace` records a `torch.profiler` trace (host and card) into
a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


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
