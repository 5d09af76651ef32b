"""Checkpoints, metrics and profiling of the port."""

from skge_torch.utils.checkpoint import (AsyncCheckpointer, load_checkpoint,
                                         load_sharded_checkpoint, save_checkpoint,
                                         save_sharded_checkpoint)
from skge_torch.utils.debug import assert_finite_state, checked_step, validate_triples
from skge_torch.utils.metrics import MetricsLogger, StepTimer, profile_trace, span, span_totals

__all__ = [
    "AsyncCheckpointer",
    "MetricsLogger",
    "StepTimer",
    "assert_finite_state",
    "checked_step",
    "load_checkpoint",
    "load_sharded_checkpoint",
    "profile_trace",
    "save_checkpoint",
    "save_sharded_checkpoint",
    "span",
    "span_totals",
    "validate_triples",
]
