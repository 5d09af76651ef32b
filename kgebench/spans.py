"""The program's own spans (`skge_torch.utils.metrics.span_totals`) as
per-layer metrics: one span's seconds over the calls of the span that
holds it, in ms.

The traced span is the only stretch of a run that the profiler records,
so the program's store holds exactly its calls. A program without spans
(an older commit) or a span with no record gives nothing, and so does a
stream time off CUDA.
"""

from __future__ import annotations

from typing import Optional

FIELD = {"host": 1, "stream": 2}  # in (calls, host_s, stream_s)


def per_call_ms(span, kind: str, name: str, per: str, clock: str) -> Optional[float]:
    """Milliseconds of `clock` ('host' or 'stream') in the program's span
    `name`, over the calls of its span `per`, in a traced span of `kind`."""
    if span.kind != kind:
        return None
    try:
        from skge_torch.utils.metrics import span_totals
    except ImportError:
        return None
    totals = span_totals()
    if name not in totals or per not in totals:
        return None
    seconds = totals[name][FIELD[clock]]
    calls = totals[per][0]
    if seconds is None or calls == 0:
        return None
    return 1e3 * seconds / calls
