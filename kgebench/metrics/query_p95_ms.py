"""The 95th percentile of one batch's latency, host to host, over every
batch of the run's window (not of the traced span), in ms."""


def read(span):
    return span.window.get("query_p95_ms") if span.kind == "serve" else None
