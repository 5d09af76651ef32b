"""The card's idle share of the traced training epoch: 1 - (union of the
kernel, copy and fill intervals) / (the epoch's host time), in %."""


def read(span):
    if span.kind != "train" or span.busy_s <= 0 or span.window_s <= 0:
        return None
    return 100.0 * (1.0 - span.busy_s / span.window_s)
