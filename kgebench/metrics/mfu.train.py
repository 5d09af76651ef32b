"""The traced training epoch's model operations (`counts.train_flops`)
over its host time, as a share of the card's fp32 peak, in %."""

from kgebench import counts


def read(span):
    peaks = counts.peaks(span.card)
    if span.kind != "train" or peaks is None or span.window_s <= 0 or span.busy_s <= 0:
        return None
    return 100.0 * span.model_flops / span.window_s / peaks["fp32_flops_per_s"]
