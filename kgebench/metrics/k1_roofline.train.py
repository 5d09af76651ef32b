"""K1's share of its roofline in the traced training epoch, in %: the
bytes its calls need (`counts.k1_bytes` of each recorded call's (T, D,
U)) at the card's HBM rate, over the device time of the kernels of
`csrc/segment_sum.cu` (names holding `segment_sum_`). Nothing when the
epoch made no call or ran no such kernel, or the card has no peaks."""

from kgebench import counts


def read(span):
    peaks = counts.peaks(span.card)
    busy = sum(b - a for name, a, b in span.kernels
               if "segment_sum_" in name) * 1e-6
    if span.kind != "train" or peaks is None or not span.k1_calls or busy <= 0:
        return None
    nbytes = sum(counts.k1_bytes(t, d, u) for t, d, u in span.k1_calls)
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / busy
