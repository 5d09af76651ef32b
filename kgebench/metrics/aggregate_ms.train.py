"""The aggregation's stream time a training step, in ms: the program's
span `skge_torch.train.aggregate` (the occurrences grouped and averaged
by row: K1, its fill and the divide) over the calls of
`skge_torch.train.step`. Nothing off CUDA."""

from kgebench.spans import per_call_ms


def read(span):
    return per_call_ms(span, "train", "skge_torch.train.aggregate", "skge_torch.train.step", "stream")
