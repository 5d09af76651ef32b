"""The scoring's stream time a training step, in ms: the program's span
`skge_torch.train.score` (the sweep over the pool or the corruptions, its
backward, the counts and the slot grouping) over the calls of
`skge_torch.train.step`. Nothing off CUDA."""

from kgebench.spans import per_call_ms


def read(span):
    return per_call_ms(span, "train", "skge_torch.train.score", "skge_torch.train.step", "stream")
