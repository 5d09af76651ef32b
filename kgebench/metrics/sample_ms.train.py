"""The sampler's stream time a training step, in ms: the program's span
`skge_torch.train.sample` (the pool's or the corruptions' draw) over the
calls of `skge_torch.train.step`. Nothing off CUDA."""

from kgebench.spans import per_call_ms


def read(span):
    return per_call_ms(span, "train", "skge_torch.train.sample", "skge_torch.train.step", "stream")
