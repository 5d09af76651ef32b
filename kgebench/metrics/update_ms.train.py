"""The optimizer's stream time a training step, in ms: the program's span
`skge_torch.train.update` (the regularizers, the AdaGrad update of the
touched rows and the post-constraints, every table) over the calls of
`skge_torch.train.step`. Nothing off CUDA."""

from kgebench.spans import per_call_ms


def read(span):
    return per_call_ms(span, "train", "skge_torch.train.update", "skge_torch.train.step", "stream")
