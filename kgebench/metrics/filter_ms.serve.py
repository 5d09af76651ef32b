"""The host's filter build a serving batch, in ms: the host time of the
program's span `skge_torch.serve.filter` (the known answers of the
batch's queries, in Python) over the calls of `skge_torch.serve.batch`."""

from kgebench.spans import per_call_ms


def read(span):
    return per_call_ms(span, "serve", "skge_torch.serve.filter", "skge_torch.serve.batch", "host")
