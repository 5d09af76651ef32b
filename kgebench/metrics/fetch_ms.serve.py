"""The host's fetch of a serving batch's answers, in ms: the host time of
the program's span `skge_torch.serve.fetch` (its wait on the card, then
the copies from device to host) over the calls of
`skge_torch.serve.batch`."""

from kgebench.spans import per_call_ms


def read(span):
    return per_call_ms(span, "serve", "skge_torch.serve.fetch", "skge_torch.serve.batch", "host")
