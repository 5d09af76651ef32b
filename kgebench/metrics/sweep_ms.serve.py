"""The scoring's stream time a serving batch, in ms: the program's span
`skge_torch.serve.score` (the query rows and the sweep over every
entity) over the calls of `skge_torch.serve.batch`. Nothing off CUDA."""

from kgebench.spans import per_call_ms


def read(span):
    return per_call_ms(span, "serve", "skge_torch.serve.score", "skge_torch.serve.batch", "stream")
