"""The top-k's stream time a serving batch, in ms: the program's span
`skge_torch.serve.topk` (the filter mask, the top k under the lower-id
rule, the invalid slots) over the calls of `skge_torch.serve.batch`.
Nothing off CUDA."""

from kgebench.spans import per_call_ms


def read(span):
    return per_call_ms(span, "serve", "skge_torch.serve.topk", "skge_torch.serve.batch", "stream")
