"""RESCAL — bilinear tensor factorization (Nickel et al. 2011).

score = e_s^T W_p e_o with W a (n_r, d, d) parameter and `rparam` L2
regularization on touched rows of E and W. The pairwise margin test runs on
raw scores.

The bilinear forms are batched matmuls, and the pool and all-entity sweeps
contract the triple down to a (B, d) query (e_s W_p for an object sweep,
W_p e_o for a subject sweep) and take one matmul against the entity rows.
Products accumulate in `acc_dtype` (at least fp32); TF32 must be off on
the card for fp32 parity.

Shared-pool training does not differentiate these functions: the W
gradient of a pool pair is a rank-1 outer product, so
`training.pairwise_grads_shared_bilinear` derives it by hand and keeps it
factored (`factored_pool_grads`) for the outer-product scatter
(`ops/cuda_outer.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from skge_torch.models.base import INITIALIZERS, KGEModel, Params, acc_dtype


def _acc(*xs: torch.Tensor):
    acc = acc_dtype(xs[0])
    return tuple(x.to(acc) for x in xs)


@dataclass(frozen=True)
class RESCAL(KGEModel):
    rparam: float = 0.0

    name = "rescal"
    reg_row_params = ("E", "W")
    factored_pool_grads = True

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("wp", "W", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        return {
            "E": init(generator, (self.n_entities, self.ncomp), self.tdtype),
            "W": init(generator, (self.n_relations, self.ncomp, self.ncomp),
                      self.tdtype),
        }

    def score_from_rows(self, rows, dense):
        es, wp, eo = _acc(rows["es"], rows["wp"], rows["eo"])
        return torch.einsum("bi,bij,bj->b", es, wp, eo)

    def score_pool(self, rows, pool_rows, dense, mode):
        """(B, K) pool scores: the (B, d) query (es^T W_p for mode 1, W_p e_o
        for mode 0), then one matmul against the pool."""
        if mode == 1:
            q = torch.einsum("bi,bij->bj", *_acc(rows["es"], rows["wp"]))
        else:
            q = torch.einsum("bij,bj->bi", *_acc(rows["wp"], rows["eo"]))
        return self.mxu(q, pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        E = params["E"]
        q = torch.einsum("bi,bij->bj", *_acc(E[s], params["W"][p]))
        return self.mxu(q, E.T)

    def score_all_s(self, params: Params, o, p):
        E = params["E"]
        q = torch.einsum("bij,bj->bi", *_acc(params["W"][p], E[o]))
        return self.mxu(q, E.T)
