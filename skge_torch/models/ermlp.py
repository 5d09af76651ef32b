"""ER-MLP — neural triple scoring (Dong et al. 2014, Knowledge Vault).

score = C . af(W^T [e_s; e_o; r_p]) with W (3d, nhidden), C (nhidden,),
af = sigmoid by default. The dense params W and C take the batch's mean
gradient through `Optimizer.apply_full`; the pairwise margin test runs on
raw scores.

The hidden layer is one (B, 3d) x (3d, nh) matmul. The pool and
all-entity sweeps split W into row blocks (W_s, W_o, W_r): only the
substituted role's pre-activation varies with the candidate, so it is one
matmul over the candidates, and the (B, candidates, nh) hidden layer is a
broadcast add, chunked over 8,192 entities in the all-entity sweep.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from skge_torch.models.base import ACTIVATIONS, INITIALIZERS, KGEModel, Params, mxu_dot

ALL_CHUNK = 8192


@dataclass(frozen=True)
class ERMLP(KGEModel):
    nhidden: int = 10
    af: str = "sigmoid"

    name = "ermlp"
    dense_param_names = ("W", "C")

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        return {
            "E": init(generator, (self.n_entities, self.ncomp), self.tdtype),
            "R": init(generator, (self.n_relations, self.ncomp), self.tdtype),
            "W": init(generator, (3 * self.ncomp, self.nhidden), self.tdtype),
            # 1-D, with the bound of an (nhidden, 1) table
            "C": init(generator, (self.nhidden, 1), self.tdtype)[:, 0],
        }

    def score_from_rows(self, rows, dense):
        f = ACTIVATIONS[self.af][0]
        x = torch.cat(torch.broadcast_tensors(rows["es"], rows["eo"], rows["rp"]),
                      dim=-1)
        h = f(mxu_dot(x, dense["W"]))
        return mxu_dot(h, dense["C"])

    def _blocks(self, W: torch.Tensor):
        d = self.ncomp
        return W[:d], W[d:2 * d], W[2 * d:]

    def score_pool(self, rows, pool_rows, dense, mode):
        """(B, K) pool scores through the concat split x@W = es@W_s +
        eo@W_o + rp@W_r: the fixed roles' pre-activation once per positive,
        the pool's once per pool row, the hidden layer a (B, K, nh)
        broadcast."""
        f = ACTIVATIONS[self.af][0]
        Ws, Wo, Wr = self._blocks(dense["W"])
        if mode == 1:
            fixed = mxu_dot(rows["es"], Ws) + mxu_dot(rows["rp"], Wr)
            ppre = mxu_dot(pool_rows, Wo)
        else:
            fixed = mxu_dot(rows["eo"], Wo) + mxu_dot(rows["rp"], Wr)
            ppre = mxu_dot(pool_rows, Ws)
        h = f(fixed[:, None, :] + ppre[None, :, :])
        return mxu_dot(h, dense["C"])

    def _score_all(self, params: Params, fixed: torch.Tensor, Went: torch.Tensor):
        """fixed: (B, nh) pre-activation of the fixed roles; Went: the W
        block of the swept role."""
        f = ACTIVATIONS[self.af][0]
        epre = mxu_dot(params["E"], Went)  # (n_e, nh), once
        return torch.cat(
            [mxu_dot(f(fixed[:, None, :] + blk[None, :, :]), params["C"])
             for blk in torch.split(epre, ALL_CHUNK)],
            dim=1,
        )

    def score_all_o(self, params: Params, s, p):
        Ws, Wo, Wr = self._blocks(params["W"])
        fixed = mxu_dot(params["E"][s], Ws) + mxu_dot(params["R"][p], Wr)
        return self._score_all(params, fixed, Wo)

    def score_all_s(self, params: Params, o, p):
        Ws, Wo, Wr = self._blocks(params["W"])
        fixed = mxu_dot(params["E"][o], Wo) + mxu_dot(params["R"][p], Wr)
        return self._score_all(params, fixed, Ws)
