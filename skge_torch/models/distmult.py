"""DistMult — diagonal bilinear factorization (Yang et al., ICLR 2015).

score = sum(E[s] * R[p] * E[o]): RESCAL with W_p restricted to a
diagonal. `rparam` (L2) and `n3` (nuclear 3-norm) regularize the touched
rows of E and R. The pool and all-entity sweeps contract the fixed roles
to a (B, d) query q = e * r (the score is symmetric in s and o) and take
one matmul against the entity rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from skge_torch.models.base import INITIALIZERS, KGEModel, Params


@dataclass(frozen=True)
class DistMult(KGEModel):
    rparam: float = 0.0
    n3: float = 0.0

    name = "distmult"
    reg_row_params = ("E", "R")

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        return {
            "E": init(generator, (self.n_entities, self.ncomp), self.tdtype),
            "R": init(generator, (self.n_relations, self.ncomp), self.tdtype),
        }

    def score_from_rows(self, rows, dense):
        return torch.sum(rows["es"] * rows["rp"] * rows["eo"], dim=-1)

    def score_pool(self, rows, pool_rows, dense, mode):
        q = (rows["es"] if mode == 1 else rows["eo"]) * rows["rp"]
        return self.mxu(q, pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        return self.mxu(params["E"][s] * params["R"][p], params["E"].T)

    def score_all_s(self, params: Params, o, p):
        return self.mxu(params["E"][o] * params["R"][p], params["E"].T)
