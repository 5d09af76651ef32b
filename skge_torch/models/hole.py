"""HolE — holographic embeddings (Nickel, Rosasco, Poggio, AAAI 2016).

score = sum(R[p] * ccorr(E[s], E[o])). Pairwise training applies `af`
(sigmoid by default) to the scores BEFORE the margin test; `rparam` L2
regularization on touched rows of E and R.

ccorr runs through `torch.fft` (`ops/circulant.py`). The pool and
all-entity sweeps use the adjoint identities

    score(s, ., p) = E @ cconv(e_s, r_p)      (object side)
    score(., o, p) = E @ ccorr(r_p, e_o)      (subject side)

so each is one (B, d) query and one matmul against the entity rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from skge_torch.models.base import INITIALIZERS, KGEModel, Params
from skge_torch.ops.circulant import cconv, ccorr


@dataclass(frozen=True)
class HolE(KGEModel):
    rparam: float = 0.0
    af: str = "sigmoid"

    name = "hole"
    reg_row_params = ("E", "R")

    @property
    def pairwise_af(self) -> str:
        return self.af

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        return {
            "E": init(generator, (self.n_entities, self.ncomp), self.tdtype),
            "R": init(generator, (self.n_relations, self.ncomp), self.tdtype),
        }

    def score_from_rows(self, rows, dense):
        return torch.sum(rows["rp"] * ccorr(rows["es"], rows["eo"]), dim=-1)

    def score_pool(self, rows, pool_rows, dense, mode):
        """(B, K) pool scores through the adjoint identities: mode 1,
        e_k . cconv(es, rp); mode 0, e_k . ccorr(rp, eo)."""
        q = (cconv(rows["es"], rows["rp"]) if mode == 1
             else ccorr(rows["rp"], rows["eo"]))
        return self.mxu(q, pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        q = cconv(params["E"][s], params["R"][p])  # (B, d)
        return self.mxu(q, params["E"].T)

    def score_all_s(self, params: Params, o, p):
        q = ccorr(params["R"][p], params["E"][o])  # (B, d)
        return self.mxu(q, params["E"].T)
