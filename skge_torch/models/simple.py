"""SimplE — CP factorization with inverse relations (Kazemi & Poole,
NeurIPS 2018).

    score(s, o, p) = 0.5 * ( <h_s, r_p, t_o> + <h_o, r~_p, t_s> )

Each entity has a head and a tail embedding, stored as one (n_e, 2d) row
[head | tail]; each relation a forward and an inverse vector, one (n_r, 2d)
row [forward | inverse]. Both terms are linear in a candidate's halves, so
a sweep is one (B, 2d) query and one matmul:

    mode 1 (object): q = 0.5 * [ t_s * r~ | h_s * r ]
    mode 0 (subject): q = 0.5 * [ r * t_o | r~ * h_o ]
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from skge_torch.models.base import INITIALIZERS, KGEModel, Params


@dataclass(frozen=True)
class SimplE(KGEModel):
    """`ncomp` is the CP rank; entity and relation rows are 2 * ncomp wide."""

    rparam: float = 0.0
    n3: float = 0.0

    name = "simple"
    reg_row_params = ("E", "R")

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        return {
            "E": init(generator, (self.n_entities, 2 * self.ncomp), self.tdtype),
            "R": init(generator, (self.n_relations, 2 * self.ncomp), self.tdtype),
        }

    @staticmethod
    def _split(x):
        d = x.shape[-1] // 2
        return x[..., :d], x[..., d:]

    def score_from_rows(self, rows, dense):
        hs, ts = self._split(rows["es"])
        ho, to = self._split(rows["eo"])
        r, rinv = self._split(rows["rp"])
        fwd = torch.sum(hs * r * to, dim=-1)
        inv = torch.sum(ho * rinv * ts, dim=-1)
        return 0.5 * (fwd + inv)

    def _query(self, rows, mode):
        """(B, 2d) query whose dot with a candidate's [head | tail] row is
        the triple's score."""
        r, rinv = self._split(rows["rp"])
        if mode == 1:
            hs, ts = self._split(rows["es"])
            return 0.5 * torch.cat([ts * rinv, hs * r], dim=-1)
        ho, to = self._split(rows["eo"])
        return 0.5 * torch.cat([r * to, rinv * ho], dim=-1)

    def score_pool(self, rows, pool_rows, dense, mode):
        return self.mxu(self._query(rows, mode), pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        rows = {"es": params["E"][s], "rp": params["R"][p]}
        return self.mxu(self._query(rows, 1), params["E"].T)

    def score_all_s(self, params: Params, o, p):
        rows = {"eo": params["E"][o], "rp": params["R"][p]}
        return self.mxu(self._query(rows, 0), params["E"].T)
