"""TuckER — Tucker-decomposition bilinear model (Balazevic et al., EMNLP
2019).

    score = e_s^T ( W x_1 r_p ) e_o      with  M_p = sum_k r_pk W[k]

A shared core W (rcomp, ncomp, ncomp) mixes each relation's embedding into
a full bilinear form. W is a dense param (like ER-MLP's W and C: the
batch's mean gradient through `Optimizer.apply_full`); `rparam` and `n3`
regularize the touched rows of E and R.

The form contracts core first: one (rows, rcomp) x (rcomp, ncomp^2) matmul
builds every M_p, over the relation rows flattened across any leading
axes, which are restored after. The sweeps contract the fixed side into a
(B, d) query and take one matmul against the entity rows. The (B, d, d)
M is the dominant memory term, B * ncomp^2 * 4 bytes in fp32 (435 MB at
B = 4,832, ncomp = 150). Rows use the model's `init`; the core uses nunif
over its (rcomp, ncomp^2) flattening.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from skge_torch.models.base import INITIALIZERS, KGEModel, Params, acc_dtype


@dataclass(frozen=True)
class TuckER(KGEModel):
    rcomp: int = 0  # relation dim; 0 = ncomp
    rparam: float = 0.0
    n3: float = 0.0

    name = "tucker"
    dense_param_names = ("W",)
    reg_row_params = ("E", "R")

    @property
    def rdim(self) -> int:
        return self.rcomp or self.ncomp

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        d = self.ncomp
        return {
            "E": init(generator, (self.n_entities, d), self.tdtype),
            "R": init(generator, (self.n_relations, self.rdim), self.tdtype),
            "W": INITIALIZERS["nunif"](generator, (self.rdim, d * d),
                                       self.tdtype).reshape(self.rdim, d, d),
        }

    def _mix(self, rp, core):
        """(..., d, d) bilinear forms M_p = sum_k r_pk W[k], for relation
        rows with any leading axes."""
        d = self.ncomp
        m = self.mxu(rp.reshape(-1, self.rdim), core.reshape(self.rdim, d * d))
        return m.reshape(*rp.shape[:-1], d, d)

    def score_from_rows(self, rows, dense):
        m = self._mix(rows["rp"], dense["W"])
        acc = acc_dtype(rows["es"])
        q = torch.einsum("...i,...ij->...j", rows["es"].to(acc), m.to(acc))
        return torch.sum(q * rows["eo"].to(acc), dim=-1).to(rows["es"].dtype)

    def _query(self, rows, dense, mode):
        """Contract the fixed side into a (B, d) query."""
        m = self._mix(rows["rp"], dense["W"])
        acc = acc_dtype(m)
        if mode == 1:
            q = torch.einsum("...i,...ij->...j", rows["es"].to(acc), m.to(acc))
        else:
            q = torch.einsum("...ij,...j->...i", m.to(acc), rows["eo"].to(acc))
        return q.to(m.dtype)

    def score_pool(self, rows, pool_rows, dense, mode):
        return self.mxu(self._query(rows, dense, mode), pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        rows = {"es": params["E"][s], "rp": params["R"][p]}
        return self.mxu(self._query(rows, params, 1), params["E"].T)

    def score_all_s(self, params: Params, o, p):
        rows = {"eo": params["E"][o], "rp": params["R"][p]}
        return self.mxu(self._query(rows, params, 0), params["E"].T)
