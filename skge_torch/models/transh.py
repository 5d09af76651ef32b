"""TransH — translation on relation-specific hyperplanes (Wang et al.,
AAAI 2014).

With w_p the relation's unit normal and proj(e) = e - (w_p . e) w_p:

    score = -|| proj(e_s) + r_p - proj(e_o) ||^2

The normal is normalized inside scoring, w / max(|w|, 1e-12), the floor
through `torch.maximum`, whose gradient at a tie is split as
`jnp.maximum`'s is. Entity rows keep the `normless1` constraint. With q
the projected query and |w| = 1 the sweeps expand the square,

    ||q - proj(e)||^2 = |q|^2 - 2 (q.e - (w.e)(q.w)) + |e|^2 - (w.e)^2

two matmuls against the candidates (q.E^T and w.E^T) and rank-1 terms.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from skge_torch.models.base import INITIALIZERS, KGEModel, Params

_EPS = 1e-12


def _unit(w: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(w * w, dim=-1, keepdim=True))
    return w / torch.maximum(n, n.new_full((), _EPS))  # on the card: no host copy


def _proj(e: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return e - torch.sum(e * w, dim=-1, keepdim=True) * w


@dataclass(frozen=True)
class TransH(KGEModel):
    name = "transh"
    post_constraints = {"E": "normless1"}

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"),
                ("rp", "R", "p"), ("wp", "W", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        return {
            "E": init(generator, (self.n_entities, self.ncomp), self.tdtype),
            "R": init(generator, (self.n_relations, self.ncomp), self.tdtype),
            "W": init(generator, (self.n_relations, self.ncomp), self.tdtype),
        }

    def score_from_rows(self, rows, dense):
        w = _unit(rows["wp"])
        d = _proj(rows["es"], w) + rows["rp"] - _proj(rows["eo"], w)
        return -torch.sum(d * d, dim=-1)

    def _sweep(self, q, w, cand):
        """-||q - proj(e)||^2 for every candidate row e (mode 0 negates q:
        ||proj(e) + v||^2 = ||(-v) - proj(e)||^2)."""
        qe = self.mxu(q, cand.T)                          # (B, N)
        we = self.mxu(w, cand.T)                          # (B, N)
        qw = torch.sum(q * w, dim=-1, keepdim=True)       # (B, 1)
        qn = torch.sum(q * q, dim=-1, keepdim=True)
        en = torch.sum(cand * cand, dim=-1)[None, :]
        return -(qn - 2.0 * (qe - we * qw) + en - we * we)

    def score_pool(self, rows, pool_rows, dense, mode):
        w = _unit(rows["wp"])
        if mode == 1:
            q = _proj(rows["es"], w) + rows["rp"]
        else:
            q = _proj(rows["eo"], w) - rows["rp"]
        return self._sweep(q, w, pool_rows)

    def score_all_o(self, params: Params, s, p):
        w = _unit(params["W"][p])
        q = _proj(params["E"][s], w) + params["R"][p]
        return self._sweep(q, w, params["E"])

    def score_all_s(self, params: Params, o, p):
        w = _unit(params["W"][p])
        q = _proj(params["E"][o], w) - params["R"][p]
        return self._sweep(q, w, params["E"])
