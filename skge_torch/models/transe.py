"""TransE — translational embeddings (Bordes et al. 2013).

score = -||E[s] + R[p] - E[o]||, L1 by default (`l1=True`); the L2 variant
is the SQUARED distance. Entity rows carry the `normless1` unit-ball
constraint, applied after each update to touched rows only.

L1 takes |x| as `where(x >= 0, x, -x)`, whose gradient at x == 0 is +1, as
`jax.grad(jnp.abs)` gives; `torch.abs` would give 0 there. An exact-zero
difference (a pool row equal to the query) then trains as in the JAX
package.

The L1 pool and all-entity sweeps are plain PyTorch, chunked over the pool
or the entities to bound the (B, chunk, d) broadcast. In training each pool
chunk is recomputed in the backward pass (`torch.utils.checkpoint`), so the
full (B, K, d) tensor never exists. L2 rides a matmul through the norm
expansion ||q - e||^2 = |q|^2 - 2 q.e + |e|^2.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from skge_torch.models.base import INITIALIZERS, KGEModel, Params

POOL_CHUNK = 512
ALL_CHUNK = 4096


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with gradient +1 at x == 0 (JAX's convention)."""
    return torch.where(x >= 0, x, -x)


def _neg_l1_pool_chunk(q: torch.Tensor, pblk: torch.Tensor) -> torch.Tensor:
    return -torch.sum(_abs(q[:, None, :] - pblk[None, :, :]), dim=-1)


@dataclass(frozen=True)
class TransE(KGEModel):
    l1: bool = True

    name = "transe"
    post_constraints = {"E": "normless1"}

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        return {
            "E": init(generator, (self.n_entities, self.ncomp), self.tdtype),
            "R": init(generator, (self.n_relations, self.ncomp), self.tdtype),
        }

    def score_from_rows(self, rows, dense):
        d = rows["es"] + rows["rp"] - rows["eo"]
        if self.l1:
            return -torch.sum(_abs(d), dim=-1)
        return -torch.sum(d * d, dim=-1)

    # --- all-entity scoring (eval) ---
    def _score_all(self, E: torch.Tensor, q: torch.Tensor, sign: float) -> torch.Tensor:
        """Scores -||q[b] + sign*E[e]|| for all e; q: (B, d)."""
        if not self.l1:
            qn = torch.sum(q * q, dim=-1, keepdim=True)
            en = torch.sum(E * E, dim=-1)[None, :]
            cross = 2.0 * sign * self.mxu(q, E.T)
            return -(qn + cross + en)
        return torch.cat(
            [
                -torch.sum(_abs(q[:, None, :] + sign * Eblk[None, :, :]), dim=-1)
                for Eblk in torch.split(E, ALL_CHUNK)
            ],
            dim=1,
        )

    def score_pool(self, rows, pool_rows, dense, mode):
        """(B, K) distances to the shared negative pool.

        mode 1: -||(es + rp) - e_k||; mode 0: -||e_k - (eo - rp)||. Both are
        distances between a (B, d) query and the pool.
        """
        q = rows["es"] + rows["rp"] if mode == 1 else rows["eo"] - rows["rp"]
        if not self.l1:
            qn = torch.sum(q * q, dim=-1, keepdim=True)
            pn = torch.sum(pool_rows * pool_rows, dim=-1)[None, :]
            return -(qn - 2.0 * self.mxu(q, pool_rows.T) + pn)
        return torch.cat(
            [
                checkpoint(_neg_l1_pool_chunk, q, c, use_reentrant=False)
                for c in torch.split(pool_rows, POOL_CHUNK)
            ],
            dim=1,
        )

    def score_all_o(self, params: Params, s, p):
        q = params["E"][s] + params["R"][p]
        return self._score_all(params["E"], q, -1.0)

    def score_all_s(self, params: Params, o, p):
        q = params["R"][p] - params["E"][o]
        return self._score_all(params["E"], q, 1.0)
