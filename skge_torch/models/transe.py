"""TransE — translational embeddings (Bordes et al. 2013).

score = -||E[s] + R[p] - E[o]||, L1 by default (`l1=True`); the L2 variant
is the SQUARED distance. Entity rows carry the `normless1` unit-ball
constraint, applied after each update to touched rows only.

L1 takes |x| as `where(x >= 0, x, -x)`, whose gradient at x == 0 is +1, as
`jax.grad(jnp.abs)` gives; `torch.abs` would give 0 there. An exact-zero
difference (a pool row equal to the query) then trains as in the JAX
package.

The L1 pool and all-entity sweeps route by their inputs:
- fp32 on the card: K3 (`ops/cuda_l1.l1_pool`, csrc/l1_pool.cu), one call
  over the whole pool or table, forward and backward, no (B, K, d) tensor.
  `score_pool_modes` stacks the modes' queries into that one call.
- the CPU, and other dtypes on the card (`compute_dtype` bfloat16, fp64):
  plain PyTorch, chunked over the pool or the entities to bound the (B,
  chunk, d) broadcast. Under autograd (pool training, full cross entropy)
  each chunk is recomputed in the backward pass (`torch.utils.checkpoint`),
  so no (B, chunk, d) tensor outlives its chunk.
L2 rides a matmul through the norm expansion ||q - e||^2 = |q|^2 - 2 q.e +
|e|^2.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from skge_torch.models.base import INITIALIZERS, KGEModel, Params
from skge_torch.ops.cuda_l1 import l1_pool, l1_pool_reference

POOL_CHUNK = 512
ALL_CHUNK = 4096


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with gradient +1 at x == 0 (JAX's convention)."""
    return torch.where(x >= 0, x, -x)


def _on_k3(q: torch.Tensor, rows: torch.Tensor) -> bool:
    return q.is_cuda and q.dtype == rows.dtype == torch.float32


def _pool_query(rows, mode: int) -> torch.Tensor:
    """The (B, d) query a pool row is compared with: es + rp (mode 1, the
    object corrupted) or eo - rp (mode 0)."""
    return rows["es"] + rows["rp"] if mode == 1 else rows["eo"] - rows["rp"]


def _neg_l1_chunks(q: torch.Tensor, rows: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, n) = -||q[b] - rows[e]||_1: K3 in one call for fp32 on the card;
    otherwise `chunk` rows at a time, each chunk recomputed in the backward
    pass when autograd records."""
    if _on_k3(q, rows):
        return l1_pool(q.contiguous(), rows.contiguous())

    def one(c):
        if torch.is_grad_enabled() and (q.requires_grad or c.requires_grad):
            # no RNG state to save: the sweep draws nothing
            return checkpoint(l1_pool_reference, q, c, use_reentrant=False,
                              preserve_rng_state=False)
        return l1_pool_reference(q, c)

    return torch.cat([one(c) for c in torch.split(rows, chunk)], dim=1)


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
        # q + E[e] = q - (-E[e]) (object side); q - E[e] (subject side)
        return _neg_l1_chunks(q, -sign * E, ALL_CHUNK)

    def score_pool(self, rows, pool_rows, dense, mode):
        """(B, K) distances to the shared negative pool.

        mode 1: -||(es + rp) - e_k||; mode 0: -||e_k - (eo - rp)||. Both are
        distances between a (B, d) query and the pool.
        """
        q = _pool_query(rows, mode)
        if not self.l1:
            qn = torch.sum(q * q, dim=-1, keepdim=True)
            pn = torch.sum(pool_rows * pool_rows, dim=-1)[None, :]
            return -(qn - 2.0 * self.mxu(q, pool_rows.T) + pn)
        return _neg_l1_chunks(q, pool_rows, POOL_CHUNK)

    def score_pool_modes(self, rows, pool_rows, dense, modes):
        """On K3's route, the modes' (B, d) queries stacked into one call."""
        if not (self.l1 and len(modes) > 1 and _on_k3(rows["rp"], pool_rows)):
            return super().score_pool_modes(rows, pool_rows, dense, modes)
        q = torch.cat([_pool_query(rows, m) for m in modes])
        return torch.split(_neg_l1_chunks(q, pool_rows, POOL_CHUNK), rows["rp"].shape[0])

    def score_all_o(self, params: Params, s, p):
        q = params["E"][s] + params["R"][p]
        return self._score_all(params["E"], q, -1.0)

    def score_all_s(self, params: Params, o, p):
        q = params["R"][p] - params["E"][o]
        return self._score_all(params["E"], q, 1.0)
