"""TransR — translation in relation-specific spaces (Lin et al., AAAI 2015).

    score = -|| M_p e_s + r_p - M_p e_o ||^2

E (n_e, ncomp), R (n_r, rcomp), M (n_r, rcomp, ncomp): a 3-D row param
like RESCAL's W, starting as the identity (the paper's TransE start); E
and R keep the `normless1` constraint. M is a real copy of the identity
per relation, not an expanded view: the optimizer updates rows in place.

The training score projects the difference once, M (e_s - e_o) + r. The
projection broadcasts the (B, r, c) matrices against entity rows with
extra leading axes, as the fused iid step's (n, B, c) stacks are.

Candidate sweeps (pool and all-entity) cost O(B N rcomp ncomp) whatever
their form. `sweep="quadratic"` (the default) expands the square,

    -||q - M e||^2 = 2 (M^T q) . e - vec(M^T M) . vec(e e^T) - ||q||^2

so the sweep is one (B, d) x (d, N) matmul per mode and one
(B, d^2) x (d^2, N) matmul against the candidates' outer products, the
flattened Gram tensor M^T M being shared by every mode
(`score_pool_modes`), forward and backward. More than 2,048 candidates go
in chunks of 2,048, the last the remainder, each recomputed in the
backward pass under autograd (`torch.utils.checkpoint`) to bound the
(chunk, d^2) outer products; a single chunk is neither checkpointed nor
recomputed. `sweep="direct"` keeps the definitional form: per-query
projections of 128 candidates at a time.

`factored=True` takes M_p = I + u_p v_p^T (tables U and V, U starting at
0 so M = I): projections are O(d) and every sweep term is a rank-1
corrected (B, d) x (d, N) matmul.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from skge_torch.models.base import INITIALIZERS, KGEModel, Params, acc_dtype

QUAD_CHUNK = 2048
DIRECT_CHUNK = 128


def _chunked(body, cand: torch.Tensor, chunk: int, *args):
    """body(cblk, *args) -> tuple of (B, chunk) over `chunk` candidates at
    a time, the last chunk the remainder, each chunk recomputed in the
    backward pass when autograd records; concatenated along the
    candidates."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (cand, *args))
    # the bodies draw nothing: no RNG state to save (saving it reads the
    # card's generator, which a CUDA graph capture forbids)
    per = [checkpoint(body, c, *args, use_reentrant=False, preserve_rng_state=False)
           if grad else body(c, *args) for c in torch.split(cand, chunk)]
    return tuple(torch.cat(outs, dim=1) for outs in zip(*per))


@dataclass(frozen=True)
class TransR(KGEModel):
    rcomp: int = 0  # relation-space dim; 0 = ncomp
    sweep: str = "quadratic"  # or "direct"
    factored: bool = False

    name = "transr"
    post_constraints = {"E": "normless1", "R": "normless1"}

    def __post_init__(self):
        if self.factored and self.rcomp not in (0, self.ncomp):
            raise ValueError(
                "factored TransR requires rcomp == ncomp (the rank-1 "
                "perturbation is of the identity)"
            )

    @property
    def rdim(self) -> int:
        return self.rcomp or self.ncomp

    def slot_spec(self):
        if self.factored:
            return (("es", "E", "s"), ("eo", "E", "o"),
                    ("rp", "R", "p"), ("up", "U", "p"), ("vp", "V", "p"))
        return (("es", "E", "s"), ("eo", "E", "o"),
                ("rp", "R", "p"), ("mp", "M", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        dt, dev = self.tdtype, generator.device
        if self.factored:
            return {
                "E": init(generator, (self.n_entities, self.ncomp), dt),
                "R": init(generator, (self.n_relations, self.ncomp), dt),
                "U": torch.zeros((self.n_relations, self.ncomp), dtype=dt, device=dev),
                "V": init(generator, (self.n_relations, self.ncomp), dt),
            }
        eye = torch.eye(self.rdim, self.ncomp, dtype=dt, device=dev)
        return {
            "E": init(generator, (self.n_entities, self.ncomp), dt),
            "R": init(generator, (self.n_relations, self.rdim), dt),
            "M": eye.expand(self.n_relations, self.rdim, self.ncomp).clone(),
        }

    def _project(self, m, e):
        """M_p e: (B, r, c) matrices against (..., B, c) rows."""
        acc = acc_dtype(e)
        return torch.matmul(m.to(acc), e.to(acc)[..., None])[..., 0].to(e.dtype)

    @staticmethod
    def _project_f(u, v, x):
        """(I + u v^T) x = x + u (v . x), the factored projection."""
        return x + u * torch.sum(v * x, dim=-1, keepdim=True)

    def _sweep_factored(self, qs, u, v, cand):
        """-||q - (I + u v^T) c||^2 for every candidate c, per query; with
        t = v . c: q2 + c2 + t^2 u2 - 2 q.c - 2 t q.u + 2 t c.u, the vc and
        uc matmuls shared by every query."""
        vc = self.mxu(v, cand.T)                      # (B, N)
        uc = self.mxu(u, cand.T)                      # (B, N)
        c2 = torch.sum(cand * cand, dim=-1)           # (N,)
        u2 = torch.sum(u * u, dim=-1)                 # (B,)
        outs = []
        for q in qs:
            qc = self.mxu(q, cand.T)
            q2 = torch.sum(q * q, dim=-1)
            qu = torch.sum(q * u, dim=-1)
            outs.append(-(
                q2[:, None] - 2.0 * qc + c2[None, :]
                + vc * (vc * u2[:, None] + 2.0 * (uc - qu[:, None]))
            ))
        return tuple(outs)

    def score_from_rows(self, rows, dense):
        if self.factored:
            d = self._project_f(rows["up"], rows["vp"], rows["es"] - rows["eo"])
        else:
            d = self._project(rows["mp"], rows["es"] - rows["eo"])
        d = d + rows["rp"]
        return -torch.sum(d * d, dim=-1)

    def _sweep(self, q, m, cand):
        """-||q - M_b e||^2 for every candidate e."""
        if self.sweep == "quadratic":
            return self._sweep_quadratic_multi((q,), m, cand)[0]
        return self._sweep_direct(q, m, cand)

    def _sweep_direct(self, q, m, cand):
        """The definitional form: each query's projection of every
        candidate, DIRECT_CHUNK candidates at a time."""
        acc = acc_dtype(q)

        def body(cblk, q, m):
            proj = torch.einsum("bij,kj->bki", m.to(acc), cblk.to(acc)).to(q.dtype)
            diff = q[:, None, :] - proj                 # (B, chunk, rcomp)
            return (-torch.sum(diff * diff, dim=-1),)

        return _chunked(body, cand, DIRECT_CHUNK, q, m)[0]

    def _sweep_quadratic_multi(self, qs, m, cand):
        """The expanded square for every query of `qs` (one per mode): the
        Gram tensor and the quadratic-term matmul computed once for all."""
        n, d = cand.shape
        b = qs[0].shape[0]
        acc = acc_dtype(qs[0])
        dt = qs[0].dtype
        ma = m.to(acc)
        ts = [torch.einsum("bri,br->bi", ma, q.to(acc)).to(dt) for q in qs]
        q2s = [torch.sum(q * q, dim=-1) for q in qs]
        gflat = torch.einsum("bri,brj->bij", ma, ma).to(dt).reshape(b, d * d)

        def body(cblk, gflat, *ts):
            outer = (cblk[:, :, None] * cblk[:, None, :]).reshape(cblk.shape[0], d * d)
            quad = self.mxu(gflat, outer.T)             # (B, chunk)
            return tuple(2.0 * self.mxu(t, cblk.T) - quad for t in ts)

        if n <= QUAD_CHUNK:
            outs = body(cand, gflat, *ts)
        else:
            outs = _chunked(body, cand, QUAD_CHUNK, gflat, *ts)
        return tuple(o - q2[:, None] for o, q2 in zip(outs, q2s))

    def _pool_query(self, rows, mode):
        if self.factored:
            proj = self._project_f(rows["up"], rows["vp"], rows["es" if mode == 1 else "eo"])
        else:
            proj = self._project(rows["mp"], rows["es" if mode == 1 else "eo"])
        return proj + rows["rp"] if mode == 1 else proj - rows["rp"]

    def score_pool(self, rows, pool_rows, dense, mode):
        return self.score_pool_modes(rows, pool_rows, dense, (mode,))[0]

    def score_pool_modes(self, rows, pool_rows, dense, modes):
        """Both corruption modes share the dominant sweep terms (full rank:
        the Gram and quadratic matmul; factored: the vc and uc matmuls) and
        their backward passes."""
        qs = tuple(self._pool_query(rows, mode) for mode in modes)
        if self.factored:
            return self._sweep_factored(qs, rows["up"], rows["vp"], pool_rows)
        if self.sweep != "quadratic":
            return tuple(self._sweep_direct(q, rows["mp"], pool_rows) for q in qs)
        return self._sweep_quadratic_multi(qs, rows["mp"], pool_rows)

    def _score_all(self, params: Params, ent_idx, p, sign: float):
        if self.factored:
            u, v = params["U"][p], params["V"][p]
            q = self._project_f(u, v, params["E"][ent_idx]) + sign * params["R"][p]
            return self._sweep_factored((q,), u, v, params["E"])[0]
        m = params["M"][p]
        q = self._project(m, params["E"][ent_idx]) + sign * params["R"][p]
        return self._sweep(q, m, params["E"])

    def score_all_o(self, params: Params, s, p):
        return self._score_all(params, s, p, 1.0)

    def score_all_s(self, params: Params, o, p):
        return self._score_all(params, o, p, -1.0)
