"""ConvE — 2D-convolutional scoring (Dettmers et al., AAAI 2018).

    hidden(s, p) = ReLU( W . vec( ReLU( Conv2D([e_s ; r_p]) + bF ) ) + bW )
    score(s, o, p) = hidden(s, p) . e_o + b_o

e_s and r_p are d-dim rows reshaped to (eh, ew) grids and stacked into one
(2 eh, ew) image; the convolution is `F.conv2d`, NCHW input, OIHW filters
`F` (nfilters, 1, k, k), no padding, its output flattened in NCHW order,
the layouts of the JAX package's `conv_general_dilated`, so its tables
carry over unchanged. The paper's batch-norm and dropouts are training
choices, left out as in the JAX package.

- The per-entity output bias is the trailing column of `E` (n_e, d+1):
  subjects read columns [:d], objects give e_o and b_o from one gather, and
  `reg_grad_rows` leaves the bias column out of `rparam`. The sweeps
  append a constant 1 to the query: score = [hidden, 1] . E^T.
- The convolution runs in full fp32 whatever `torch.backends.cudnn`'s
  TF32 flag says: forward and backward both run under `_fp32_cudnn`, the
  backward inside a custom autograd function, since autograd would run it
  later, outside any guard around the forward.
- ConvE is directional: hidden() sees only (s, p). With `reciprocal=True`
  (the paper's protocol; n_relations is the doubled count of
  `data.add_reciprocal_relations`), training corrupts objects only and
  `score_all_s(o, p)` is `score_all_o(o, inv(p))`. With
  `reciprocal=False`, `score_all_s` builds each distinct batch relation's
  candidate hidden table, hidden(e, r) for every entity in chunks of
  4,096, and scores the queries of that relation against it.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from skge_torch.models.base import INITIALIZERS, KGEModel, Params, acc_dtype

ALL_S_CHUNK = 4096


def _auto_grid(d: int) -> int:
    """Largest divisor of d that is <= sqrt(d) (near-square reshape)."""
    best = 1
    for h in range(1, math.isqrt(d) + 1):
        if d % h == 0:
            best = h
    return best


@contextmanager
def _fp32_cudnn():
    """cuDNN with TF32 off, its other flags as the caller set them."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


class _Conv2dFP32(torch.autograd.Function):
    """`F.conv2d(img, w)` (stride 1, no padding) whose forward and backward
    both run under `_fp32_cudnn`."""

    @staticmethod
    def forward(ctx, img, w):
        ctx.save_for_backward(img, w)
        with _fp32_cudnn():
            return F.conv2d(img, w)

    @staticmethod
    def backward(ctx, grad):
        img, w = ctx.saved_tensors
        with _fp32_cudnn():
            g_img, g_w, _ = torch.ops.aten.convolution_backward(
                grad, img, w, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return g_img, g_w


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with the gradient at 0 split in half, as `jnp.maximum`'s."""
    return torch.maximum(x, x.new_zeros(()))


@dataclass(frozen=True)
class ConvE(KGEModel):
    """`ncomp` is the embedding dim d (must factor as eh * ew); entity rows
    are d+1 wide (trailing column = the per-entity output bias)."""

    nfilters: int = 32
    ksize: int = 3
    eh: int = 0          # grid height; 0 = auto (largest divisor <= sqrt d)
    reciprocal: bool = True
    rparam: float = 0.0

    name = "conve"
    dense_param_names = ("F", "bF", "W", "bW")
    reg_row_params = ("E", "R")

    def __post_init__(self):
        h, w = self.grid
        if h * w != self.ncomp:
            raise ValueError(
                f"ncomp={self.ncomp} does not factor as eh*ew with eh={h}"
            )
        if 2 * h < self.ksize or w < self.ksize:
            raise ValueError(
                f"conv kernel {self.ksize}x{self.ksize} larger than the "
                f"stacked {2 * h}x{w} image — pick a smaller ksize or "
                f"different eh"
            )
        if self.reciprocal and self.n_relations % 2 != 0:
            raise ValueError(
                "reciprocal=True expects n_relations to be the DOUBLED "
                "count (use data.add_reciprocal_relations)"
            )

    def reg_grad_rows(self, pname, rows):
        """The output biases (E's trailing column) are left out of the
        `rparam` row-L2 gradient."""
        if pname != "E":
            return rows
        return torch.cat([rows[..., :-1], torch.zeros_like(rows[..., -1:])], dim=-1)

    @property
    def grid(self):
        h = self.eh or _auto_grid(self.ncomp)
        return h, self.ncomp // h

    @property
    def conv_out(self):
        h, w = self.grid
        return 2 * h - self.ksize + 1, w - self.ksize + 1

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        d, c, k = self.ncomp, self.nfilters, self.ksize
        oh, ow = self.conv_out
        dt, dev = self.tdtype, generator.device
        emb = init(generator, (self.n_entities, d), dt)
        return {
            "E": torch.cat([emb, torch.zeros((self.n_entities, 1), dtype=dt,
                                             device=dev)], dim=1),
            "R": init(generator, (self.n_relations, d), dt),
            "F": init(generator, (c, k * k), dt).reshape(c, 1, k, k),
            "bF": torch.zeros((c,), dtype=dt, device=dev),
            "W": init(generator, (c * oh * ow, d), dt),
            "bW": torch.zeros((d,), dtype=dt, device=dev),
        }

    def _hidden(self, es_emb: torch.Tensor, rp: torch.Tensor, dense: Params):
        """(..., d) ConvE features of rows with any broadcasting leading
        axes, flattened for the convolution and restored after."""
        lead = torch.broadcast_shapes(es_emb.shape[:-1], rp.shape[:-1])
        h, w = self.grid
        img = torch.cat([es_emb.expand(*lead, -1).reshape(-1, 1, h, w),
                         rp.expand(*lead, -1).reshape(-1, 1, h, w)], dim=2)
        acc = acc_dtype(img)
        out = _Conv2dFP32.apply(img.to(acc), dense["F"].to(acc)).to(img.dtype)
        out = _relu(out + dense["bF"][None, :, None, None])
        flat = out.reshape(out.shape[0], -1)
        hidden = _relu(self.mxu(flat, dense["W"]) + dense["bW"])
        return hidden.reshape(*lead, self.ncomp)

    def score_from_rows(self, rows, dense):
        d = self.ncomp
        hidden = self._hidden(rows["es"][..., :d], rows["rp"], dense)
        return torch.sum(hidden * rows["eo"][..., :d], dim=-1) + rows["eo"][..., d]

    @staticmethod
    def _query1(hidden: torch.Tensor) -> torch.Tensor:
        """Append the constant-1 bias lane: score = q . [e_o | b_o]."""
        return torch.cat([hidden, hidden.new_ones((hidden.shape[0], 1))], dim=-1)

    def score_pool(self, rows, pool_rows, dense, mode):
        if mode != 1:
            raise ValueError(
                "ConvE scores candidate OBJECTS only (hidden() is a "
                "function of (s, p)); train with reciprocal relations and "
                "object-side corruption (sampler modes=(1,) or "
                "make_ce_step(directions=('o',)))"
            )
        hidden = self._hidden(rows["es"][:, :self.ncomp], rows["rp"], dense)
        return self.mxu(self._query1(hidden), pool_rows.T)

    def _inv(self, p: torch.Tensor) -> torch.Tensor:
        half = self.n_relations // 2
        return torch.where(p < half, p + half, p - half)

    def score_all_o(self, params: Params, s, p):
        hidden = self._hidden(params["E"][s, :self.ncomp], params["R"][p],
                              self.dense_params(params))
        return self.mxu(self._query1(hidden), params["E"].T)

    def score_all_s(self, params: Params, o, p):
        if self.reciprocal:
            return self.score_all_o(params, o, self._inv(p))
        # hidden() is a function of (candidate, p): one candidate hidden
        # table per distinct relation of the batch, each query scored
        # against its relation's table
        d = self.ncomp
        dense = self.dense_params(params)
        eo = params["E"][o, :d]                       # (B, d)
        e_all = params["E"][:, :d]
        out = None
        for r in torch.unique(p).tolist():
            rp = params["R"][r]
            table = torch.cat([self._hidden(blk, rp, dense)
                               for blk in torch.split(e_all, ALL_S_CHUNK)])
            sc = self.mxu(eo, table.T)                # (B, n_e)
            out = sc if out is None else torch.where((p == r)[:, None], sc, out)
        return out + params["E"][o, d][:, None]
