"""Link-prediction serving of the port: batched top-K entity retrieval,
`skge_tpu.serving`'s single-device engines.

Given (entity, relation) queries, return the K best completion entities,
exactly, with known-true triples filtered out.

- `LinkPredictor`: the entity table on the device; one `score_pool` sweep
  per query batch against the whole table, then the top k.
- `StreamedLinkPredictor`: the entity table in pinned host memory;
  candidate chunks upload one at a time (the next one while the current
  one is scored) and fold into a running (B, k) frontier, so the device
  holds two chunks and the frontier, never the table.

Both score candidates through the model's `score_pool`, as the JAX
package's engines do, so their scores agree with each other. The filter
is built once: `known`'s CSR index of each direction (`known_csr`) lives
on the device, and each score tile (a batch, a rank's block, a chunk) is
masked by one `filter_known` launch (`ops/cuda_filter.mask_known`; its
plain version off the card), with no per-query work on the host. Ties break
toward the lower entity id, as `lax.top_k` breaks them: `_top_k` takes each
tile's k best by value, then column, in one `top_k` launch on the card
(`ops/cuda_topk.py`; its plain version off it), which on one device also
turns filtered winners into (-inf, -1). In the streamed fold the frontier,
which holds lower ids, sits before the chunk, so it wins ties.

The entity table may be stored quantized: per-row int8 or float8_e4m3fn
with an fp32 scale (`quantize_table_int8`, `quantize_table_fp8`), or
bfloat16; query rows and candidates are dequantized to fp32 before
scoring. The JAX package's `aot_kernels` and `export_serialized` are XLA
and StableHLO artifacts and have no counterpart here.

`LinkPredictor(mesh=, axis=)` is the candidate-sharded engine: the entity
table row-sharded over the mesh's `axis` group, each rank gathers the query
rows masked-locally (one all-reduce), scores only its own candidate block,
filters it (base rank * S) and takes its local top-min(k, S); the (B, k)
frontiers are all-gathered and merged under the same lower-id rule. Every
rank of the group calls `top_k` with the same queries and gets the same
result.

Every engine runs on the card unless the caller asks for the CPU
(`device="cpu"`); without a GPU it raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from skge_torch.models.base import KGEModel, Params, entity_param
from skge_torch.ops import cuda_topk
from skge_torch.ops.cuda_filter import known_index, mask_known
from skge_torch.utils.device import resolve_device
from skge_torch.utils.metrics import span

__all__ = [
    "LinkPredictor",
    "StreamedLinkPredictor",
    "TopKResult",
    "quantize_table_fp8",
    "quantize_table_int8",
    "top_k_candidates",
]


def _absmax_scale(table, qmax: float) -> Tuple[np.ndarray, np.ndarray]:
    t = np.asarray(table, np.float32)
    absmax = np.max(np.abs(t), axis=tuple(range(1, t.ndim)), keepdims=True)
    return t, (absmax / qmax + np.float32(1e-30)).astype(np.float32)


def quantize_table_int8(table) -> Dict[str, torch.Tensor]:
    """Symmetric per-row int8 quantization: {'q': int8 (n, ...), 'scale':
    fp32 (n, 1...)}, dequantized as `q * scale` with scale = absmax / 127.
    CPU tensors, bit-equal to the JAX package's arrays."""
    t, scale = _absmax_scale(table, 127.0)
    q = np.clip(np.rint(t / scale), -127, 127).astype(np.int8)
    return {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}


def quantize_table_fp8(table) -> Dict[str, torch.Tensor]:
    """Per-row scaled `torch.float8_e4m3fn` quantization, scale = absmax /
    448 (e4m3fn's largest normal): the same bytes as int8, with 3 mantissa
    bits instead of a uniform grid. CPU tensors."""
    t, scale = _absmax_scale(table, 448.0)
    q = torch.from_numpy(t / scale).to(torch.float8_e4m3fn)
    return {"q": q, "scale": torch.from_numpy(scale)}


_QUANTIZERS = {"int8": quantize_table_int8, "fp8": quantize_table_fp8}
_QUANT_MODES = ("", "int8", "fp8", "bfloat16")


@dataclass
class TopKResult:
    """Top-K completions for a query batch.

    `entities[b, j]` is the j-th best completion entity for query b (object
    entities for direction 'o', subjects for 's'); `scores[b, j]` its model
    score (descending in j). Filtered-out slots, possible only when k
    exceeds the eligible entities, carry entity id -1 and score -inf.
    """

    entities: np.ndarray  # (B, k) int32
    scores: np.ndarray    # (B, k) float32


def _tensor(v) -> torch.Tensor:
    """A tensor of `v` (a tensor, or anything numpy reads)."""
    return v if torch.is_tensor(v) else torch.as_tensor(np.array(v))


def _quantized(table: torch.Tensor, quantize: str):
    """The entity table in its stored form (on the host)."""
    if quantize in _QUANTIZERS:
        return _QUANTIZERS[quantize](table.detach().cpu().numpy())
    if quantize == "bfloat16":
        return table.detach().cpu().to(torch.bfloat16)
    return table


def _deq(qe):
    """fp32 rows of a quantized payload; a plain table as it is."""
    if isinstance(qe, dict):
        return qe["q"].to(torch.float32) * qe["scale"]
    if qe.dtype == torch.bfloat16:
        return qe.to(torch.float32)
    return qe


def _deq_rows(qe, idx):
    if isinstance(qe, dict):
        return _deq({"q": qe["q"][idx], "scale": qe["scale"][idx]})
    return _deq(qe[idx])


def _query_rows(model: KGEModel, params: Params, ent, rel, direction: str):
    """Gathered rows for (ent, rel) queries with the predicted slot's row 0.

    direction 'o' predicts objects (query ent is the subject, score_pool
    mode 1); 's' predicts subjects (mode 0). `score_pool` replaces the
    predicted slot with each candidate, so index 0 stands in. Entity rows
    are dequantized per gather, and every row lands on `rel`'s device (the
    streamed engine gathers entity rows on the host).
    """
    epname = entity_param(model)
    zeros = torch.zeros_like(ent)
    s_idx, o_idx = (ent, zeros) if direction == "o" else (zeros, ent)
    idx_by_role = {"s": s_idx, "o": o_idx, "p": rel}
    rows = {}
    for slot, pname, role in model.slot_spec():
        idx = idx_by_role[role]
        rows[slot] = (_deq_rows(params[pname], idx) if pname == epname
                      else params[pname][idx]).to(rel.device)
    return rows


_MODE = {"o": 1, "s": 0}


def _top_k(scores: torch.Tensor, k: int, mask: bool = False):
    """(values, column positions) of each row's k largest scores, descending,
    ties broken toward the lower position (`lax.top_k`'s rule); with `mask`,
    filtered winners as (-inf, -1) and the ids int32 (`mask_invalid`). One
    `cuda_topk.top_k` launch on the card, `top_k_reference` off it."""
    if scores.is_cuda:
        return cuda_topk.top_k(scores.contiguous(), k, mask)
    return cuda_topk.top_k_reference(scores, k, mask)


def _queries(queries) -> np.ndarray:
    return np.asarray(queries, np.int64).reshape(-1, 2)


def _check_direction(direction: str) -> None:
    if direction not in ("o", "s"):
        raise ValueError(f"direction must be 'o' or 's', got {direction!r}")


class LinkPredictor:
    """Exact top-K link prediction over an entity table on the device.

    `known` (optional (N, 3) (s, o, p) triples, typically train ∪ valid)
    enables filtered retrieval: known-true completions are removed before
    the top k. `quantize` stores the entity table as 'int8', 'fp8' (4x
    smaller) or 'bfloat16' (2x); scores are then approximate. `mesh` (a
    `parallel.mesh.Mesh`) shards the candidates over its `axis` group: the
    params are whole tables or this rank's part (`Trainer(mesh=)`'s
    state), and `n_entities` must divide by the axis size.
    """

    def __init__(
        self,
        model: KGEModel,
        params: Params,
        known: Optional[np.ndarray] = None,
        batch_size: int = 1024,
        mesh=None,
        axis: str = "model",
        quantize: str = "",
        device=None,
    ):
        if quantize not in _QUANT_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.group = None
        if mesh is not None:
            from skge_torch.parallel.mesh import row_block

            if device is not None and torch.device(device).type != mesh.device.type:
                raise ValueError(f"device={device!r} but the mesh runs on {mesh.device}")
            self.group = mesh.group(axis)
            if model.n_entities % self.group.size != 0:
                raise ValueError(
                    f"n_entities={model.n_entities} not divisible by mesh axis "
                    f"{axis}={self.group.size}; pad the entity count")
        self.device = mesh.device if mesh is not None else resolve_device(device, "serves")
        self.model = model
        self.quantize = quantize
        self.axis = axis
        epname = entity_param(model)
        params = {kk: _tensor(v) for kk, v in params.items()}
        if self.group is not None:  # this rank's candidate block
            params[epname] = row_block(params[epname], model.n_entities, self.group)
        params[epname] = _quantized(params[epname], quantize)
        self.params = {
            kk: ({n: t.to(self.device) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(self.device))
            for kk, v in params.items()
        }
        self.batch_size = int(batch_size)
        self._known = (None if known is None
                       else known_index(known, model.n_relations, self.device))

    @torch.no_grad()
    def _batch(self, ent, rel, index, direction: str, k: int):
        if self.group is not None:
            return self._sharded_batch(ent, rel, index, direction, k)
        model, params = self.model, self.params
        with span("skge_torch.serve.score"):
            rows = _query_rows(model, params, ent, rel, direction)
            scores = model.score_pool(rows, _deq(params[entity_param(model)]),
                                      model.dense_params(params), _MODE[direction])
        with span("skge_torch.serve.filter"):
            scores = mask_known(scores, ent, rel, index, 0, model.n_relations)
        with span("skge_torch.serve.topk"):
            return _top_k(scores, k, mask=True)

    def _sharded_rows(self, idx_by_role):
        """Each slot's rows on the candidate-sharded engine: entity rows by
        the masked-local gather over the group (`ShardGroup.gather_rows`),
        dequantized by their owner; other tables whole."""
        model, params, group = self.model, self.params, self.group
        epname = entity_param(model)
        s_rows = model.n_entities // group.size
        rows = {}
        for slot, pname, role in model.slot_spec():
            idx = idx_by_role[role]
            rows[slot] = (params[pname][idx] if pname != epname else group.gather_rows(
                idx, s_rows, lambda i: _deq_rows(params[epname], i)))
        return rows

    def _sharded_batch(self, ent, rel, index, direction: str, k: int):
        """One batch on the candidate-sharded engine: this rank's block
        scored, filtered and cut to its top-min(k, S), the frontiers of
        the group merged."""
        model, params, group = self.model, self.params, self.group
        qe = params[entity_param(model)]
        s_rows = model.n_entities // group.size
        off = group.rank * s_rows
        zeros = torch.zeros_like(ent)
        s_idx, o_idx = (ent, zeros) if direction == "o" else (zeros, ent)
        rows = self._sharded_rows({"s": s_idx, "o": o_idx, "p": rel})
        scores = model.score_pool(rows, _deq(qe), model.dense_params(params),
                                  _MODE[direction])                 # (B, S)
        with span("skge_torch.serve.filter"):  # this block's columns: entities off + j
            scores = mask_known(scores, ent, rel, index, off, model.n_relations)
        lvals, lids = _top_k(scores, min(k, s_rows))
        # (B, M * k') frontier in rank order: among equal scores the lower
        # position is the lower id, so `_top_k`'s rule carries over
        b = lvals.shape[0]
        avals = group.all_gather(lvals.contiguous()).permute(1, 0, 2).reshape(b, -1)
        aids = group.all_gather((lids + off).contiguous()).permute(1, 0, 2).reshape(b, -1)
        vals, pick = _top_k(avals, k)
        ids = torch.gather(aids, 1, pick)
        return cuda_topk.mask_invalid(vals, ids.to(torch.int32))

    def top_k(
        self,
        queries: np.ndarray,
        k: int,
        direction: str = "o",
        filtered: bool = True,
    ) -> TopKResult:
        """Top-k completions for `queries`, an (N, 2) int array of
        (entity, relation): (s, p) rows for direction 'o', (o, p) for 's'.
        On a mesh, every rank of the axis group calls it with the same
        queries."""
        _check_direction(direction)
        q = _queries(queries)
        n = q.shape[0]
        k = int(min(k, self.model.n_entities))
        index = self._known[direction] if filtered and self._known else None
        bs = min(self.batch_size, max(1, n))
        out_ids = np.empty((n, k), np.int32)
        out_vals = np.empty((n, k), np.float32)
        dev = self.device
        for start in range(0, n, bs):
            with span("skge_torch.serve.batch"):
                batch = q[start : start + bs]
                nvalid = batch.shape[0]
                vals, ids = self._batch(
                    *(torch.as_tensor(a, dtype=torch.int64, device=dev)
                      for a in (batch[:, 0], batch[:, 1])),
                    index, direction, k)
                with span("skge_torch.serve.fetch"):
                    out_ids[start : start + nvalid] = ids.cpu().numpy()
                    out_vals[start : start + nvalid] = vals.cpu().numpy()
        return TopKResult(entities=out_ids, scores=out_vals)

    @torch.no_grad()
    def score_triples(self, triples: np.ndarray) -> np.ndarray:
        """Model scores for explicit (s, o, p) triples (link plausibility)."""
        t = torch.as_tensor(np.asarray(triples, np.int64).reshape(-1, 3),
                            device=self.device)
        if self.group is not None:
            rows = self._sharded_rows({"s": t[:, 0], "o": t[:, 1], "p": t[:, 2]})
            return self.model.score_from_rows(
                rows, self.model.dense_params(self.params)).cpu().numpy()
        params = {kk: _deq(v) for kk, v in self.params.items()}
        return self.model.score_triples(params, t).cpu().numpy()


def top_k_candidates(
    model: KGEModel,
    params: Params,
    queries: np.ndarray,
    k: int,
    direction: str = "o",
    known: Optional[np.ndarray] = None,
    device=None,
) -> TopKResult:
    """One-shot `LinkPredictor`, filtered when `known` is given."""
    pred = LinkPredictor(model, params, known=known, device=device)
    return pred.top_k(queries, k, direction=direction, filtered=known is not None)


class StreamedLinkPredictor:
    """Top-K retrieval with the entity table in host memory.

    `params_host` holds numpy arrays or CPU tensors. The entity table (in
    its stored form under `quantize`) is kept in pinned host memory when
    serving on the card; candidate chunks of `chunk` rows are copied with
    `non_blocking=True` on a copy stream, one chunk ahead of the one being
    scored, and fold into a running (B, k) frontier. Query entity rows are
    gathered on the host per batch; relation and dense params live on the
    device. `bytes_uploaded` counts the chunk bytes copied so far.
    """

    def __init__(
        self,
        model: KGEModel,
        params_host: Dict[str, np.ndarray],
        known: Optional[np.ndarray] = None,
        batch_size: int = 256,
        chunk: int = 65536,
        quantize: str = "",
        device=None,
    ):
        if quantize not in _QUANT_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.device = resolve_device(device, "serves")
        self.model = model
        self.quantize = quantize
        self.batch_size = int(batch_size)
        self.chunk = int(min(chunk, model.n_entities))
        self._epname = epname = entity_param(model)
        stored = _quantized(_tensor(params_host[epname]).cpu(), quantize)
        pin = self.device.type == "cuda"

        def host(t):
            return t.contiguous().pin_memory() if pin else t.contiguous()

        self._stored = ({kk: host(v) for kk, v in stored.items()}
                        if isinstance(stored, dict) else host(stored))
        self._small = {kk: _tensor(v).to(self.device)
                       for kk, v in params_host.items() if kk != epname}
        self._known = (None if known is None
                       else known_index(known, model.n_relations, self.device))
        self.bytes_uploaded = 0

    def _upload(self, lo: int, hi: int):
        """Rows [lo, hi) of the stored table, copied to the device."""
        def one(t):
            self.bytes_uploaded += t[lo:hi].numel() * t.element_size()
            return t[lo:hi].to(self.device, non_blocking=True)

        s = self._stored
        return {kk: one(v) for kk, v in s.items()} if isinstance(s, dict) else one(s)

    def _chunks(self):
        """(base, device payload) per chunk, each uploaded on a copy stream
        while the previous one is scored (on the card)."""
        n_e, c = self.model.n_entities, self.chunk
        bases = list(range(0, n_e, c))
        if self.device.type != "cuda":
            for base in bases:
                yield base, self._upload(base, min(base + c, n_e))
            return
        copy = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)

        def issue(base):
            copy.wait_stream(compute)  # the slot's previous reader is done
            with torch.cuda.stream(copy):
                payload = self._upload(base, min(base + c, n_e))
            return payload

        nxt = issue(bases[0])
        for i, base in enumerate(bases):
            compute.wait_stream(copy)
            payload = nxt
            for t in (payload.values() if isinstance(payload, dict) else (payload,)):
                t.record_stream(compute)
            if i + 1 < len(bases):
                nxt = issue(bases[i + 1])
            yield base, payload

    @torch.no_grad()
    def top_k(
        self,
        queries: np.ndarray,
        k: int,
        direction: str = "o",
        filtered: bool = True,
    ) -> TopKResult:
        _check_direction(direction)
        model, dev = self.model, self.device
        q = _queries(queries)
        n = q.shape[0]
        k = int(min(k, model.n_entities))
        index = self._known[direction] if filtered and self._known else None
        mode = _MODE[direction]
        bs = min(self.batch_size, max(1, n))
        out_ids = np.empty((n, k), np.int32)
        out_vals = np.empty((n, k), np.float32)
        dense = model.dense_params(self._small)
        params = {**self._small, self._epname: self._stored}
        for start in range(0, n, bs):
            batch = q[start : start + bs]
            nvalid = batch.shape[0]
            # query entity rows gathered (and dequantized) on the host
            ent, rel = (torch.as_tensor(a, device=dev) for a in (batch[:, 0], batch[:, 1]))
            qrows = _query_rows(model, params, torch.from_numpy(batch[:, 0]), rel, direction)
            vals = torch.full((nvalid, k), -np.inf, dtype=torch.float32, device=dev)
            ids = torch.full((nvalid, k), -1, dtype=torch.int32, device=dev)
            for base, payload in self._chunks():
                cand = _deq(payload)
                scores = mask_known(model.score_pool(qrows, cand, dense, mode),  # (B, C)
                                     ent, rel, index, base, model.n_relations)
                cids = torch.arange(base, base + cand.shape[0], dtype=torch.int32,
                                    device=dev).expand(nvalid, -1)
                vals, pick = _top_k(torch.cat([vals, scores], dim=1), k)
                ids = torch.gather(torch.cat([ids, cids], dim=1), 1, pick)
            vals, ids = cuda_topk.mask_invalid(vals, ids)
            out_vals[start : start + nvalid] = vals.cpu().numpy()
            out_ids[start : start + nvalid] = ids.cpu().numpy()
        return TopKResult(entities=out_ids, scores=out_vals)
