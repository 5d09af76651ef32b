"""Out-of-core (PyTorch-BigGraph style) bucketed training of the port:
entity tables beyond device memory, `skge_tpu.outofcore`'s counterpart.

1. Entities are partitioned into P parts (`data.greedy_entity_partition`)
   and relabeled so part p owns the contiguous rows [p*S, (p+1)*S)
   (`parallel.partitioned.relabel_entities`);
2. triples are grouped into buckets (part(subject), part(object));
3. the entity table and each of its optimizer slots live in pinned host
   memory; one bucket at a time, the one or two parts it touches are on
   the device, the port's step runs an epoch over the bucket's triples
   (negatives drawn from the RESIDENT parts, as in PBG), and the updated
   rows are copied back when their part leaves the device. The device
   holds up to `cache_parts` parts, the bucket's 2S rows and the relation
   tables, whatever the entity count.

Within a bucket the update is the in-core step's (`training`), built on a
model of S (diagonal bucket) or 2S (off-diagonal) entity rows: at P=1 the
trajectory is the in-core `make_epoch_fn` run's. The JAX package passes
the resident parts' real row counts to its sampler through a masked
sentinel row appended to every minibatch; the port runs eagerly, reads
them from `part_counts` as host ints, and appends no row.

Copies to the device are `non_blocking` from pinned memory. A prefetch
(into a free cache slot only) runs on a copy stream and the bucket that
uses the part waits on its event; a part leaving the device is copied
back on the compute stream, and an upload of that part on the copy stream
waits on the copy-back's event. `flush()` (called by `fit`, `params`,
`save` and `evaluate`) copies every cached part back and waits, so the
host table is read only when it is current.

Every entry point runs on the card unless the caller asks for the CPU
(`device="cpu"`); without a GPU it raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import zlib
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from skge_torch.data import greedy_entity_partition, rows_with_keys
from skge_torch.evaluation import RankingResult, ranking_scores
from skge_torch.models.base import KGEModel
from skge_torch.ops.cuda_filter import known_index, mask_known
from skge_torch.optim import Optimizer
from skge_torch.parallel.partitioned import relabel_entities
from skge_torch.trainer import LOSSES
from skge_torch.training import (StepMetrics, TrainState, apply_gradients,
                                 make_ce_step, make_pairwise_step,
                                 make_pointwise_step, make_selfadv_step,
                                 sampled_ce_grads_shared)
from skge_torch.utils.checkpoint import _jax_key, _write_npz_atomic
from skge_torch.utils.device import resolve_device


@dataclass(eq=False)
class BucketPoolSampler:
    """Shared-negative pool drawn from the bucket's RESIDENT entity rows.

    Rows [0, size_i) are part i's real entities, rows [slot_stride,
    slot_stride + size_j) part j's (slot_stride = S for an off-diagonal
    bucket, 0 for a diagonal one, which has one slot). Draws land
    uniformly on the real rows, never on padding rows. The trainer sets
    `sizes` = (size_i, size_j) before each bucket.
    """

    slot_stride: int  # 0 for diagonal buckets (single slot)
    k: int = 1024
    modes: Tuple[int, ...] = (0, 1)
    sizes: Tuple[int, int] = (0, 0)

    @property
    def n_resident(self) -> int:
        """The resident real rows the pool is drawn from."""
        return self.sizes[0] + (self.sizes[1] if self.slot_stride else 0)

    def pool(self, generator: torch.Generator, pos: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        u = torch.randint(0, self.n_resident, (self.k,), generator=generator,
                          device=generator.device)
        if not self.slot_stride:
            return u
        size_i = self.sizes[0]
        return torch.where(u < size_i, u, u - size_i + self.slot_stride)


def make_bucket_epoch(step_fn, length: int, nbatches: int):
    """Epoch over ONE bucket's triple list, `training.make_epoch_fn`'s
    structure and draws with a per-row `valid` input (buckets are padded
    to a common length, as in the JAX package).

    `epoch(state, xs, valid, perm=None)`: xs (length, 3) int64, valid
    (length,) float32; `perm` replaces the generator's permutation.
    """
    batch_size = -(-length // nbatches)
    padded = nbatches * batch_size

    def epoch(state: TrainState, xs: torch.Tensor, valid: torch.Tensor,
              perm: Optional[torch.Tensor] = None):
        if perm is None:
            perm = torch.randperm(length, generator=state.generator,
                                  device=xs.device)
        perm = perm.to(xs.device)
        pad_idx = torch.cat([perm, perm.new_zeros(padded - length)])
        masks = ((torch.arange(padded, device=xs.device) < length).to(torch.float32)
                 * valid[pad_idx]).reshape(nbatches, batch_size)
        batches = xs[pad_idx.reshape(nbatches, batch_size)]
        metrics = []
        for b in range(nbatches):
            state, m = step_fn(state, batches[b], masks[b])
            metrics.append(m)
        return state, StepMetrics(
            loss=torch.stack([m.loss for m in metrics]),
            nviolations=torch.stack([m.nviolations for m in metrics]),
        )

    return epoch


def choose_ce_loss(n_parts: int):
    """The JAX package's measured rule for CE-style training out of core:
    'ce' (full CE over the resident candidates) at P <= 2, 'sampled_ce' at
    P >= 3. Returns (loss_name, report); the report carries the rule and
    the MRR numbers of the JAX package's A/B (`scripts/ooc_ce_ab.py`),
    which decided it."""
    rule = "resident CE at P<=2; sampled-CE at P>=3 (measured A/B)"
    report = {
        "n_parts": int(n_parts),
        "rule": rule,
        "ab_mrr": {"full_ce_single": 0.2047, "resident_ce_P2": 0.2162,
                   "resident_ce_P4": 0.2014, "sampled_ce_P4": 0.2115},
    }
    return ("ce" if n_parts <= 2 else "sampled_ce"), report


class OutOfCoreTrainer:
    """PBG-style bucketed trainer over a host-resident entity table.

    `model` is at FULL size (n_entities = all entities); `opt` a row-sparse
    optimizer (AdaGrad, SGD, Adam); `n_parts` the partitions P (the device
    holds 2 * ceil-ish(n_e / P) entity rows per bucket); `k` the shared
    pool per step. Losses: 'margin' (pairwise, or pointwise logistic with
    `pairwise=False`), 'selfadv', 'ce' (full CE over the resident
    candidates), 'sampled_ce' (over a pool drawn from the resident parts,
    log q = -log(resident real rows)) and 'auto_ce' (`choose_ce_loss`).
    `prefetch` (needs `cache_parts` > 2 for a free slot) starts the next
    bucket's missing part upload right after the current bucket is issued.
    `host_buckets` keeps the bucket triples in pinned host memory and
    uploads them per visit.
    """

    def __init__(
        self,
        model: KGEModel,
        opt: Optimizer,
        triples: np.ndarray,
        n_parts: int,
        margin: float = 1.0,
        k: int = 1024,
        nbatches: int = 100,
        aggregate: str = "dense",
        seed: int = 0,
        cache_parts: int = 2,
        pairwise: bool = True,
        prefetch: bool = True,
        loss: str = "margin",
        adv_alpha: float = 1.0,
        ce_directions=("o", "s"),
        label_smoothing: float = 0.0,
        host_buckets: bool = False,
        device=None,
    ):
        if cache_parts < 2:
            raise ValueError("off-diagonal buckets need cache_parts >= 2")
        self.device = dev = resolve_device(device)
        self.full_model = model
        self.opt = opt
        self.margin = margin
        self.aggregate = aggregate
        self.pairwise = pairwise
        self.loss_report = None
        if loss == "auto_ce":
            loss, self.loss_report = choose_ce_loss(n_parts)
        if loss not in LOSSES:
            raise ValueError(f"unknown out-of-core loss {loss!r}")
        self.loss = loss
        self.adv_alpha = adv_alpha
        self.ce_directions = tuple(ce_directions)
        self.label_smoothing = float(label_smoothing)
        self.prefetch = prefetch
        self.seed = seed
        t = np.asarray(triples, np.int32)

        part = (greedy_entity_partition(t, model.n_entities, n_parts, seed=seed)
                if n_parts > 1 else np.zeros(model.n_entities, np.int32))
        relabeled, self.new_of_old, n_padded = relabel_entities(t, part, n_parts)
        s = n_padded // n_parts
        self.part_size = s            # padded rows per part
        self.n_parts = n_parts
        self.part_counts = np.bincount(part, minlength=n_parts)

        # bucket (pi, pj) -> its triples in their order: one stable sort by
        # bucket id (P^2 masks over every triple cost minutes at 10^8 rows)
        bucket_id = ((relabeled[:, 0] // s).astype(np.int64) * n_parts
                     + relabeled[:, 1] // s).astype(np.min_scalar_type(n_parts ** 2 - 1))
        sizes = np.bincount(bucket_id, minlength=n_parts * n_parts)
        grouped = np.split(relabeled[np.argsort(bucket_id, kind="stable")],
                           np.cumsum(sizes)[:-1])
        self.buckets: Dict[Tuple[int, int], np.ndarray] = {
            divmod(b, n_parts): rows for b, rows in enumerate(grouped) if len(rows)}
        self.bucket_len = max(r.shape[0] for r in self.buckets.values())
        # every bucket in slot-local int32 ids, as the JAX package stores
        # them, padded to one length (one upload)
        nb_buckets = len(self.buckets)
        all_local = np.zeros((nb_buckets, self.bucket_len, 3), np.int32)
        all_valid = np.zeros((nb_buckets, self.bucket_len), np.float32)
        self._bucket_row: Dict[Tuple[int, int], int] = {}
        for bi, ((pi, pj), rows) in enumerate(self.buckets.items()):
            local = rows.copy()
            local[:, 0] -= pi * s
            local[:, 1] -= pj * s
            if pi != pj:
                local[:, 1] += s
            n = local.shape[0]
            all_local[bi, :n] = local
            all_local[bi, n:] = local[0]
            all_valid[bi, :n] = 1.0
            self._bucket_row[(pi, pj)] = bi
        self.host_buckets = bool(host_buckets)
        self._all_local = self._host_or_device(torch.from_numpy(all_local))
        self._all_valid = self._host_or_device(torch.from_numpy(all_valid))
        self.nbatches = nbatches
        self.k = k

        # the padded entity table and its slots, drawn on the CPU, pinned;
        # on the CPU the same generator then drives the training draws, so
        # P=1 is the in-core `init_state` + `make_epoch_fn` run
        init_gen = torch.Generator().manual_seed(seed)
        padded_model = replace(model, n_entities=n_parts * s)
        params = padded_model.init_params(init_gen)
        ostate = opt.init(params)
        # each table is pinned, then its unpinned copy dropped: the host's
        # peak holds one table twice, not all of them
        self.e_host = {"param": self._pinned(params.pop("E"))}
        for name in list(ostate["E"]):
            self.e_host[name] = self._pinned(ostate["E"].pop(name))
        del ostate["E"]
        self.dev_params = {kk: v.to(dev) for kk, v in params.items() if kk != "E"}
        self.dev_opt = {kk: {n: a.to(dev) for n, a in v.items()}
                        for kk, v in ostate.items() if kk != "E"}
        self.generator = (init_gen if dev.type == "cpu"
                          else torch.Generator(device=dev).manual_seed(seed))
        self.step = 0
        self.cache_parts = cache_parts
        self._cache: Dict[int, Dict[str, torch.Tensor]] = {}
        self._lru: list = []
        self._ready: Dict[int, torch.cuda.Event] = {}  # prefetched part -> copy done
        self._d2h: Dict[int, torch.cuda.Event] = {}    # evicted part -> copy-back done
        self._copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.uploads = 0          # host->device part uploads (cache misses)
        self.bytes_uploaded = 0   # entity rows and slots, host->device
        self.bytes_downloaded = 0
        self._samplers = {diag: BucketPoolSampler(slot_stride=0 if diag else s, k=k)
                          for diag in (True, False)}
        self._epochs: Dict[bool, object] = {}
        self._metrics: list = []

    # -- host memory --
    def _pinned(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().to("cpu").contiguous()
        return t.pin_memory() if self.device.type == "cuda" else t

    def _host_or_device(self, t: torch.Tensor) -> torch.Tensor:
        return self._pinned(t) if self.host_buckets else t.to(self.device)

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A device copy of the host slice `t` (a new tensor on the CPU)."""
        if self.device.type == "cpu":
            return t.clone()
        return t.to(self.device, non_blocking=True)

    # -- the device program per bucket kind (diagonal / off-diagonal) --
    def _epoch_fn(self, diag: bool):
        if diag not in self._epochs:
            rows = self.part_size * (1 if diag else 2)
            bucket_model = replace(self.full_model, n_entities=rows)
            sampler = self._samplers[diag]
            opt, agg = self.opt, self.aggregate
            if self.loss == "ce":
                step = make_ce_step(bucket_model, opt, self.ce_directions,
                                    self.label_smoothing)
            elif self.loss == "sampled_ce":
                step = self._sampled_ce_step(bucket_model, sampler)
            elif self.loss == "selfadv":
                step = make_selfadv_step(bucket_model, opt, sampler, self.margin,
                                         self.adv_alpha, agg)
            elif self.pairwise:
                # eager: a bucket's returned tables stay cached across the
                # next buckets' steps, which a graphed step would overwrite
                step = make_pairwise_step(bucket_model, opt, sampler, self.margin,
                                          aggregate=agg, graphs=False)
            else:
                step = make_pointwise_step(bucket_model, opt, sampler, agg)
            nb = max(1, min(self.nbatches, self.bucket_len))
            self._epochs[diag] = make_bucket_epoch(step, self.bucket_len, nb)
        return self._epochs[diag]

    def _sampled_ce_step(self, bucket_model: KGEModel, sampler: BucketPoolSampler):
        """`training.make_sampled_ce_step` over the resident pool, with the
        candidate domain the resident real rows: log q = -log(n_resident),
        which is also the label-smoothing denominator."""
        opt, aggregate = self.opt, self.aggregate
        directions, ls = self.ce_directions, self.label_smoothing

        def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor):
            pool_idx = sampler.pool(state.generator, batch, mask)
            loss, occ, g_dense = sampled_ce_grads_shared(
                bucket_model, state.params, batch, pool_idx, mask, directions, ls,
                n_domain=sampler.n_resident,
            )
            params, opt_state = apply_gradients(
                bucket_model, opt, state.params, state.opt_state, occ, g_dense,
                aggregate, premasked=True, step=state.step, combine="sum",
            )
            return (TrainState(params, opt_state, state.generator, state.step + 1),
                    StepMetrics(loss=loss, nviolations=torch.zeros_like(loss)))

        return step

    # -- the device part cache: up to `cache_parts` parts stay on the device
    # between buckets; the chained bucket order (_bucket_order) makes most
    # transitions cost at most one upload; parts go back to the host only
    # when evicted and at flush() --
    def _fetch_part(self, p: int, prefetch: bool = False):
        if p in self._cache:
            self._lru.remove(p)
            self._lru.append(p)
            return self._cache[p]
        while len(self._cache) >= self.cache_parts:
            self._evict(self._lru.pop(0))
        s = self.part_size
        stream = self._copy_stream if prefetch else None
        ctx = contextlib.nullcontext()
        if stream is not None:
            if p in self._d2h:
                stream.wait_event(self._d2h[p])
            ctx = torch.cuda.stream(stream)
        with ctx:
            dev = {kk: self._to_device(v[p * s : (p + 1) * s])
                   for kk, v in self.e_host.items()}
        if stream is not None:
            ev = torch.cuda.Event()
            ev.record(stream)
            self._ready[p] = ev
        self.uploads += 1
        self.bytes_uploaded += sum(t.numel() * t.element_size() for t in dev.values())
        self._cache[p] = dev
        self._lru.append(p)
        return dev

    def _await(self, p: int) -> None:
        """Make the compute stream wait for part p's prefetch, if any."""
        ev = self._ready.pop(p, None)
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in self._cache[p].values():
                t.record_stream(cur)

    def _evict(self, p: int) -> None:
        self._await(p)
        dev = self._cache.pop(p)
        s = self.part_size
        for kk, v in dev.items():
            self.e_host[kk][p * s : (p + 1) * s].copy_(v, non_blocking=True)
            self.bytes_downloaded += v.numel() * v.element_size()
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._d2h[p] = ev

    def flush(self) -> None:
        """Copy every cached part back to the host table and wait for it."""
        for p in list(self._cache):
            self._evict(p)
        self._lru.clear()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._d2h.clear()

    def _bucket_epoch(self, pi: int, pj: int, perm: Optional[torch.Tensor] = None):
        s = self.part_size
        diag = pi == pj
        bi = self._bucket_row[(pi, pj)]
        local, valid = self._all_local[bi], self._all_valid[bi]
        if self.host_buckets:
            local, valid = self._to_device(local), self._to_device(valid)
        local = local.long()
        # refresh the LRU slot of parts already resident FIRST, so fetching
        # the other part never evicts the shared one
        for p in dict.fromkeys((pi, pj)):
            if p in self._cache:
                self._fetch_part(p)
        di = self._fetch_part(pi)
        dj = di if diag else self._fetch_part(pj)
        for p in dict.fromkeys((pi, pj)):
            self._await(p)
        e_dev = di if diag else {kk: torch.cat([di[kk], dj[kk]]) for kk in di}
        params = dict(self.dev_params)
        params["E"] = e_dev["param"]
        ostate = dict(self.dev_opt)
        ostate["E"] = {kk: v for kk, v in e_dev.items() if kk != "param"}
        sampler = self._samplers[diag]
        sampler.sizes = (int(self.part_counts[pi]), int(self.part_counts[pj]))
        state = TrainState(params, ostate, self.generator, self.step)
        state, m = self._epoch_fn(diag)(state, local, valid, perm)
        self.step = state.step
        e_new = dict(state.opt_state["E"])
        e_new["param"] = state.params["E"]
        if diag:
            self._cache[pi] = e_new
        else:  # own copies, so the bucket's 2S table is freed
            self._cache[pi] = {kk: v[:s].clone() for kk, v in e_new.items()}
            self._cache[pj] = {kk: v[s:].clone() for kk, v in e_new.items()}
        self.dev_params = {kk: v for kk, v in state.params.items() if kk != "E"}
        self.dev_opt = {kk: v for kk, v in state.opt_state.items() if kk != "E"}
        return torch.sum(m.loss), torch.sum(m.nviolations)

    def _bucket_order(self):
        """Greedy chained order: each bucket shares a resident part with its
        predecessor whenever the bucket graph allows (PBG's ordering goal).
        Deterministic (sorted tie-breaks)."""
        remaining = sorted(self.buckets, key=lambda ij: (min(ij), max(ij), ij[0]))
        order = [remaining.pop(0)]
        while remaining:
            prev = set(order[-1])
            nxt = next((b for b in remaining if prev & set(b)), remaining[0])
            remaining.remove(nxt)
            order.append(nxt)
        return order

    def fit(self, epochs: int = 1, verbose: bool = False,
            buckets: Optional[int] = None) -> "OutOfCoreTrainer":
        """Run `epochs` passes; each visits every bucket once in the chained
        order, or only the first `buckets` of it (part of an epoch). The host
        syncs once per epoch, for the metrics record."""
        order = self._bucket_order()[:buckets]
        for ep in range(epochs):
            tot_loss = tot_viol = 0.0
            for b, (pi, pj) in enumerate(order):
                loss, nviol = self._bucket_epoch(pi, pj)
                # the next bucket's missing part, into a FREE slot only
                if self.prefetch:
                    for p in dict.fromkeys(order[(b + 1) % len(order)]):
                        if p not in self._cache and len(self._cache) < self.cache_parts:
                            self._fetch_part(p, prefetch=True)
                tot_loss = tot_loss + loss
                tot_viol = tot_viol + nviol
            loss, nviol = torch.stack([torch.as_tensor(tot_loss).double(),
                                       torch.as_tensor(tot_viol).double()]).tolist()
            self._metrics.append({"epoch": ep, "loss": loss, "nviolations": nviol})
            if verbose:
                print(self._metrics[-1], flush=True)
        self.flush()
        return self

    @property
    def metrics(self):
        return list(self._metrics)

    def _partition_crc(self) -> int:
        return int(zlib.crc32(np.ascontiguousarray(self.new_of_old)))

    def save(self, dirpath: str) -> "OutOfCoreTrainer":
        """Checkpoint in the JAX package's layout, never building a full-table
        copy: one `part_%05d.npz` per part (the entity rows and slots),
        `replicated.npz` (`params::`, `opt::`, `key`, `step`, and the
        port's `torch_generator`) and `manifest.json` with the partition's
        CRC and the metrics."""
        self.flush()
        os.makedirs(dirpath, exist_ok=True)
        s = self.part_size
        for p in range(self.n_parts):
            _write_npz_atomic(
                os.path.join(dirpath, f"part_{p:05d}.npz"),
                {kk: v[p * s : (p + 1) * s].numpy() for kk, v in self.e_host.items()},
            )
        rep = {f"params::{kk}": v.detach().cpu().numpy()
               for kk, v in self.dev_params.items()}
        for kk, slots in self.dev_opt.items():
            for sn, v in slots.items():
                rep[f"opt::{kk}::{sn}"] = v.detach().cpu().numpy()
        rep["key"] = _jax_key(self.seed)
        rep["step"] = np.asarray(self.step, np.int32)
        rep["torch_generator"] = self.generator.get_state().numpy()
        rep["torch_generator_device"] = np.asarray(self.generator.device.type)
        _write_npz_atomic(os.path.join(dirpath, "replicated.npz"), rep)
        meta = {"n_parts": self.n_parts, "part_size": s,
                "partition_crc": self._partition_crc(), "metrics": self._metrics}
        tmp = os.path.join(dirpath, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(dirpath, "manifest.json"))
        return self

    def restore(self, dirpath: str) -> "OutOfCoreTrainer":
        """Resume from a checkpoint of either package's `save`. The geometry
        and the partition must match. The generator state is restored when
        the file holds one for this device type; otherwise (a JAX file) the
        generator is a fresh one, seeded from the seed and the step."""
        with open(os.path.join(dirpath, "manifest.json")) as f:
            meta = json.load(f)
        if (meta["n_parts"], meta["part_size"]) != (self.n_parts, self.part_size):
            raise ValueError(
                f"checkpoint geometry {meta['n_parts']}x{meta['part_size']} "
                f"!= trainer {self.n_parts}x{self.part_size}")
        if meta.get("partition_crc", self._partition_crc()) != self._partition_crc():
            raise ValueError(
                "checkpoint was saved with a DIFFERENT entity partition "
                "(other triples/seed): restoring would map rows to wrong "
                "entities; rebuild the trainer with the saving run's "
                "triples and seed")
        self.flush()
        self._cache.clear()
        s = self.part_size
        for p in range(self.n_parts):
            with np.load(os.path.join(dirpath, f"part_{p:05d}.npz")) as z:
                for kk in z.files:
                    self.e_host[kk][p * s : (p + 1) * s] = torch.from_numpy(z[kk])
        dev = self.device
        with np.load(os.path.join(dirpath, "replicated.npz")) as z:
            self.dev_params = {k.split("::", 1)[1]: torch.as_tensor(z[k], device=dev)
                               for k in z.files if k.startswith("params::")}
            self.dev_opt = {}
            for k in z.files:
                if k.startswith("opt::"):
                    _, pname, sn = k.split("::")
                    self.dev_opt.setdefault(pname, {})[sn] = torch.as_tensor(
                        z[k], device=dev)
            self.step = int(z["step"])
            gen = torch.Generator(device=dev)
            if ("torch_generator" in z.files
                    and str(z["torch_generator_device"]) == dev.type):
                gen.set_state(torch.as_tensor(z["torch_generator"], dtype=torch.uint8))
            else:
                mixed = np.random.SeedSequence([self.seed, self.step]).generate_state(
                    1, np.uint64)[0]
                gen.manual_seed(int(mixed) & ((1 << 63) - 1))
            self.generator = gen
        for kk in self.dev_params:
            self.dev_opt.setdefault(kk, {})
        self._metrics = list(meta.get("metrics", []))
        return self

    @torch.no_grad()
    def evaluate(
        self,
        test: np.ndarray,
        known: Optional[np.ndarray] = None,
        batch_size: int = 512,
        hits_at: Tuple[int, ...] = (1, 3, 10),
        ties: str = "mean",
        reciprocal: bool = False,
    ) -> RankingResult:
        """Streamed filtered ranking over the HOST-resident table: candidates
        arrive one PART at a time (the device holds one (S, d) slice and a
        (B, S) score block, never the full table), and ranks accumulate as
        running greater/equal counts against the target's score, which is
        taken from the same streamed score blocks. Each part's block gives
        its raw counts, is then masked in place by
        `ops/cuda_filter.mask_known` (the known answers of the block's
        entities; one `filter_known` launch on the card) and gives its
        filtered counts.

        The rank integers are the in-core `evaluation.evaluate`'s wherever
        no candidate's score lies within rounding of the target's. Mean and
        optimistic ties, as the in-core evaluator. `reciprocal=True` ranks
        head queries (s, o, p) as object queries (o, s, inv p) of a model
        trained on `data.add_reciprocal_relations`, as
        `evaluation.ReciprocalEvalWrapper` does.
        """
        if ties not in ("mean", "optimistic"):
            raise ValueError(f"ties must be 'mean'/'optimistic': {ties!r}")
        self.flush()
        model = self.full_model
        dev = self.device
        epname = next(pn for _, pn, r in model.slot_spec() if r == "s")
        e_tab = self.e_host["param"]
        s_rows = self.part_size
        nmap = self.new_of_old

        def remap(t):
            t = np.asarray(t, np.int64)
            return np.stack([nmap[t[:, 0]], nmap[t[:, 1]], t[:, 2]], axis=1)

        if reciprocal and model.n_relations % 2 != 0:
            raise ValueError(
                "reciprocal eval expects the DOUBLED relation count "
                "(data.add_reciprocal_relations)")
        half = model.n_relations // 2
        n_rel = model.n_relations
        test_rel = remap(test)
        # the filter index over the known triples whose (s, p) or (o, p) key
        # a query asks for (the ranks read no other), in remapped ids
        known = test if known is None else known
        index = known_index(remap(rows_with_keys(known, test, 0)), n_rel, dev, ("o",))
        known_s = remap(rows_with_keys(known, test, 1))
        if reciprocal:

            def inv(t):
                out = t.copy()
                out[:, 0], out[:, 1] = t[:, 1], t[:, 0]
                out[:, 2] = np.where(t[:, 2] < half, t[:, 2] + half, t[:, 2] - half)
                return out

            # the filter set {(o, inv p) -> objects} of the inverse-rewritten
            # known triples is the native {(o, p) -> subjects}
            index["s"] = known_index(inv(known_s), n_rel, dev, ("o",))["o"]
        else:
            index.update(known_index(known_s, n_rel, dev, ("s",)))

        n = len(test_rel)
        bs = int(min(batch_size, max(1, n)))
        nb = -(-n // bs)
        # (direction -> (queries (n, 3), pool mode, target column))
        specs = {"o": (test_rel, 1, 1),
                 "s": (inv(test_rel), 1, 1) if reciprocal else (test_rel, 0, 0)}
        dense = {kk: self.dev_params[kk] for kk in model.dense_param_names}

        def rows_of(q):
            out = {}
            for slot, pname, role in model.slot_spec():
                ids = q[:, {"s": 0, "o": 1, "p": 2}[role]]
                out[slot] = (e_tab[torch.from_numpy(ids)].to(dev) if pname == epname
                             else self.dev_params[pname][torch.as_tensor(ids, device=dev)])
            return out

        # per (direction, batch): query rows, targets (part, local row), and
        # the filter key's (entity, relation); uploaded once, reused over all
        # parts
        batches = {}
        for d, (q, mode, tcol) in specs.items():
            for b in range(nb):
                qb = q[b * bs : (b + 1) * bs]
                tids = qb[:, tcol]
                batches[d, b] = (rows_of(qb), mode,
                                 torch.as_tensor(tids // s_rows, device=dev),
                                 torch.as_tensor(tids % s_rows, device=dev),
                                 *(torch.as_tensor(qb[:, c], dtype=torch.int64, device=dev)
                                   for c in (0 if mode == 1 else 1, 2)))

        def parts():
            for p in range(self.n_parts):
                lo = p * s_rows
                yield p, self._to_device(e_tab[lo : lo + int(self.part_counts[p])])

        # pass 1: each target's score, from the streamed part blocks
        tgts = {}
        for p, cand in parts():
            for (d, b), (rows, mode, tpart, tloc, _, _) in batches.items():
                sc = model.score_pool(rows, cand, dense, mode)        # (B, S_p)
                inp = tpart == p
                got = sc[torch.arange(sc.shape[0], device=dev),
                         torch.where(inp, tloc, 0)]
                prev = tgts.get((d, b), torch.zeros_like(got))
                tgts[d, b] = prev + torch.where(inp, got, torch.zeros_like(got))

        # pass 2: greater/equal counts against the targets, raw, then with
        # the part's known answers masked
        acc = {}
        for p, cand in parts():
            for (d, b), (rows, mode, _, _, ent, rel) in batches.items():
                sc = model.score_pool(rows, cand, dense, mode)
                tgt = tgts[d, b][:, None]
                g, e = torch.sum(sc > tgt, dim=1), torch.sum(sc == tgt, dim=1)
                sc = mask_known(sc, ent, rel, index[d], p * s_rows, n_rel)
                gf, ef = torch.sum(sc > tgt, dim=1), torch.sum(sc == tgt, dim=1)
                a = acc.get((d, b))
                acc[d, b] = ((g, e, gf, ef) if a is None
                             else (a[0] + g, a[1] + e, a[2] + gf, a[3] + ef))

        results = {}
        for d in specs:
            ranks = np.zeros(n, np.float64)
            ranks_raw = np.zeros(n, np.float64)
            for b in range(nb):
                g, e, gf, ef = (x.cpu().numpy().astype(np.int64) for x in acc[d, b])
                if ties == "optimistic":
                    raw = 1.0 + g
                    filt = 1.0 + gf
                else:
                    raw = 1.0 + g + np.maximum(e - 1, 0) * 0.5
                    filt = 1.0 + gf + ef * 0.5
                lo, hi = b * bs, min((b + 1) * bs, n)
                ranks_raw[lo:hi] = raw
                ranks[lo:hi] = filt
            results[d] = (ranks, ranks_raw)
        all_filt = np.stack([results["o"][0], results["s"][0]])
        all_raw = np.stack([results["o"][1], results["s"][1]])
        mrr, mr, hits = ranking_scores(all_filt, hits_at)
        mrr_r, mr_r, hits_r = ranking_scores(all_raw, hits_at)
        return RankingResult(
            mrr=mrr, mrr_raw=mrr_r, mean_rank=mr, mean_rank_raw=mr_r,
            hits=hits, hits_raw=hits_r, ranks=all_filt, ranks_raw=all_raw,
            test=np.asarray(test, np.int32),
        )

    def params(self) -> Dict[str, np.ndarray]:
        """Full-size host params in ORIGINAL entity ids (for eval/save)."""
        self.flush()
        out = {kk: v.detach().cpu().numpy() for kk, v in self.dev_params.items()}
        out["E"] = self.e_host["param"].numpy()[self.new_of_old]
        return out
