"""K6's share of its roofline in the traced training epoch of
`rotate_fb15k.pool256`, in %: the least time the card could take for the
epoch's K6 work over the device time of the kernels of
`csrc/rotate_pool.cu` (names holding `rotate_pool_`). The least time is the
larger of

- operations at the card's fp32 rate: the epoch's real triples x the
  corruption modes x the pool's k x `pair_flops(d, True)` of
  `models/rotate.py` (one pair's score and its gradient, recomputation not
  counted);
- bytes at its HBM rate: each step's three launches read their inputs and
  write their outputs once, the forward q (B, 2d), p (K, 2d) and S (B, K),
  dq q, p, G and dq, dp p, q, G and dp, B = modes x the batch.

The shapes come from the files of the one cell this reader knows,
`CELL`, since a span does not say which cell it came from. It reads
nothing unless the span's `model_flops`, which `drivers/train.py` computes from
the running cell's files, equal those of `CELL`'s files: a span of
another width, pool size, mode count, model or training set gives no
share. Nothing either when no K6 kernel ran, or the card has no peaks."""

from pathlib import Path

from kgebench import counts, registry

CELL = "rotate_fb15k.pool256"


def _files(root: Path):
    cell = registry.load_json(root / "cells" / f"{CELL}.json")
    cfg = registry.load_json(root / "configs" / f"{cell['config']}.json")
    traffic = registry.load_json(root / "traffic" / f"{cell['traffic']}.json")
    model = registry.load_module(root / "models" / f"{cfg['model']}.py", "kgebench_k6_model")
    return cfg, traffic, model


def model_flops(root: Path) -> float:
    """`drivers/train.py`'s `span.model_flops` for a traced epoch of `CELL`."""
    cfg, traffic, model = _files(root)
    return counts.train_flops(model, cfg, traffic, cfg["train"])


def work(root: Path):
    """(operations, bytes) of one epoch of the cell's K6 launches."""
    cfg, traffic, model = _files(root)
    d, k, modes = cfg["ncomp"], traffic["k"], len(traffic["modes"])
    flops = cfg["train"] * modes * k * model.pair_flops(d, True)
    b = modes * -(-cfg["train"] // cfg["nbatches"])
    q, p, s = b * 2 * d, k * 2 * d, b * k
    per_step = (q + p + s) + (2 * q + p + s) + (q + 2 * p + s)
    return flops, 4 * per_step * cfg["nbatches"]


def read(span):
    peaks = counts.peaks(span.card)
    busy = sum(b - a for name, a, b in span.kernels if "rotate_pool_" in name) * 1e-6
    root = Path(__file__).resolve().parents[1]
    if span.kind != "train" or peaks is None or busy <= 0 or span.model_flops != model_flops(root):
        return None
    flops, nbytes = work(root)
    least = max(flops / peaks["fp32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / busy
