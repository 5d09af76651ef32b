"""The filter of known answers as a hand-written CUDA kernel: known
answers masked in the score tile, for serving and for the rankers.

`filter_known(scores, ent, rel, keys, offsets, answers, base, n_relations)`
sets scores[b, a - base] = NEG_INF (-1e30) for every known answer a of
query b (entity ent[b], relation rel[b]) that falls in the tile's columns
[base, base + C), in place. The known answers are a CSR index of one
direction (`skge_torch.data.known_csr`): `keys` the sorted distinct
ent * n_relations + rel, `answers[offsets[i]:offsets[i + 1]]` key i's
answers. A query whose entity or relation is out of range, or whose key is
not there, has no answers. Every other score is left as it was.

`base` and the tile's width place the tile among the entities: 0 and all
of them on one device, a rank's block on the sharded engine and ranking, a
chunk on the streamed engine, a part in the streamed ranking.

`filter_known` takes tensors on the card only (scores fp32 or fp64 and
contiguous, the ids int64) and raises on anything else; the kernel is
`csrc/filter_known.cu`. The index is checked once, where it is built
(`check_index`: keys and offsets int64, answers int32, all 1-D,
contiguous and on one device), not at every launch. It replaces no TPU
kernel. `filter_known_reference` is the plain PyTorch version, the route
off the card and the one the card tests hold the kernel to;
`known_pairs_reference` gives the (row, column) cells both mask.

Every ranker and engine filters through this module: `known_index` builds
and uploads the index of the directions asked for once, and `mask_known`
masks one tile, by the kernel on the card (which raises on a tile or ids it
does not take) and by the plain version off it. `LinkPredictor` and
`StreamedLinkPredictor` (serving.py), `FilteredRankingEval`
(evaluation.py) and `OutOfCoreTrainer.evaluate` (outofcore.py) call it.

`launches` counts the kernel's launches. Each launch also adds its count
of masked cells to an int64 on the card (`masked_pairs(device)`), for
tests that show the kernel did the work; serving never reads it, so it
costs no wait.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from skge_torch.data import known_csr
from skge_torch.ops import _build

NEG_INF = -1e30  # the kernel's kNegInf

Index = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (keys, offsets, answers)

launches = 0
_masked: Dict[int, torch.Tensor] = {}


def masked_pairs(device) -> torch.Tensor:
    """The int64 (1,) tensor on the card `device` to which every launch
    there adds the cells it masked. Reading its value waits for the card."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    counter = _masked.get(index)
    if counter is None:
        counter = _masked[index] = torch.zeros(1, dtype=torch.int64,
                                               device=torch.device("cuda", index))
    return counter


def known_pairs_reference(ent, rel, keys, offsets, answers, base: int, width: int,
                          n_relations: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, columns) of the cells `filter_known` masks in a (len(ent),
    width) tile whose first column is entity `base`: `searchsorted` for
    each query's key, `repeat_interleave` over the answers."""
    dev = ent.device
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if keys.numel() == 0 or ent.numel() == 0:
        return empty, empty
    valid = ((ent >= 0) & (rel >= 0) & (rel < n_relations)
             & (ent <= keys[-1] // n_relations))
    q = torch.where(valid, ent * n_relations + rel, -1)
    pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    hit = valid & (keys[pos] == q)
    lo = offsets[pos]
    count = torch.where(hit, offsets[pos + 1] - lo, 0)
    rows = torch.repeat_interleave(torch.arange(ent.numel(), device=dev), count)
    before = torch.cumsum(count, 0) - count  # the pairs of the rows above
    at = (torch.repeat_interleave(lo - before, count)
          + torch.arange(rows.numel(), device=dev))
    cols = answers[at].to(torch.int64) - base
    keep = (cols >= 0) & (cols < width)
    return rows[keep], cols[keep]


def filter_known_reference(scores, ent, rel, keys, offsets, answers, base: int,
                           n_relations: int) -> None:
    """Plain version of `filter_known`: the cells of `known_pairs_reference`
    set to NEG_INF by one indexed write."""
    rows, cols = known_pairs_reference(ent, rel, keys, offsets, answers, base,
                                       scores.shape[1], n_relations)
    scores.index_put_((rows, cols), torch.tensor(NEG_INF, dtype=scores.dtype,
                                                 device=scores.device))


def check_index(keys, offsets, answers) -> None:
    """Raises unless (keys, offsets, answers) is an index `filter_known`
    takes: 1-D contiguous tensors on one device, keys and offsets int64,
    answers int32, one more offset than keys."""
    for name, t, dtype in (("keys", keys, torch.int64), ("offsets", offsets, torch.int64),
                           ("answers", answers, torch.int32)):
        if t.device != keys.device or t.dtype != dtype or t.dim() != 1:
            raise ValueError(f"{name}: want a 1-D {dtype} tensor on {keys.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if offsets.shape[0] != keys.shape[0] + 1:
        raise ValueError(f"{keys.shape[0]} keys want {keys.shape[0] + 1} offsets, got "
                         f"{offsets.shape[0]}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("filter_known")
    if lib.skge_filter_known_f32.argtypes is None:
        for fn in (lib.skge_filter_known_f32, lib.skge_filter_known_f64):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 5 + [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
        lib.skge_cuda_error_string.argtypes = [ctypes.c_int]
        lib.skge_cuda_error_string.restype = ctypes.c_char_p
    return lib


def filter_known(scores, ent, rel, keys, offsets, answers, base: int,
                 n_relations: int) -> None:
    """NEG_INF at every known answer of each query inside the (B, C) tile
    `scores`, whose column j is entity base + j; in place, one launch. The
    index has passed `check_index` on the scores' card."""
    global launches
    if scores.device.type != "cuda":
        raise ValueError(f"filter_known runs on the card only, got {scores.device}")
    if scores.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernel takes fp32 or fp64 scores, got {scores.dtype}")
    if scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError(f"want contiguous (B, C) scores, got {tuple(scores.shape)}")
    b = scores.shape[0]
    for name, t in (("ent", ent), ("rel", rel)):
        if t.device != scores.device or t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name}: want a 1-D int64 tensor on {scores.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ent.shape[0] != b or rel.shape[0] != b:
        raise ValueError(f"{b} score rows but {ent.shape[0]} entities and {rel.shape[0]} "
                         "relations")
    if n_relations <= 0:
        raise ValueError(f"n_relations must be positive, got {n_relations}")
    if b == 0 or scores.shape[1] == 0:
        return
    lib = _lib()
    fn = lib.skge_filter_known_f32 if scores.dtype == torch.float32 else lib.skge_filter_known_f64
    with torch.cuda.device(scores.device):
        err = fn(scores.data_ptr(), ent.data_ptr(), rel.data_ptr(), keys.data_ptr(),
                 offsets.data_ptr(), answers.data_ptr(), b, scores.shape[1], keys.shape[0],
                 int(base), int(n_relations), masked_pairs(scores.device).data_ptr(),
                 torch.cuda.current_stream(scores.device).cuda_stream)
    if err != 0:
        raise RuntimeError("filter_known kernel launch failed: "
                           + lib.skge_cuda_error_string(err).decode())
    launches += 1


def known_index(known, n_relations: int, device,
                directions: Tuple[str, ...] = ("o", "s")) -> Dict[str, Index]:
    """{direction: (keys, offsets, answers)}: the CSR index (`known_csr`) of
    the (N, 3) (s, o, p) triples `known` for each of `directions`, (s, p) -> o
    under 'o' and (o, p) -> s under 's', put on `device` and checked
    (`check_index`) once."""
    index = {d: tuple(torch.from_numpy(a).to(device) for a in known_csr(known, n_relations, d))
             for d in directions}
    for keys, offsets, answers in index.values():
        check_index(keys, offsets, answers)
    return index


def mask_known(scores: torch.Tensor, ent, rel, index, base: int,
               n_relations: int) -> torch.Tensor:
    """`scores` (B, C), its column j entity base + j, with every known
    answer of query b (entity ent[b], relation rel[b]) set to NEG_INF, in
    place (on a contiguous copy where `scores` is not contiguous, which is
    returned). One `filter_known` launch on the card,
    `filter_known_reference` off it. `index` None leaves the scores as they
    are."""
    if index is None:
        return scores
    scores = scores.contiguous()
    (filter_known if scores.is_cuda else filter_known_reference)(
        scores, ent.contiguous(), rel.contiguous(), *index, base, n_relations)
    return scores
