"""Entity relabeling for partitioned tables, `skge_tpu.parallel.partitioned`'s
`relabel_entities`. The out-of-core trainer (`skge_torch.outofcore`) keeps
each part of the entity table in contiguous rows; the mesh trainer waits
for `torch.distributed`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def relabel_entities(
    triples: np.ndarray, entity_part: np.ndarray, n_parts: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Renumber entities so part p owns the contiguous rows [p*S, (p+1)*S).

    S = max part size; smaller parts leave unused padding rows. Returns
    (relabeled int32 triples, int64 new_of_old, n_padded = n_parts * S);
    raises when the padded id space overflows int32.
    """
    entity_part = np.asarray(entity_part)
    n_e = entity_part.shape[0]
    sizes = np.bincount(entity_part, minlength=n_parts)
    s = int(sizes.max())
    if n_parts * s >= 2**31:
        raise ValueError(
            f"relabeled id space n_parts*S = {n_parts}*{s} = "
            f"{n_parts * s} overflows int32; use more/better-balanced "
            "partitions"
        )
    order = np.argsort(entity_part, kind="stable")
    within = np.arange(n_e) - np.concatenate(
        [[0], np.cumsum(sizes)]
    )[entity_part[order]]
    new_of_old = np.empty(n_e, np.int64)
    new_of_old[order] = entity_part[order].astype(np.int64) * s + within
    t = np.asarray(triples)
    out = np.stack(
        [new_of_old[t[:, 0]], new_of_old[t[:, 1]], t[:, 2]], axis=1
    ).astype(np.int32)
    return out, new_of_old, n_parts * s
