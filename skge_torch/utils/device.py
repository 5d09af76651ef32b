"""Where the port's entry points run: on the card unless the caller asks
for the CPU, with no quiet fallback when there is no GPU."""

from __future__ import annotations

import torch


def resolve_device(device=None, verb: str = "trains") -> torch.device:
    """`device` as a `torch.device`, "cuda" when None. Raises RuntimeError
    for a CUDA device when no GPU is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: skge_torch {verb} on the GPU; pass "
                           "device='cpu' to run on the CPU")
    return dev
