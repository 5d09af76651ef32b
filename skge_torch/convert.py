"""Carry weights and optimizer state between the JAX package and the port.

The JAX side hands over NumPy arrays (`jax.device_get` of its params or of
its whole `TrainState`); nothing here imports JAX. Random-generator state
does not carry over: JAX's threefry keys have no PyTorch counterpart, so the
port's state gets a fresh `torch.Generator`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from skge_torch.models.base import Params
from skge_torch.training import TrainState


def params_from_numpy(
    arrays: Mapping[str, np.ndarray], device
) -> Params:
    """{name: array} -> {name: tensor} on `device`, dtypes kept."""
    return {
        k: torch.as_tensor(np.array(v, copy=True), device=device)
        for k, v in arrays.items()
    }


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    """{name: tensor} -> {name: array} on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def state_from_numpy(state, device, seed: int = 0) -> TrainState:
    """A host copy of the JAX package's `TrainState` (anything with
    `params`, `opt_state` and `step`) -> the port's `TrainState`.

    Params, every optimizer slot (AdaGrad's `p2`) and the step carry over;
    the generator is a fresh one on `device`, seeded with `seed`.
    """
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt_state={
            k: params_from_numpy(slots, device)
            for k, slots in state.opt_state.items()
        },
        generator=generator,
        step=int(state.step),
    )
