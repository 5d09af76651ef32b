"""One sampled cross-entropy step (`unique`, Adam, label smoothing 0.1)
of each factorization model in the port against the JAX package's, fp64
at 1e-9, as test_torch_factorization_steps.py holds the margin and full
cross-entropy steps (a file of its own keeps each under 20 s on the CPU).
"""

import pytest
import torch

from test_torch_factorization_steps import NAMES, step_matches_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("name", NAMES)
def test_sampled_ce_step_matches_jax(name):
    step_matches_jax(name, "sampled_ce")
