"""The port's partitioned self-adversarial, sampled-CE and full-CE steps
against the JAX package's, at P=2 and P=4, fp64 within 1e-9: the first
two through the four gradient exchanges (dense, ragged, emulate and no
cap), full CE in both direction protocols (both directions; objects only
with label smoothing). The harness, the JAX side and the port's worker
are `test_torch_partitioned_steps.py`'s, in one gloo world per P.
"""

import pytest
from test_torch_partitioned_steps import (CE_CASES, EXCHANGES, LOSS_NAMES,
                                          check_exchange, run_world)


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request, tmp_path_factory):
    p = request.param
    return run_world(p, tmp_path_factory.mktemp(f"partitioned_losses_p{p}"), LOSS_NAMES)


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("case", ["selfadv", "sampled_ce"])
def test_step_matches_jax(world, case, exchange):
    check_exchange(world, case, exchange)


@pytest.mark.parametrize("case", list(CE_CASES))
def test_ce_step_matches_jax(world, case):
    check_exchange(world, case, "dense")
