"""The port's self-adversarial, pointwise and sampled-CE mesh steps and the
vocab-parallel full CE (`skge_torch.parallel.shardmap_step`) against the
JAX package's at (1, 1), (2, 2), (1, 4) and (4, 1), fp64 within 1e-9:
selfadv (TransE-L2, ER-MLP's dense params by scored-element counts),
pointwise on a pool (TransE, RESCAL's factored W, ER-MLP), sampled CE (sum
semantics with a duplicate pool id, the local-to-global rescale, Adam's
per-row `t` sharded with E, the unigram proposal with label smoothing and
`shard_relations`) and full CE (DistMult both directions; TransE objects
only with label smoothing and the normless1 constraint). The harness is
`test_torch_shardmap_steps.py`'s.
"""

import pytest
from test_torch_shardmap_steps import CASES, SHAPES, check_case, run_worlds, shape_key

NAMES = [n for n, c in CASES.items()
         if c[0] in ("selfadv", "pointwise", "sampled_ce", "ce")]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("shardmap_losses"), NAMES)


@pytest.mark.parametrize("shape", SHAPES, ids=shape_key)
@pytest.mark.parametrize("case", NAMES)
def test_loss_step_matches_jax(worlds, case, shape):
    check_case(worlds, shape, case)
