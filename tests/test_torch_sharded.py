"""The port's single-device-equal mesh steps (`skge_torch.parallel.sharded`)
against the JAX package's GSPMD steps at (1, 1), (2, 2), (1, 4) and (4, 1),
fp64 within 1e-9: the generic expanded-pair pairwise route (TransE, HolE),
the fused iid and shared-pool (Adam) routes, the generic iid pointwise
route (HolE, ER-MLP's dense params) and the pool pointwise route (RESCAL),
and `make_sharded_score_all_o`'s (B/D, n_e) rows. The harness is
`test_torch_shardmap_steps.py`'s.

Without a world: `make_epoch_fn(pad_to=)`'s batches against JAX's with
JAX's permutation injected, a padded epoch's trajectory against the
unpadded one with an iid sampler, and the rejections of an indivisible
entity count and (with `shard_relations`) relation count.
"""

import numpy as np
import pytest
import torch
from test_torch_shardmap_steps import CASES, SHAPES, check_case, run_worlds, shape_key

import skge_torch
from skge_torch.parallel import distributed, mesh as tmesh
from skge_torch.parallel import sharded, shardmap_step as sm
from skge_torch.training import StepMetrics, init_state, make_epoch_fn

NAMES = [n for n, c in CASES.items() if c[0].startswith("sharded") or c[0] == "score_all_o"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("sharded"), NAMES)


@pytest.mark.parametrize("shape", SHAPES, ids=shape_key)
@pytest.mark.parametrize("case", NAMES)
def test_sharded_step_matches_jax(worlds, case, shape):
    check_case(worlds, shape, case)


@pytest.mark.parametrize("n, nb, pad_to", [(330, 4, 4), (330, 4, 3), (320, 4, 4),
                                           (17, 5, 2)])
def test_epoch_pad_to_matches_jax_batches(n, nb, pad_to):
    """Every batch padded with masked rows up to a multiple of `pad_to`,
    the real rows' membership unchanged: JAX's batches and masks, its
    permutation injected."""
    import jax
    import jax.numpy as jnp

    from skge_tpu.training import TrainState as JState
    from skge_tpu.training import make_epoch_fn as jax_epoch_fn

    xs = np.stack([np.arange(n), np.arange(n) * 7 % n, np.arange(n) % 5], axis=1)

    def record(state, batch, mask):
        return state, (batch, mask)

    key = jax.random.PRNGKey(3)
    jstate = JState({}, {}, key, jnp.zeros((), jnp.int32))
    _, (jb, jm) = jax.jit(jax_epoch_fn(record, n, nb, pad_to=pad_to))(
        jstate, jnp.asarray(xs, jnp.int32))
    perm = jax.random.permutation(jax.random.split(key)[1], n)

    seen = []

    def step(state, batch, mask, rows=None):
        seen.append((batch, mask, rows))
        return state, StepMetrics(loss=torch.zeros(()), nviolations=torch.zeros(()))

    epoch = make_epoch_fn(step, n, nb, pad_to=pad_to)
    epoch(None, torch.as_tensor(xs), perm=torch.as_tensor(np.array(perm)))
    bs = -(-n // nb)
    assert len(seen) == nb
    for b, (batch, mask, rows) in enumerate(seen):
        np.testing.assert_array_equal(batch.numpy(), np.asarray(jb[b]))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm[b]))
        assert batch.shape[0] % pad_to == 0
        assert rows == (None if bs % pad_to == 0 else bs)


@pytest.mark.parametrize("pointwise", [False, True], ids=["pairwise", "pointwise"])
def test_padded_epoch_equals_unpadded_with_iid_draws(pointwise):
    """`rows=` draws the iid negatives for the unpadded batch: an epoch
    padded to a multiple of 4 (and of 3) follows the pad_to=1 trajectory,
    on the fused and the generic route."""
    from skge_torch.data import synthetic_kg

    ds = synthetic_kg(40, 4, n_train=150, seed=1)  # batches of 38
    model = skge_torch.HolE(40, 4, 6, dtype="float64", rparam=0.01)
    sampler = skge_torch.RandomModeSampler(40)
    xs = torch.as_tensor(ds.train, dtype=torch.int64)
    assert -(-xs.shape[0] // 4) % 12 not in (0, 4, 8), "padding must be active"
    out = {}
    for pad_to in (1, 4, 3):
        opt = skge_torch.AdaGrad(lr=0.1)
        step = (skge_torch.make_pointwise_step(model, opt, sampler, "dense") if pointwise
                else skge_torch.make_pairwise_step(model, opt, sampler, 0.3, "dense"))
        state = init_state(model, opt, torch.Generator().manual_seed(2))
        epoch = make_epoch_fn(step, xs.shape[0], 4, pad_to=pad_to)
        for _ in range(2):
            state, m = epoch(state, xs)
        out[pad_to] = (state, m)
    for pad_to in (4, 3):
        np.testing.assert_array_equal(out[pad_to][1].nviolations, out[1][1].nviolations)
        np.testing.assert_allclose(out[pad_to][1].loss, out[1][1].loss, rtol=1e-12)
        for k, v in out[1][0].params.items():
            np.testing.assert_allclose(out[pad_to][0].params[k], v, rtol=1e-12, atol=1e-14)


def _fake_mesh(shape):
    """A mesh object for the checks that run before any collective."""
    cpu = torch.device("cpu")
    return tmesh.Mesh(shape={tmesh.DATA_AXIS: shape[0], tmesh.MODEL_AXIS: shape[1]},
                      data=distributed.ShardGroup(None, 0, shape[0], cpu),
                      model=distributed.ShardGroup(None, 0, shape[1], cpu), rank=0,
                      device=cpu)


class _Pool:
    modes = (0, 1)
    k = 4

    def pool(self, generator, pos, mask):
        return torch.zeros(4, dtype=torch.int64)


@pytest.mark.parametrize("build", [
    lambda m, mesh: sm.make_shardmap_pairwise_step(m, skge_torch.AdaGrad(), _Pool(), 1.0,
                                                   mesh),
    lambda m, mesh: sm.make_shardmap_selfadv_step(m, skge_torch.AdaGrad(), _Pool(), 1.0,
                                                  mesh),
    lambda m, mesh: sm.make_shardmap_ce_step(m, skge_torch.AdaGrad(), mesh),
    lambda m, mesh: sharded.make_sharded_score_all_o(m, mesh),
], ids=["pairwise", "selfadv", "ce", "score_all_o"])
def test_rejects_indivisible_entity_count(build):
    model = skge_torch.TransE(25, 4, 8)  # 25 rows over a model axis of 2
    with pytest.raises(ValueError, match="divisible"):
        build(model, _fake_mesh((2, 2)))


@pytest.mark.parametrize("model", [skge_torch.RESCAL(24, 5, 8), skge_torch.TransH(24, 5, 8)],
                         ids=["rescal", "transh"])
def test_shard_relations_rejects_indivisible_relation_count(model):
    mesh = _fake_mesh((4, 2))
    with pytest.raises(ValueError, match="not divisible"):
        sm.make_shardmap_pairwise_step(model, skge_torch.AdaGrad(), _Pool(), 0.5, mesh,
                                       shard_relations=True)
    sm.make_shardmap_pairwise_step(model, skge_torch.AdaGrad(), _Pool(), 0.5, mesh)


def test_shardmap_pointwise_rejects_iid_sampler():
    with pytest.raises(ValueError, match="shared-pool"):
        sm.make_shardmap_pointwise_step(skge_torch.TransE(24, 4, 8), skge_torch.AdaGrad(),
                                        skge_torch.RandomModeSampler(24), _fake_mesh((2, 1)))


class _CudaGenerator:
    """Stands for a generator on the card (this process may have none)."""
    device = torch.device("cuda", 0)


def test_shard_state_keeps_or_rejects_the_generator():
    model = skge_torch.TransE(24, 4, 8)
    opt = skge_torch.AdaGrad()
    gen = torch.Generator().manual_seed(5)
    torch.randint(0, 9, (7,), generator=gen)  # not at its start
    state = skge_torch.init_state(model, opt, torch.Generator().manual_seed(0))
    mesh = _fake_mesh((1, 2))
    kept = tmesh.shard_state(state._replace(generator=gen), model, mesh)
    assert kept.generator is gen  # its position, not a reseeded copy
    assert kept.params["E"].shape == (12, 8)
    with pytest.raises(ValueError, match="generator"):
        tmesh.shard_state(state._replace(generator=_CudaGenerator()), model, mesh)
