"""The port's serving engines (skge_torch/serving.py) against the JAX
package's, on the JAX package's params carried over, on the CPU.

Top-k ids must be equal (ties toward the lower entity id, `lax.top_k`'s
rule, also across stream chunks and where k exceeds the eligible
entities); scores are the engines' fp32 outputs of fp64 models and agree
to 1e-7 relative (an fp32 rounding). The quantizers are bit-equal to the
JAX package's, and the quantized engines equal its quantized engines.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import serving as jserving
from skge_tpu.models import MODELS as JMODELS
from skge_torch import serving
from skge_torch.models import MODELS as TMODELS
from skge_torch.parallel import Mesh, ShardGroup

torch.set_num_threads(1)

N_E, N_R, D = 64, 6, 16
NQ = 11
# tests/test_serving.py's models
MODEL_NAMES = ["transe", "transe_l2", "hole", "rescal", "ermlp", "distmult",
               "transh", "transr", "tucker"]


def models(name, dtype="float64", n_e=N_E):
    kw = {"dtype": dtype}
    if name == "transe_l2":
        name, kw["l1"] = "transe", False
    return JMODELS[name](n_e, N_R, D, **kw), TMODELS[name](n_e, N_R, D, **kw)


def host_params(jm, seed=0):
    return {k: np.asarray(v) for k, v in jm.init_params(jax.random.PRNGKey(seed)).items()}


def on_jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def queries(seed=3, n=NQ, n_e=N_E):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n_e, n), rng.integers(0, N_R, n)],
                    axis=1).astype(np.int32)


def known_triples(seed=17, n=100, n_e=N_E):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n_e, n), rng.integers(0, n_e, n),
                     rng.integers(0, N_R, n)], axis=1).astype(np.int32)


def same(got, want, rtol=1e-7):
    np.testing.assert_array_equal(got.entities, want.entities)
    np.testing.assert_allclose(got.scores, want.scores, rtol=rtol, atol=0)


@pytest.mark.parametrize("direction", ["o", "s"])
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_engines_match_jax(name, direction):
    jm, tm = models(name)
    params = host_params(jm)
    known = known_triples()
    q = queries()
    jpred = jserving.LinkPredictor(jm, on_jax(params), known=known, batch_size=4)
    tpred = serving.LinkPredictor(tm, params, known=known, batch_size=4, device="cpu")
    tstream = serving.StreamedLinkPredictor(tm, params, known=known, batch_size=5,
                                            chunk=23, device="cpu")
    for filtered in (False, True):
        want = jpred.top_k(q, 7, direction=direction, filtered=filtered)
        same(tpred.top_k(q, 7, direction=direction, filtered=filtered), want)
        same(tstream.top_k(q, 7, direction=direction, filtered=filtered), want)


@pytest.mark.parametrize("name", ["transe", "rescal", "ermlp"])
def test_streamed_matches_jax_streamed(name):
    jm, tm = models(name)
    params = host_params(jm, seed=2)
    known = known_triples(seed=5)
    q = queries(seed=19)
    jpred = jserving.StreamedLinkPredictor(jm, params, known=known, batch_size=5,
                                           chunk=23)
    tpred = serving.StreamedLinkPredictor(tm, params, known=known, batch_size=5,
                                          chunk=23, device="cpu")
    assert tpred.bytes_uploaded == 0
    for direction in ("o", "s"):
        same(tpred.top_k(q, 8, direction=direction),
             jpred.top_k(q, 8, direction=direction))
    # 3 chunks of the 64x16 fp64 table a batch, 3 batches, 2 directions
    assert tpred.bytes_uploaded == 2 * 3 * N_E * D * 8


@pytest.mark.parametrize("quantize", ["int8", "fp8"])
def test_quantizers_bit_equal_jax(quantize):
    rng = np.random.default_rng(11)
    table = (rng.normal(size=(2000, 150)) * rng.uniform(0.01, 3.0, (2000, 1))
             ).astype(np.float32)
    table[7] = 0.0  # an all-zero row: scale 1e-30
    fn = {"int8": (jserving.quantize_table_int8, serving.quantize_table_int8),
          "fp8": (jserving.quantize_table_fp8, serving.quantize_table_fp8)}[quantize]
    want, got = fn[0](table), fn[1](table)
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    assert got["scale"].dtype == torch.float32
    if quantize == "int8":
        assert got["q"].dtype == torch.int8
        np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    else:
        assert got["q"].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(got["q"].view(torch.uint8).numpy(),
                                      np.asarray(want["q"]).view(np.uint8))


@pytest.mark.parametrize("quantize", ["int8", "fp8", "bfloat16"])
@pytest.mark.parametrize("name", ["distmult", "transe_l2"])
def test_quantized_engines_match_jax(name, quantize):
    jm, tm = models(name, dtype="float32")  # fp32: the production dtype
    params = host_params(jm, seed=4)
    q = queries(seed=5)
    known = known_triples(seed=6)
    want = jserving.LinkPredictor(jm, on_jax(params), known=known,
                                  quantize=quantize).top_k(q, 10)
    got = serving.LinkPredictor(tm, params, known=known, quantize=quantize,
                                device="cpu").top_k(q, 10)
    same(got, want, rtol=1e-5)
    jstream = jserving.StreamedLinkPredictor(jm, params, known=known, chunk=17,
                                             quantize=quantize).top_k(q, 10)
    tstream = serving.StreamedLinkPredictor(tm, params, known=known, chunk=17,
                                            quantize=quantize, device="cpu").top_k(q, 10)
    same(tstream, jstream, rtol=1e-5)
    same(tstream, got, rtol=1e-5)


def test_score_triples_and_top_k_candidates_match_jax():
    jm, tm = models("hole")
    params = host_params(jm, seed=8)
    rng = np.random.default_rng(23)
    triples = known_triples(seed=23, n=9)
    want = jserving.LinkPredictor(jm, on_jax(params)).score_triples(triples)
    got = serving.LinkPredictor(tm, params, device="cpu").score_triples(triples)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    q = queries(seed=int(rng.integers(100)))
    known = known_triples(seed=29)
    for kn in (None, known):
        same(serving.top_k_candidates(tm, params, q, 6, "s", known=kn, device="cpu"),
             jserving.top_k_candidates(jm, on_jax(params), q, 6, "s", known=kn))


def tied_params(jm):
    """DistMult with entities in groups of identical rows: scores tie
    exactly within each group."""
    params = host_params(jm, seed=12)
    groups = np.arange(N_E) % 5
    params["E"] = params["E"][groups * 3]
    return params


@pytest.mark.parametrize("k", [3, 7, 13, N_E])
def test_ties_break_toward_the_lower_id(k):
    """Tied scores at the k-th place, tied groups spread over stream chunks
    of 10, and (k = n_e, filtered) more slots than eligible entities: -1,
    -inf."""
    jm, tm = models("distmult")
    params = tied_params(jm)
    q = queries(seed=31)
    known = known_triples(seed=37, n=300)
    jpred = jserving.LinkPredictor(jm, on_jax(params), known=known)
    tpred = serving.LinkPredictor(tm, params, known=known, device="cpu")
    tstream = serving.StreamedLinkPredictor(tm, params, known=known, chunk=10,
                                            device="cpu")
    for direction in ("o", "s"):
        for filtered in (False, True):
            want = jpred.top_k(q, k, direction=direction, filtered=filtered)
            same(tpred.top_k(q, k, direction=direction, filtered=filtered), want)
            same(tstream.top_k(q, k, direction=direction, filtered=filtered), want)
            if filtered and k == N_E:
                assert (want.entities == -1).any()
                assert np.isneginf(want.scores[want.entities == -1]).all()


def test_top_k_rule_against_a_stable_sort():
    """`_top_k` on integer-valued scores with many ties equals a stable
    descending sort's first k columns."""
    rng = np.random.default_rng(41)
    scores = torch.as_tensor(rng.integers(0, 6, (50, 40)).astype(np.float64))
    for k in (1, 5, 17, 40):
        vals, pos = serving._top_k(scores, k)
        want_vals, want_pos = torch.sort(scores, dim=1, descending=True, stable=True)
        assert torch.equal(pos, want_pos[:, :k])
        assert torch.equal(vals, want_vals[:, :k])


def test_mesh_and_missing_gpu_refused():
    jm, tm = models("transe")
    params = host_params(jm)
    # the candidate-sharded engine needs a model axis that divides n_e
    cpu = torch.device("cpu")
    mesh = Mesh(shape={"data": 1, "model": N_E + 1}, data=ShardGroup(None, 0, 1, cpu),
                model=ShardGroup(None, 0, N_E + 1, cpu), rank=0, device=cpu)
    with pytest.raises(ValueError, match="not divisible"):
        serving.LinkPredictor(tm, params, mesh=mesh)
    with pytest.raises(ValueError, match="unknown quantize"):
        serving.LinkPredictor(tm, params, quantize="int4", device="cpu")
    if not torch.cuda.is_available():
        for engine in (serving.LinkPredictor, serving.StreamedLinkPredictor):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                engine(tm, params)
