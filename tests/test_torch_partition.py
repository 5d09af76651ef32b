"""The port's partition helpers against the JAX package's, exactly:
`greedy_entity_partition` on both backends (the native C++ partitioner
bound by `skge_torch.native`, and the Python reference), `partition_edges`
and `relabel_entities` (`skge_torch.parallel.partitioned`). The out-of-core
checkpoints carry a CRC of `new_of_old`, so both packages must agree bit
for bit.
"""

import numpy as np
import pytest

from skge_tpu import data as jdata
from skge_tpu.parallel import partitioned as jpartitioned
from skge_torch import data as tdata
from skge_torch import native as tnative
from skge_torch.parallel import relabel_entities

N_E = 150


def graph(clustered):
    return jdata.synthetic_kg(N_E, 5, 700, seed=4, clustered=clustered)


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4])
@pytest.mark.parametrize("clustered", [False, True], ids=["plain", "clustered"])
@pytest.mark.parametrize("backend", ["python", "native"])
def test_greedy_partition_equals_jax(backend, clustered, n_parts):
    t = graph(clustered).train
    want = jdata.greedy_entity_partition(t, N_E, n_parts, backend=backend)
    got = tdata.greedy_entity_partition(t, N_E, n_parts, backend=backend)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_native_and_python_backends_agree_and_auto_is_native():
    t = graph(True).train
    native = tdata.greedy_entity_partition(t, N_E, 3, backend="native")
    np.testing.assert_array_equal(
        native, tdata.greedy_entity_partition(t, N_E, 3, backend="python"))
    np.testing.assert_array_equal(native, tdata.greedy_entity_partition(t, N_E, 3))
    assert tnative.native_available()
    with pytest.raises(ValueError, match="unknown backend"):
        tdata.greedy_entity_partition(t, N_E, 3, backend="metis")
    with pytest.raises(ValueError, match="entity ids"):
        tnative.greedy_partition(t, 10, 3)  # ids beyond n_entities


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4])
def test_partition_edges_and_relabel_equal_jax(n_parts):
    t = graph(True).train
    part = jdata.greedy_entity_partition(t, N_E, n_parts)
    jb, jm, js = jdata.partition_edges(t, part, n_parts)
    tb, tm, ts = tdata.partition_edges(t, part, n_parts)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tm, jm)
    assert tb.dtype == jb.dtype and tm.dtype == jm.dtype
    np.testing.assert_array_equal(ts["counts"], js["counts"])
    assert (ts["balance"], ts["object_locality"]) == (js["balance"], js["object_locality"])
    jr, jnew, jpad = jpartitioned.relabel_entities(t, part, n_parts)
    tr, tnew, tpad = relabel_entities(t, part, n_parts)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tnew, jnew)
    assert tr.dtype == jr.dtype and tnew.dtype == jnew.dtype and tpad == jpad

