"""The port's partition helpers against the JAX package's, exactly:
`greedy_entity_partition` on both backends (the native C++ partitioner
bound by `skge_torch.native`, and the Python reference), `partition_edges`
and `relabel_entities` (`skge_torch.parallel.partitioned`). The out-of-core
checkpoints carry a CRC of `new_of_old`, so both packages must agree bit
for bit.

The JAX package builds its native library with `make` straight into
`native/build/`, so a parallel test worker can load a half-written file;
its module then gives up on the library for the life of the process.
`load_jax_native` retries the load before the native comparison.
"""

import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import skge_tpu.native as jnative
from skge_tpu import data as jdata
from skge_tpu.parallel import partitioned as jpartitioned
from skge_torch import data as tdata
from skge_torch import native as tnative
from skge_torch.parallel import relabel_entities

N_E = 150


NATIVE_WAIT_S = 60


def graph(clustered):
    return jdata.synthetic_kg(N_E, 5, 700, seed=4, clustered=clustered)


def load_jax_native(monkeypatch, wait_s=NATIVE_WAIT_S):
    """Load the JAX package's native library, retrying for up to `wait_s`
    seconds: a failed load (another process still writing the file) sets
    the module's `_build_failed` for good, so each retry first resets it
    and `_lib`. Fails the test with the reason when it never loads."""
    deadline = time.monotonic() + wait_s
    while not jnative.native_available():
        if time.monotonic() > deadline:
            pytest.fail(f"the JAX package's native library {jnative._LIB_PATH} "
                        f"did not load within {wait_s} s")
        time.sleep(0.2)
        monkeypatch.setattr(jnative, "_build_failed", False)
        monkeypatch.setattr(jnative, "_lib", None)


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4])
@pytest.mark.parametrize("clustered", [False, True], ids=["plain", "clustered"])
@pytest.mark.parametrize("backend", ["python", "native"])
def test_greedy_partition_equals_jax(backend, clustered, n_parts, monkeypatch):
    if backend == "native":
        load_jax_native(monkeypatch)
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



# one process of `test_concurrent_native_loads_all_succeed`: the JAX
# package's native module loaded by path (no JAX), pointed at a fresh copy
# of native/, and loaded with `load_jax_native`'s retries
_LOADER = textwrap.dedent("""
    import importlib.util, sys, time
    import numpy as np
    spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._NATIVE_DIR = sys.argv[2]
    mod._LIB_PATH = sys.argv[2] + "/build/libtripleloader.so"
    deadline = time.monotonic() + float(sys.argv[3])
    while not mod.native_available():
        if time.monotonic() > deadline:
            sys.exit("native library did not load")
        time.sleep(0.2)
        mod._build_failed, mod._lib = False, None
    t = np.array([[0, 1, 0], [1, 2, 0], [2, 3, 0], [3, 0, 0]], np.int32)
    print(sorted(mod.greedy_partition(t, 4, 2).tolist()))
""")


def test_concurrent_native_loads_all_succeed(tmp_path):
    """Six processes load the JAX package's native library at once from an
    empty build directory (each racing the others' `make`); with the
    retries every one of them loads it and partitions."""
    native = tmp_path / "native"
    shutil.copytree(os.path.join(os.path.dirname(jnative.__file__), os.pardir, "native"),
                    native, ignore=shutil.ignore_patterns("build"))
    assert not (native / "build").exists()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOADER, jnative.__file__, str(native),
         str(NATIVE_WAIT_S)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)]
    outs = [p.communicate(timeout=NATIVE_WAIT_S + 60) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[0, 0, 1, 1]"
