"""ctypes bindings of the native triple-file loader
(`native/src/tripleloader.cpp`) and entity partitioner
(`native/src/partitioner.cpp`).

The C++ sources are shared with the JAX package; the port compiles its own
library from both with g++ into `build/skge_torch/`, at first use, and
binds it here. When no toolchain is available, `load_triple_files` and
`greedy_partition` return None, and `data.load_tsv` and
`data.greedy_entity_partition` run in Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCES = tuple(ROOT / "native" / "src" / f
                for f in ("tripleloader.cpp", "partitioner.cpp"))
LIBRARY = ROOT / "build" / "skge_torch" / "libskge_native.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _build() -> None:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIBRARY.parent)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                        *map(str, SOURCES)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIBRARY)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _ensure_lib() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if (not LIBRARY.exists()
                    or max(f.stat().st_mtime for f in SOURCES)
                    > LIBRARY.stat().st_mtime):
                _build()
            lib = ctypes.CDLL(str(LIBRARY))
        except (OSError, subprocess.SubprocessError):
            _failed = True
            return None
        lib.tl_load.restype = ctypes.c_void_p
        lib.tl_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.tl_error.restype = ctypes.c_char_p
        lib.tl_error.argtypes = [ctypes.c_void_p]
        for fn in ("tl_n_triples", "tl_n_entities", "tl_n_relations", "tl_n_files"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.tl_file_n_triples.restype = ctypes.c_int64
        lib.tl_file_n_triples.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tl_copy_triples.restype = None
        lib.tl_copy_triples.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        for fn in ("tl_entity_name", "tl_relation_name"):
            getattr(lib, fn).restype = ctypes.c_char_p
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tl_free.restype = None
        lib.tl_free.argtypes = [ctypes.c_void_p]
        lib.skge_greedy_partition.restype = ctypes.c_int
        lib.skge_greedy_partition.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _ensure_lib() is not None


def load_triple_files(paths, order: str = "spo"):
    """Parse raw triple text files with one shared vocabulary.

    Returns (splits, entities, relations): one (N_i, 3) int32 (s, o, p)
    array per path, and the entity and relation names in id order. Raises
    RuntimeError on a parse error, FileNotFoundError on a missing file;
    returns None when the library cannot be built.
    """
    lib = _ensure_lib()
    if lib is None:
        return None
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    h = lib.tl_load("\n".join(map(str, paths)).encode(), order.encode())
    try:
        err = lib.tl_error(h).decode()
        if err:
            raise RuntimeError(f"tripleloader: {err} ({paths})")
        flat = np.empty((lib.tl_n_triples(h), 3), np.int32)
        lib.tl_copy_triples(h, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        splits, off = [], 0
        for i in range(lib.tl_n_files(h)):
            cnt = lib.tl_file_n_triples(h, i)
            splits.append(flat[off:off + cnt])
            off += cnt
        entities = [lib.tl_entity_name(h, i).decode() for i in range(lib.tl_n_entities(h))]
        relations = [lib.tl_relation_name(h, i).decode()
                     for i in range(lib.tl_n_relations(h))]
        return splits, entities, relations
    finally:
        lib.tl_free(h)


def greedy_partition(triples, n_entities: int, n_parts: int):
    """The native entity partitioner, bit-identical to
    `data.greedy_entity_partition`'s Python reference: (n_entities,) int32
    part ids, or None when the library cannot be built."""
    lib = _ensure_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(np.asarray(triples, np.int32))
    if t.ndim != 2 or t.shape[1] != 3:
        raise ValueError(f"triples must be (N, 3), got {t.shape}")
    out = np.empty(int(n_entities), np.int32)
    rc = lib.skge_greedy_partition(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(t.shape[0]), ctypes.c_int32(int(n_entities)),
        ctypes.c_int32(int(n_parts)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc:
        raise ValueError(f"skge_greedy_partition failed (code {rc}): check entity "
                         "ids are in [0, n_entities)")
    return out
