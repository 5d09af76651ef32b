"""Checkpoints of the port, in the JAX package's npz layout.

A checkpoint is one `.npz`, written atomically (a temporary file, then a
rename), holding the whole training state:

    params::<name>         parameter tables
    opt::<name>::<slot>    optimizer slots (AdaGrad's p2; Adam's m, v, t)
    step                   the global step, an int32 scalar
    key                    a JAX PRNG key (uint32 (2,)) made from the
                           generator's initial seed
    meta_json              JSON metadata as uint8 bytes
    torch_generator        the port's generator state (uint8)
    torch_generator_device the generator's device type ("cpu" or "cuda")

`skge_tpu.utils.checkpoint.load_checkpoint` reads only the first five, so
it loads a file of the port; JAX's draws then continue from `key`, not from
the port's generator. `load_checkpoint` here loads a file of either package:
params, optimizer slots and step come across exactly. The generator state
is restored when the file holds one for the same device type; otherwise
(a JAX file, or a file saved on another device type) the generator is a
fresh one, seeded from the metadata's config seed (0 without one) and the
step, so the draws differ from an uninterrupted run.

`save_sharded_checkpoint` / `load_sharded_checkpoint` write and read the
JAX package's per-shard directory (`manifest.json`, `replicated.npz`,
`shard_{i:05d}.npz`) for the partitioned trainer: each rank writes and
reads only its own rows, whatever the saving run's shard count.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from skge_torch.training import TrainState

_SEP = "::"  # flat key separator inside the npz


def _flatten(prefix: str, tree) -> Dict[str, np.ndarray]:
    """Flatten a nested dict of tensors to 'a::b::c' keys of host arrays."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(f"{prefix}{_SEP}{k}" if prefix else k, v))
    else:
        out[prefix] = tree.detach().cpu().numpy()
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _jax_key(seed: int) -> np.ndarray:
    """The raw uint32 data of `jax.random.PRNGKey(seed)` (threefry)."""
    seed &= (1 << 64) - 1
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _snapshot_arrays(state: TrainState, meta: Optional[Dict[str, Any]]):
    """Host copies of the whole state: once taken, training may go on."""
    arrays = {}
    arrays.update(_flatten("params", state.params))
    arrays.update(_flatten("opt", state.opt_state))
    gen = state.generator
    arrays["key"] = _jax_key(gen.initial_seed())
    arrays["step"] = np.asarray(int(state.step), np.int32)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta or {}).encode(), np.uint8)
    arrays["torch_generator"] = gen.get_state().numpy()
    arrays["torch_generator_device"] = np.asarray(gen.device.type)
    return arrays


def _write_npz_atomic(path: str, arrays: Dict[str, np.ndarray]) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(
    path: str, state: TrainState, meta: Optional[Dict[str, Any]] = None
) -> None:
    """Atomic write of the whole training state."""
    _write_npz_atomic(path, _snapshot_arrays(state, meta))


class AsyncCheckpointer:
    """Overlap the npz write with training: `save()` takes the host
    snapshot at once and writes it on a background thread. A new `save()`
    first waits for the previous write, so at most one snapshot is in
    flight and checkpoints land in order. A write error is raised by the
    next `save()` or `wait()`. Use as a context manager or call `wait()`."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state: TrainState,
             meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        arrays = _snapshot_arrays(state, meta)

        def write() -> None:
            try:
                _write_npz_atomic(path, arrays)
            except BaseException as e:  # raised by the next save()/wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="skge-ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight, if any, ends; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()


def load_checkpoint(path: str, device) -> Tuple[TrainState, Dict[str, Any]]:
    """(state on `device`, metadata) from a checkpoint of either package."""
    device = torch.device(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("meta_json").tobytes()).decode() or "{}")
    step = int(flat.pop("step"))
    flat.pop("key")
    gen_state = flat.pop("torch_generator", None)
    gen_device = flat.pop("torch_generator_device", None)
    tree = _unflatten(flat)

    def on_device(node):
        if isinstance(node, dict):
            return {k: on_device(v) for k, v in node.items()}
        return torch.as_tensor(np.array(node, copy=True), device=device)

    generator = torch.Generator(device=device)
    if gen_state is not None and str(gen_device) == device.type:
        generator.set_state(torch.as_tensor(gen_state, dtype=torch.uint8))
    else:
        seed = int(meta.get("config", {}).get("seed", 0))
        mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
        generator.manual_seed(int(mixed) & ((1 << 63) - 1))
    params = on_device(tree.get("params", {}))
    opt_state = on_device(tree.get("opt", {}))
    for name in params:  # a stateless optimizer's slots leave no member
        opt_state.setdefault(name, {})
    state = TrainState(
        params=params,
        opt_state=opt_state,
        generator=generator,
        step=step,
    )
    return state, meta


def save_sharded_checkpoint(
    dirpath: str, state: TrainState, meta: Optional[Dict[str, Any]] = None, *,
    group, sharded: Tuple[str, ...],
) -> None:
    """Per-shard checkpoint in the JAX package's layout, with no full table
    on any one process:

        dirpath/manifest.json      n_shards, per-leaf row extents, meta
        dirpath/replicated.npz     key, step, the replicated leaves and the
                                   port's generator state (rank 0)
        dirpath/shard_{i:05d}.npz  rank i's rows of every sharded leaf

    `state` is this rank's part (`parallel.partitioned`'s placement);
    `sharded` names the params whose rows are split over `group` (a
    `ShardGroup`), their optimizer slots with them. The manifest is written
    last, after every rank's shard file, and marks the checkpoint whole.
    """
    os.makedirs(dirpath, exist_ok=True)
    flat = {}
    flat.update(_flatten("params", state.params))
    flat.update(_flatten("opt", state.opt_state))
    is_sharded = {name: name.split(_SEP)[1] in sharded for name in flat}
    local = {n: v for n, v in flat.items() if is_sharded[n]}
    _write_npz_atomic(os.path.join(dirpath, f"shard_{group.rank:05d}.npz"), local)
    group.barrier()
    if group.rank == 0:
        shapes, rows = {}, {}
        for name, v in flat.items():
            shape = list(v.shape)
            if is_sharded[name]:
                rows[name] = int(v.shape[0])
                shape[0] *= group.size
            shapes[name] = shape
        rep = {n: v for n, v in flat.items() if not is_sharded[n]}
        gen = state.generator
        rep["key"] = _jax_key(gen.initial_seed())
        rep["step"] = np.asarray(int(state.step), np.int32)
        rep["torch_generator"] = gen.get_state().numpy()
        rep["torch_generator_device"] = np.asarray(gen.device.type)
        _write_npz_atomic(os.path.join(dirpath, "replicated.npz"), rep)
        manifest = {"n_shards": group.size, "sharded_rows": rows, "shapes": shapes,
                    "meta": meta or {}}
        tmp = os.path.join(dirpath, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(dirpath, "manifest.json"))
    group.barrier()


def load_sharded_checkpoint(
    dirpath: str, group, sharded: Optional[Tuple[str, ...]] = None, seed: int = 0,
) -> Tuple[TrainState, Dict[str, Any]]:
    """(this rank's state on `group.device`, meta) from a
    `save_sharded_checkpoint` directory of either package, whatever its
    shard count: each sharded leaf's global rows are cut into
    `group.size` equal ranges and this rank reads only its own, from the
    shard files that cover it. `sharded`, when given, must match the
    manifest. The generator state is restored when the files hold one for
    this device type; otherwise it is fresh, seeded from `seed` and the
    step."""
    with open(os.path.join(dirpath, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(dirpath, "replicated.npz")) as z:
        replicated = {k: z[k] for k in z.files}
    step = int(replicated.pop("step"))
    replicated.pop("key")
    gen_state = replicated.pop("torch_generator", None)
    gen_device = replicated.pop("torch_generator_device", None)
    saved_rows = manifest["sharded_rows"]
    if sharded is not None:
        found = {n.split(_SEP)[1] for n in saved_rows}
        if found != set(sharded):
            raise ValueError(f"checkpoint shards {sorted(found)}, expected {sorted(sharded)}")
    dev = group.device
    files: Dict[int, Any] = {}

    def leaf(name):
        shape = tuple(manifest["shapes"][name])
        if name in replicated:
            return torch.as_tensor(np.array(replicated[name], copy=True), device=dev)
        if shape[0] % group.size:
            raise ValueError(f"{name}: {shape[0]} rows do not split over "
                             f"{group.size} ranks")
        s_new, s_old = shape[0] // group.size, saved_rows[name]
        start, stop = group.rank * s_new, (group.rank + 1) * s_new
        parts = []
        for sid in range(start // s_old, (stop - 1) // s_old + 1):
            if sid not in files:
                files[sid] = np.load(os.path.join(dirpath, f"shard_{sid:05d}.npz"))
            lo, hi = max(start - sid * s_old, 0), min(stop - sid * s_old, s_old)
            parts.append(files[sid][name][lo:hi])
        return torch.as_tensor(np.concatenate(parts), device=dev)

    try:
        tree = _unflatten({n: leaf(n) for n in sorted(manifest["shapes"])})
    finally:
        for z in files.values():
            z.close()
    generator = torch.Generator(device=dev)
    if gen_state is not None and str(gen_device) == dev.type:
        generator.set_state(torch.as_tensor(gen_state, dtype=torch.uint8))
    else:
        mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
        generator.manual_seed(int(mixed) & ((1 << 63) - 1))
    params = tree.get("params", {})
    opt_state = tree.get("opt", {})
    for name in params:  # a stateless optimizer's slots leave no member
        opt_state.setdefault(name, {})
    return (TrainState(params=params, opt_state=opt_state, generator=generator,
                       step=step),
            manifest.get("meta", {}))
