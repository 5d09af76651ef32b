"""Process-group bootstrap and host plumbing for the port's scale-out
trainers, `skge_tpu.parallel.distributed`'s counterpart on
`torch.distributed`.

One process owns one shard. On the card each process drives
`cuda:LOCAL_RANK` over NCCL; with `device="cpu"` the processes run on the
CPU over gloo (this is how the tests spawn their worlds). There is no
quiet fallback: asking for the card without a GPU raises.

- `initialize()`: idempotent `init_process_group`. It reads the JAX
  package's launch variables (`SKGE_COORDINATOR`, `SKGE_NUM_PROCESSES`,
  `SKGE_PROCESS_ID`) first, then torchrun's (`MASTER_ADDR`, `MASTER_PORT`,
  `WORLD_SIZE`, `RANK`, `LOCAL_RANK`). With none set it forms a world of
  one on an in-memory store. A coordinator address is `host:port` (TCP)
  or a `file://` path (a shared file store).
- `make_shard_mesh()`: the `ShardGroup` every partitioned function takes
  where the JAX package takes its 1-D `('shard',)` mesh: the process
  group, this process's rank, the world size and the device, with the
  collectives the partitioned step uses.
- `local_shard_ids`, `make_global_batches`, `host_replicate`,
  `sync_global_devices`: the JAX module's host helpers, for one shard per
  process.
- `launch_local()` / `python -m skge_torch.parallel.distributed -n P --
  CMD...`: P processes of one world on this host, joined through a file
  store by the SKGE_* variables, each with a time limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_ENV_COORD = "SKGE_COORDINATOR"
_ENV_NPROC = "SKGE_NUM_PROCESSES"
_ENV_PID = "SKGE_PROCESS_ID"

_device: Optional[torch.device] = None  # the device `initialize` chose
# newer torch renames the two tensor collectives; the same calls either way
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def _init_method(coord: str) -> str:
    return coord if coord.startswith(("tcp://", "file://", "env://")) else f"tcp://{coord}"


def launch_config(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_rank: Optional[int] = None,
) -> Tuple[Optional[str], int, int, int]:
    """(init method or None, world size, rank, local rank) from the
    arguments, else the SKGE_* variables, else torchrun's. None as the
    init method means a world of one on an in-memory store."""
    coord = coordinator_address or os.environ.get(_ENV_COORD)
    if coord is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coord = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    nproc = num_processes if num_processes is not None else _env_int(
        _ENV_NPROC, "WORLD_SIZE")
    pid = process_id if process_id is not None else _env_int(_ENV_PID, "RANK")
    nproc = 1 if nproc is None else nproc
    pid = 0 if pid is None else pid
    if not 0 <= pid < nproc:
        raise ValueError(f"process id {pid} outside a world of {nproc}")
    if nproc > 1 and coord is None:
        raise ValueError(f"a world of {nproc} processes needs a coordinator "
                         f"address ({_ENV_COORD} or MASTER_ADDR/MASTER_PORT)")
    lr = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
    if lr is None:
        ndev = torch.cuda.device_count() if torch.cuda.is_available() else 1
        lr = pid % max(ndev, 1)
    return (None if coord is None else _init_method(coord)), nproc, pid, lr


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_rank: Optional[int] = None,
    device=None,
    timeout_s: float = 600.0,
) -> bool:
    """Join (or form) the process group. Returns True when it spans more
    than one process. Idempotent: a second call returns the current mode.

    `device` None or "cuda" trains on `cuda:LOCAL_RANK` over NCCL and
    raises RuntimeError without a GPU; "cpu" runs over gloo.
    """
    global _device
    if dist.is_initialized():
        return dist.get_world_size() > 1
    init_method, nproc, pid, lr = launch_config(
        coordinator_address, num_processes, process_id, local_rank)
    want = torch.device("cuda" if device is None else device)
    if want.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the partitioned trainer runs on the "
                               "GPU over NCCL; pass device='cpu' (--cpu) for gloo")
        dev = torch.device("cuda", lr if want.index is None else want.index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif want.type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process group for device {want}")
    kw = dict(backend=backend, world_size=nproc, rank=pid,
              timeout=timedelta(seconds=timeout_s))
    if init_method is None:
        dist.init_process_group(store=dist.HashStore(), **kw)
    else:
        dist.init_process_group(init_method=init_method, **kw)
    _device = dev
    return nproc > 1


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


@dataclass(frozen=True)
class ShardGroup:
    """One shard per process: the group, this rank, the world size and the
    device, and the collectives of the partitioned step. Every rank calls
    each collective in the same order."""

    group: object
    rank: int
    size: int
    device: torch.device

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(P, *x.shape): every rank's `x`, in rank order."""
        flat = x.reshape(-1).contiguous()
        out = flat.new_empty(self.size * flat.shape[0])
        _ALL_GATHER(out, flat, group=self.group)
        return out.reshape((self.size,) + tuple(x.shape))

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction of every rank's `x` (a new tensor)."""
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def gather_rows(self, idx: torch.Tensor, s_rows: int,
                    read: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """Rows `idx` (global ids) of a table row-split over the group in
        blocks of `s_rows`, the same on every rank: each rank reads the rows
        it owns (`read(local ids)`), zeros elsewhere, and one all-reduce
        assembles them. The sum adds zeros to one owner's row, so the result
        is that row bit for bit."""
        local = idx - self.rank * s_rows
        own = (local >= 0) & (local < s_rows)
        rows = read(torch.clamp(local, 0, s_rows - 1))
        return self.all_reduce(torch.where(
            own.reshape(own.shape + (1,) * (rows.dim() - own.dim())), rows, 0))

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the ranks in place; `x` must be contiguous."""
        dist.all_reduce(x, group=self.group)
        return x

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Sum the (P*S, ...) `x` over the ranks; this rank's (S, ...) rows
        (the `psum_scatter(tiled=True)` counterpart)."""
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        _REDUCE_SCATTER(out, x, group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(P*T, ...) -> (P*T, ...): block q of `x` goes to rank q, block s
        of the result came from rank s."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_to_all_uneven(self, out: torch.Tensor, x: torch.Tensor,
                          out_splits: List[int], in_splits: List[int]) -> None:
        """`x`'s first `in_splits[q]` rows after the earlier blocks go to
        rank q; rank s's rows land in `out` after the earlier senders'."""
        dist.all_to_all_single(out, x.contiguous(), out_splits, in_splits,
                               group=self.group)

    def barrier(self) -> None:
        if self.size > 1:
            if self.device.type == "cuda":
                dist.barrier(group=self.group, device_ids=[self.device.index])
            else:
                dist.barrier(group=self.group)


def world_device() -> torch.device:
    """This process's device in the initialized world: the one `initialize`
    chose, else (a group made by the caller) the one its backend says."""
    if _device is not None:
        return _device
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def make_shard_mesh(device=None) -> ShardGroup:
    """The world as a `ShardGroup`, initializing it first when needed
    (`initialize(device=device)`)."""
    if not dist.is_initialized():
        initialize(device=device)
    return ShardGroup(group=dist.group.WORLD, rank=dist.get_rank(),
                      size=dist.get_world_size(), device=world_device())


def destroy() -> None:
    """Leave the process group (the next `initialize` forms a new one)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def local_shard_ids(group: ShardGroup) -> list:
    """The shards this process owns: its rank alone."""
    return [group.rank]


def make_global_batches(
    local_batches: np.ndarray, local_mask: np.ndarray, group: ShardGroup,
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """This process's (L, 3) int64 batch and (L,) mask on its device, from
    its own shard's rows only (`local_batches[0]` when given (1, L, 3))."""
    b = np.asarray(local_batches)
    m = np.asarray(local_mask)
    if b.ndim == 3:
        b, m = b[0], m[0]
    return (torch.as_tensor(b, dtype=torch.int64, device=group.device),
            torch.as_tensor(m, dtype=dtype, device=group.device))


def host_replicate(x: torch.Tensor, group: Optional[ShardGroup] = None) -> np.ndarray:
    """A full host copy of a row-sharded table from this rank's row block
    (all-gathered in rank order); with no group, or one rank, `x` itself."""
    if group is None or group.size == 1:
        return x.detach().cpu().numpy()
    g = group.all_gather(x.detach())
    return g.reshape((-1,) + tuple(x.shape[1:])).cpu().numpy()


def sync_global_devices(group: Optional[ShardGroup] = None) -> None:
    """Barrier across processes (a no-op in a world of one)."""
    if group is not None:
        group.barrier()
    elif is_distributed():
        dist.barrier()


def launch_local(argv: Sequence[str], n_processes: int, timeout_s: float,
                 store_dir: Optional[str] = None, env: Optional[dict] = None) -> list:
    """Run `argv` as `n_processes` processes of one world on this host and
    wait for all of them: each gets SKGE_COORDINATOR (a file store in
    `store_dir`, a new temporary directory by default),
    SKGE_NUM_PROCESSES and SKGE_PROCESS_ID. Past `timeout_s` every process still running
    is killed. Returns [(returncode, stdout, stderr)] in rank order; a
    killed process has returncode None."""
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="skge_world_") if own_dir else store_dir
    store = os.path.join(os.path.abspath(store_dir), "store")
    procs = []
    for rank in range(n_processes):
        e = dict(os.environ if env is None else env)
        e.update({_ENV_COORD: "file://" + store, _ENV_NPROC: str(n_processes),
                  _ENV_PID: str(rank)})
        procs.append(subprocess.Popen(list(argv), env=e, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            try:
                so, se = p.communicate(timeout=timeout_s)
                out.append((p.returncode, so, se))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                so, se = p.communicate()
                out.append((None, so, se + f"\nkilled after {timeout_s} s"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if own_dir:
            for f in os.listdir(store_dir):
                os.unlink(os.path.join(store_dir, f))
            os.rmdir(store_dir)
    while len(out) < len(procs):  # the ranks after a timeout
        p = procs[len(out)]
        so, se = p.communicate()
        out.append((None, so, se))
    return out


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run a command as N processes of one torch.distributed "
        "world on this host (SKGE_* variables, a file store)")
    ap.add_argument("-n", "--nproc", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    results = launch_local(cmd, args.nproc, args.timeout)
    for rank, (rc, so, se) in enumerate(results):
        sys.stdout.write(so)
        sys.stderr.write(se)
        if rc != 0:
            sys.stderr.write(f"rank {rank} exited with {rc}\n")
    return max((1 if rc is None else abs(rc)) for rc, _, _ in results)


__all__: Sequence[str] = (
    "launch_local", 
    "ShardGroup", "destroy", "host_replicate", "initialize", "is_distributed",
    "launch_config", "local_shard_ids", "make_global_batches", "make_shard_mesh",
    "sync_global_devices",
)


if __name__ == "__main__":
    sys.exit(_main())
