"""The multi-process runtime of the port: one rank a device.

Ported from quaff_tpu/parallel/distributed.py.  JAX's multi-controller
model (every host runs the same program and the global mesh spans every
device of every host) becomes PyTorch's idiom: one process, a rank, a
device.  A rank's device is cuda:(rank % torch.cuda.device_count()), or
the CPU when the caller asks for it ($QUAFF_TORCH_DEVICE=cpu); the process
group is NCCL between CUDA ranks and gloo on the CPU.  A world of one rank
needs no group: every collective below is then the identity.

init_distributed joins the group before any work (the counterpart of
jax.distributed.initialize); the group's timeout is finite, so a rank
whose peer died raises instead of waiting for ever.  is_primary picks the
rank that writes output, host_read_shard keeps the JAX package's
contiguous read blocks, and make_global_mesh lays the ranks out as the
(dp, mp) grid of quaff_tpu's global mesh.

global_array has no counterpart: each rank already holds its own shard,
and results come back to every rank through gather_floats, an all_gather
in rank order.
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import make_mesh

# How long a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT = timedelta(seconds=300)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group of `num_processes` ranks whose rank 0 listens
    on coordinator_address ("host:port"); a no-op for one process, as the
    JAX version is, unless `backend` is given ("nccl" or "gloo"), which
    opens a group even for one rank (on a free local port when no address
    is given).  The backend defaults to NCCL when $QUAFF_TORCH_DEVICE names
    a CUDA device and gloo otherwise; a CUDA rank binds
    cuda:(rank % device_count) first, so a rank that cannot reach its card
    fails here, before any work."""
    n = 1 if num_processes is None else int(num_processes)
    if n <= 1 and backend is None:
        return
    if dist.is_initialized():
        raise RuntimeError("init_distributed: a process group is already up")
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < n:
        raise ValueError(f"-procid {rank} is outside 0..{n - 1}")
    if coordinator_address is None:
        if n > 1:
            raise ValueError("-nprocs > 1 needs -coordinator <host:port>")
        coordinator_address = f"localhost:{_free_port()}"
    dev = resolve_device(None)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=n, rank=rank, timeout=timeout)


def shutdown_distributed() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple:
    """(rank, world size); (0, 1) when no group is up."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the rank that owns user-facing output (rank 0), and in a
    process with no group."""
    return world()[0] == 0


def rank_device(name=None) -> torch.device:
    """resolve_device, with a bare "cuda" bound to this rank's card."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", world()[0] % torch.cuda.device_count())
    return dev


def host_read_shard(reads: List, process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List:
    """This rank's block of the read list (contiguous blocks, matching the
    dp order of parallel/estep.py)."""
    rank, n = world()
    pid = rank if process_id is None else process_id
    n = n if num_processes is None else num_processes
    per = -(-len(reads) // n)
    return reads[pid * per : (pid + 1) * per]


@dataclass
class GlobalMesh:
    """The (dp, mp) grid of the world's ranks, quaff_tpu's global mesh with
    one rank in place of each device: rank r sits at (r // mp, r % mp).
    mp_group holds the ranks of this rank's dp row (its refs' peers),
    dp_group those of its mp column; both are None in a world of one."""

    rank: int
    dp: int
    mp: int
    dp_index: int
    mp_index: int
    dp_group: Optional[object] = None
    mp_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.dp * self.mp

    def chunks_of_rank(self, n_chunks: int) -> range:
        """The chunks this rank scores when n_chunks are dealt to the
        ranks in turn: chunk i goes to rank i % size."""
        return range(self.rank, n_chunks, self.size)


def make_global_mesh(mp: int = 1) -> GlobalMesh:
    """The (dp, mp) grid over every rank of the group; mp must divide the
    world (the CLI says so first).  Every rank builds every subgroup, as
    torch.distributed.new_group requires."""
    rank, n = world()
    grid = make_mesh(n, mp).ranks
    dp_group = mp_group = None
    if n > 1:
        for row in grid:
            g = dist.new_group([int(r) for r in row])
            if rank in row:
                mp_group = g
        for col in grid.T:
            g = dist.new_group([int(r) for r in col])
            if rank in col:
                dp_group = g
    return GlobalMesh(rank=rank, dp=grid.shape[0], mp=grid.shape[1],
                      dp_index=rank // mp, mp_index=rank % mp,
                      dp_group=dp_group, mp_group=mp_group)


_WALL_LOCK = threading.Lock()


def gather_floats(values, group=None) -> List[np.ndarray]:
    """all_gather of one float64 vector a rank, of any length: the vectors
    of the group's ranks in rank order, on every rank ([values] when no
    process group is up; a group of one rank still runs the collective).
    NCCL groups exchange them on this rank's card, gloo groups on the
    host.  A failed or timed-out collective raises.  The wall it takes adds
    to gather_floats.seconds, and each call to gather_floats.calls."""
    v = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
    if not dist.is_initialized():
        return [v]
    t0 = time.perf_counter()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    n = dist.get_world_size(group)
    length = torch.tensor([v.size], dtype=torch.int64, device=dev)
    lengths = [torch.empty_like(length) for _ in range(n)]
    dist.all_gather(lengths, length, group=group)
    sizes = [int(t.item()) for t in lengths]
    buf = torch.zeros(max(sizes), dtype=torch.float64, device=dev)
    buf[: v.size] = torch.from_numpy(v).to(dev)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    out = [p[:s].cpu().numpy() for p, s in zip(parts, sizes)]
    with _WALL_LOCK:
        gather_floats.seconds += time.perf_counter() - t0
        gather_floats.calls += 1
    return out


gather_floats.seconds = 0.0
gather_floats.calls = 0


def sum_in_rank_order(parts) -> np.ndarray:
    """Gathered float64 vectors of one length summed in rank order,
    ((v0 + v1) + v2) + ...  Unlike all_reduce the order does not depend on
    the backend's algorithm, so every rank gets the same bits and the
    ranks' EM steps cannot drift apart."""
    total = np.array(parts[0], np.float64)
    for p in parts[1:]:
        if len(p) != total.size:
            raise RuntimeError("sum_in_rank_order: ranks sent vectors of "
                               f"{total.size} and {len(p)} values")
        total = total + p
    return total
