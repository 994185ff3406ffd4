"""The mesh of shards and the path partition of the sharded engines.

Counterpart of ``gfasort_tpu/parallel/mesh.py``.  A :class:`Mesh` is
this process's ordered list of shard devices, plus the process group
when the run spans processes.  Shard ``g = rank * n_local + i`` (the
``i``-th local shard of process ``rank``) plays the part of the JAX
``axis_index``.  A device may appear more than once: several shards may
share one card (or the CPU), as the JAX tests run 8 virtual CPU devices.

The engines' only collective is :meth:`Mesh.all_reduce`: this process's
shards are added in shard order, starting from shard 0's own array (the
order XLA:CPU's ``psum`` adds its devices in, which also keeps the sign
of a zero), then ``torch.distributed.all_reduce`` adds the processes'
partial sums (NCCL on cuda, gloo on the CPU), whose order the backend
chooses.  Within one process a sharded run therefore equals the JAX
engine on the same number of shards bit for bit; across processes only
the order of the processes' partial sums may differ.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = [
    "Mesh",
    "default_mesh",
    "global_mesh",
    "init_distributed",
    "is_distributed",
    "partition_paths",
]


def _group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> None:
    """Start the default process group of a multi-process run.

    Arguments default to the ``GFASORT_COORDINATOR`` (``host:port``, or a
    ``tcp://`` URL), ``GFASORT_NUM_PROCESSES`` and ``GFASORT_PROCESS_ID``
    environment variables.  The backend is NCCL when ``device`` is a CUDA
    device and gloo on the CPU.  Safe to call more than once."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get(
        "GFASORT_COORDINATOR")
    if num_processes is None and "GFASORT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["GFASORT_NUM_PROCESSES"])
    if process_id is None and "GFASORT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["GFASORT_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number of "
            "processes and this process's id (or GFASORT_COORDINATOR, "
            "GFASORT_NUM_PROCESSES and GFASORT_PROCESS_ID)")
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        resolve_device(dev)     # raises when CUDA is absent
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=int(num_processes),
                            rank=int(process_id))


def is_distributed() -> bool:
    """True when this process is part of a process group of more than
    one process."""
    return _group_active() and dist.get_world_size() > 1


@dataclass(frozen=True)
class Mesh:
    """This process's shard devices, in shard order, and the process
    group (None: the mesh is this process alone)."""

    devices: tuple
    group: object = None

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over every process."""
        return self.n_local * self.world

    @property
    def shards(self) -> range:
        """The global indices of this process's shards."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    def all_reduce(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over every shard of the mesh, one tensor per local
        shard on that shard's device: the local shards' ``parts`` added
        in shard order from shard 0's own array, then the processes'
        partial sums added by the process group."""
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        if self.group is not None:
            if total is parts[0]:
                total = total.clone()
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        return [total.to(d) for d in self.devices]


def default_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards (over every process) on ``device``'s
    type.  With no process group: on cuda, every visible card, one shard
    each, by default; more shards than cards take the cards in turn; on
    the CPU, one shard by default.  In a process group, ``n_devices``
    (default: one per process) must be a multiple of the world size, and
    each process's shards share its own device (``cuda:rank`` modulo the
    visible cards, or the CPU).  Raises when CUDA is asked for and there
    is none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use cuda or cpu)")
    if _group_active():
        world, rank = dist.get_world_size(), dist.get_rank()
        n = world if n_devices is None else int(n_devices)
        if n < world or n % world:
            raise ValueError(f"{n} shards do not split over {world} processes")
        local = (torch.device("cuda", rank % torch.cuda.device_count())
                 if dev.type == "cuda" else torch.device("cpu"))
        return Mesh(tuple([local] * (n // world)), dist.group.WORLD)
    if dev.type == "cuda":
        cards = ([torch.device("cuda", dev.index)] if dev.index is not None
                 else [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())])
    else:
        cards = [torch.device("cpu")]
    n = len(cards) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(tuple(cards[i % len(cards)] for i in range(n)))


def global_mesh(device="cuda") -> Mesh:
    """The mesh over every process, one shard per process in a process
    group (alias of ``default_mesh(None, device)``, named for intent)."""
    return default_mesh(None, device)


def partition_paths(step_counts: Sequence[int], n_shards: int) -> List[List[int]]:
    """Greedy longest-processing-time assignment of paths to shards,
    balancing total step count.  Pairs never span shards because whole
    paths stay together (a term's two endpoints are always in the same
    path — src/sgd.rs:502-506)."""
    order = np.argsort(np.asarray(step_counts))[::-1]
    loads = [0] * n_shards
    shards: List[List[int]] = [[] for _ in range(n_shards)]
    for p in order.tolist():
        s = int(np.argmin(loads))
        shards[s].append(p)
        loads[s] += int(step_counts[p])
    return shards
