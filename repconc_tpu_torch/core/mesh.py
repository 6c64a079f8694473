"""The data-parallel mesh (counterpart of repconc_tpu/core/mesh.py).

The JAX package's mesh is one SPMD program over every local chip of a
process. PyTorch runs one process per GPU: a `Mesh` here is this process's
place in the process group (its rank, the world size, its device), and
the data axis "dp" is the ranks. Without the env contract
(core/distributed.py) `create_mesh()` is a world-1 mesh over this
process's device, with no process group; a host with 8 cards takes 8
processes (torchrun --nproc_per_node 8, or the REPCONC_* env). A deviation
by design, listed in ROADMAP.md Queue 3.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repconc_tpu_torch.core import distributed
from repconc_tpu_torch.core.device import resolve_device

DATA_AXIS = "dp"


@dataclasses.dataclass
class Mesh:
    """One rank of a 1-D data-parallel mesh. group: the process group of
    the collectives, or None where there is none (a world-1 mesh without
    the env contract, or one rank's part run alone by `local_mesh`)."""

    group: Optional[Any]
    rank: int
    size: int
    device: torch.device
    axis_name: str = DATA_AXIS

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the shared artifacts."""
        return self.rank == 0

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n rows (n divides by size)."""
        return distributed.block(n, self.rank, self.size)


def collective_group(mesh: Optional[Mesh]):
    """The process group a data-parallel step reduces over: None for no
    mesh or a world-1 mesh without one; one rank of a larger mesh without
    a group raises (its step alone would be a part of the step)."""
    if mesh is None:
        return None
    if mesh.group is None and mesh.size > 1:
        raise ValueError(f"rank {mesh.rank} of {mesh.size} has no process "
                         "group: a data-parallel step needs one")
    return mesh.group


def create_mesh(device="cuda", axis_name: str = DATA_AXIS) -> Mesh:
    """The mesh of this process. Under the env contract it joins the
    process group first (NCCL for "cuda", gloo for "cpu"), as the JAX
    package's create_mesh does; otherwise a world-1 mesh on `device`. A
    CUDA request without a card raises, as resolve_device does; a process
    group whose backend does not fit `device` raises."""
    kind = torch.device(device).type
    if distributed.initialize_from_env(device=kind):
        want = "nccl" if kind == "cuda" else "gloo"
        backend = dist.get_backend()
        if backend != want:
            raise RuntimeError(f"the process group runs {backend}; a {kind} "
                               f"mesh needs {want}")
        dev = resolve_device(kind)  # cuda: the device set at the rendezvous
        return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                    dev, axis_name)
    return Mesh(None, 0, 1, resolve_device(device), axis_name)


def train_mesh(device, global_batch: int) -> Mesh:
    """create_mesh for a trainer's --data_parallel: the CLI's
    --per_device_train_batch_size is the GLOBAL batch and must divide by
    the world size (repconc_tpu/cli/run_train_conc.py:137-147)."""
    mesh = create_mesh(device)
    if global_batch % mesh.size:
        raise SystemExit(f"--per_device_train_batch_size is the GLOBAL batch "
                         f"under --data_parallel and must divide by the "
                         f"world size ({mesh.size}); got {global_batch}")
    return mesh


def local_mesh(rank: int, size: int, device="cuda") -> Mesh:
    """Rank `rank` of a `size`-way mesh with no process group: each rank's
    local part of a sharded search runs in this one process, and
    parallel/sharded.py::merge_topk merges their outputs as the gather
    would."""
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside [0, {size})")
    return Mesh(None, rank, size, resolve_device(device))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
