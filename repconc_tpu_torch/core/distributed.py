"""Process groups, host-batch slicing and gathers across processes
(counterpart of repconc_tpu/core/distributed.py).

The reference scales with `torch.distributed.launch`, one process per GPU
(examples/tas-balanced/repconc/7_run_conc_train.sh:56-64, NCCL). The JAX
package joins one process per host into one SPMD program; PyTorch runs one
process per GPU, and the collectives that XLA inserted there (all_gather,
psum, pmax, pmin) are torch.distributed calls here.

Env contract, the JAX package's:
  REPCONC_COORDINATOR    host:port of rank 0, or "auto"
  REPCONC_NUM_PROCESSES  world size
  REPCONC_PROCESS_ID     this process's rank
"auto" reads torchrun's variables (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, LOCAL_RANK), the counterpart of JAX's TPU-metadata
autodetection, so `torchrun --nproc_per_node N -m repconc_tpu_torch.cli.<cli>
--data_parallel` joins without REPCONC_* set beyond REPCONC_COORDINATOR=auto;
torchrun's variables alone also count.

A process group on CUDA devices is NCCL's; gloo serves only a caller that
asked for the CPU. A rendezvous that fails or times out raises: nothing
carries on at world size 1.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

ENV_COORDINATOR = "REPCONC_COORDINATOR"
ENV_NUM_PROCESSES = "REPCONC_NUM_PROCESSES"
ENV_PROCESS_ID = "REPCONC_PROCESS_ID"
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT_S = 600.0  # rendezvous and collectives


def is_distributed_env() -> bool:
    """True when the env contract asks for several processes: REPCONC_* or
    torchrun's variables."""
    return (ENV_COORDINATOR in os.environ
            or all(v in os.environ for v in TORCHRUN_VARS))


def _env_contract():
    """(address, world, rank, local_rank or None) from the env."""
    coordinator = os.environ.get(ENV_COORDINATOR, "auto")
    local = os.environ.get("LOCAL_RANK")
    local_rank = None if local is None else int(local)
    if coordinator == "auto":
        missing = [v for v in TORCHRUN_VARS if v not in os.environ]
        if missing:
            raise RuntimeError(f"{ENV_COORDINATOR}=auto needs torchrun's "
                               f"variables; missing {missing}")
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        return (address, int(os.environ["WORLD_SIZE"]),
                int(os.environ["RANK"]), local_rank)
    return (coordinator, int(os.environ[ENV_NUM_PROCESSES]),
            int(os.environ[ENV_PROCESS_ID]), local_rank)


def initialize_from_env(force: bool = False, device="cuda",
                        timeout: float = TIMEOUT_S) -> bool:
    """Join this process to the process group the env asks for.

    Returns True when a process group is up (after this call or an earlier
    one: a second call does nothing), False without the env contract.
    `device` picks the backend: NCCL for "cuda", after
    torch.cuda.set_device(LOCAL_RANK, or the rank modulo the local device
    count); gloo for "cpu". `timeout` (seconds) bounds the rendezvous and
    every collective; a rendezvous that cannot complete raises."""
    if dist.is_initialized():
        return True
    if not (force or is_distributed_env()):
        return False
    address, world, rank, local_rank = _env_contract()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        index = (local_rank if local_rank is not None
                 else rank % torch.cuda.device_count())
        torch.cuda.set_device(index)
        backend, device_id = "nccl", torch.device("cuda", index)
    elif dev.type == "cpu":
        backend, device_id = "gloo", None
    else:
        raise ValueError(f"process groups run on cuda or cpu, not {device!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout), device_id=device_id)
    logger.info("distributed: rank %d/%d over %s (%s)", rank, world, address,
                backend)
    return True


def rank_and_world():
    """(rank, world) of the process group, (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def block(n: int, rank: int, world: int) -> slice:
    """Rank `rank`'s contiguous block of n rows split W ways; n must
    divide by W."""
    if n % world:
        raise ValueError(f"global batch {n} must divide the process count "
                         f"{world}")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def process_slice(global_batch: int) -> slice:
    """Rows of a global batch this process takes: contiguous blocks in rank
    order, as the JAX package's (a remainder raises)."""
    rank, world = rank_and_world()
    return block(global_batch, rank, world)


def shard_host_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """This rank's rows of every array of a global host batch, as tensors on
    `device` (the JAX package assembles a global array from them; here each
    process keeps its own rows)."""
    return {k: torch.as_tensor(np.asarray(v)[process_slice(len(v))]).to(device)
            for k, v in batch.items()}


def all_gather(tensor: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `tensor` (equal shapes), concatenated along dim 0 in
    rank order. group None: the tensor itself (one process)."""
    if group is None:
        return tensor
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor, group=group)
    return torch.cat(parts, 0)


class _GatherRows(torch.autograd.Function):
    """all_gather along dim 0 whose backward returns this rank's rows of the
    incoming gradient, unreduced: every rank computes the same global loss
    from the gathered rows, so each rank's share of a parameter's gradient
    is what its own rows contribute, and the sum over ranks (the gradient
    all-reduce) is the whole gradient."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.rank, ctx.rows = dist.get_rank(group), tensor.shape[0]
        return all_gather(tensor, group)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.rank * ctx.rows
        return grad[start:start + ctx.rows], None


def gather_rows(tensor: torch.Tensor, group) -> torch.Tensor:
    """all_gather with the gradient of _GatherRows. group None: identity."""
    if group is None:
        return tensor
    return _GatherRows.apply(tensor, group)


def all_reduce_grads(params, group) -> None:
    """Sum every parameter's gradient over the ranks, in place, one
    all-reduce per dtype over the flattened gradients (a parameter without
    one gets zeros, as the optimizer treats it). A SUM, not DDP's mean:
    each rank's backward holds only its rows' share."""
    if group is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def broadcast_params(module: torch.nn.Module, group, src: int = 0) -> None:
    """Rank `src`'s parameters and buffers onto every rank."""
    if group is None:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
