"""Sinkhorn-Knopp constrained assignment in log space, fp32.

Counterpart of repconc_tpu/quant/sinkhorn.py:33-130. The reference runs
multiplicative Sinkhorn in float64 (modeling_repconc.py:56,137-165); here,
as in the JAX package, the updates subtract logsumexp terms instead of
dividing by sums, which stays finite in fp32 at the production epsilon
(0.003). The semantics are the reference's:

  * each of the K centroids receives total mass 1/K over the batch;
  * each sample distributes mass 1/B over centroids;
  * the returned log Q is shifted by log B, so each sample's row sums to 1;
  * distances are first centred to [-1, 1] with the max and min per
    subspace (modeling_repconc.py:73-85).

Across processes the batch is every rank's local docs and the constraint
is global, as the reference all-reduces its marginals over its DDP ranks:
`group` (a torch.distributed process group, the counterpart of the JAX
package's `axis_name`) all-reduces the centring's MAX and MIN and the
batch logsumexp's MAX, then SUM, and B is the global batch, B_local times
the world size. group=None is one process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _logsumexp_batch(logq: torch.Tensor, group=None) -> torch.Tensor:
    """logsumexp over the batch axis (-2), over every rank's rows: (M, B, K)
    -> (M, 1, K), as the JAX package's _global_logsumexp_batch (max shift,
    sum floored at 1e-30)."""
    gmax = _all_reduce(logq.amax(dim=-2, keepdim=True), dist.ReduceOp.MAX,
                       group)
    s = _all_reduce(torch.exp(logq - gmax).sum(dim=-2, keepdim=True),
                    dist.ReduceOp.SUM, group)
    return torch.log(s.clamp(min=1e-30)) + gmax


def center_distances(distances: torch.Tensor, group=None) -> torch.Tensor:
    """Centre per-subspace distances (M, B, K) to [-1, 1] with each
    subspace's max and min, over every rank's rows."""
    max_distance = _all_reduce(distances.amax(dim=(-1, -2)),
                               dist.ReduceOp.MAX, group)
    min_distance = _all_reduce(distances.amin(dim=(-1, -2)),
                               dist.ReduceOp.MIN, group)
    middle = (max_distance + min_distance) / 2
    amplitude = max_distance - middle + 1e-5
    return (distances - middle[:, None, None]) / amplitude[:, None, None]


def sinkhorn_log(neg_cost: torch.Tensor, epsilon: float, iterations: int,
                 group=None) -> torch.Tensor:
    """Entropic OT assignment in log space. neg_cost: (M, B, K) similarity
    (minus the centred distance), this rank's B_local samples. Returns
    log Q (M, B_local, K): each sample's row of exp(log Q) sums to 1 and
    each centroid's column, over every rank's samples, to B / K, with
    B = B_local times the world size."""
    B, K = neg_cost.shape[1] * _world(group), neg_cost.shape[2]
    logq = neg_cost.float() / epsilon
    # initial normalisation (the whole of each subspace sums to 1): a
    # constant shift per subspace, kept for parity with the reference
    logq = logq - _logsumexp_batch(
        torch.logsumexp(logq, dim=-1, keepdim=True), group)
    log_K = torch.log(torch.tensor(K, dtype=logq.dtype, device=logq.device))
    log_B = torch.log(torch.tensor(B, dtype=logq.dtype, device=logq.device))
    for _ in range(iterations):
        # per-centroid mass over the batch becomes 1/K
        logq = logq - _logsumexp_batch(logq, group) - log_K
        # per-sample mass becomes 1/B
        logq = logq - torch.logsumexp(logq, dim=-1, keepdim=True) - log_B
    return logq + log_B


def sinkhorn_assign(distances: torch.Tensor, epsilon: float, iterations: int,
                    group=None) -> torch.Tensor:
    """Constrained codes (B, M) int64 from squared distances (M, B, K):
    centre, Sinkhorn, argmax (ties to the lowest index, as jnp.argmax)."""
    centered = center_distances(distances, group)
    logq = sinkhorn_log(-centered, epsilon, iterations, group)
    return logq.argmax(dim=-1).T

