"""PQ codebook operations: distances, encode (argmin / Sinkhorn), decode.

Counterpart of repconc_tpu/quant/codebook.py:23-200. Subspace distances use
the ||x||^2 + ||c||^2 - 2 x.c expansion so the hot term is a batched matmul.
That matmul decides argmins, so it runs in full fp32: the entry points
switch TF32 off (core/device.py), as the JAX package forces
Precision.HIGHEST (:44-51).

The JAX package decodes with a one-hot einsum (an MXU measure); here decode
gathers centroid rows. Both give the centroid values exactly, and the
gather's backward (an index_put with accumulation) is the einsum's VJP: on
the card it accumulates with atomics, so its sums may differ from the
CPU's in the last bits.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repconc_tpu_torch.quant.sinkhorn import sinkhorn_assign


def subvector_view(embeds: torch.Tensor, M: int) -> torch.Tensor:
    """(B, D) -> (B, M, dsub)."""
    B, D = embeds.shape
    return embeds.reshape(B, M, D // M)


def _sqdist_mbk(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(M, B, dsub) x (M, K, dsub) -> (M, B, K) squared distances, the
    expansion shared by the chunked and unchunked encode paths."""
    x_sq = (x * x).sum(-1)                      # (M, B)
    c_sq = (centroids * centroids).sum(-1)      # (M, K)
    xc = torch.bmm(x, centroids.transpose(1, 2))  # (M, B, K)
    return x_sq[:, :, None] + c_sq[:, None, :] - 2.0 * xc


def pairwise_sqdist(embeds: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances per subspace. embeds (B, D); centroids
    (M, K, dsub). Returns (M, B, K)."""
    M = centroids.shape[0]
    return _sqdist_mbk(subvector_view(embeds, M).transpose(0, 1), centroids)


def round_to_divisor(n: int, chunk: int) -> int:
    """Largest divisor of n that is <= chunk (>= 1)."""
    chunk = max(1, min(chunk, n))
    while n % chunk != 0:
        chunk -= 1
    return chunk


def _auto_m_chunk(B: int, M: int, K: int) -> int:
    """Largest divisor of M keeping one (mc, B, K) fp32 buffer <= ~256 MB
    (codebook.py:64-82): subspace problems are independent, so chunking M
    changes nothing numerically and bounds peak memory."""
    budget = 256 * 1024 * 1024 // 4  # fp32 elements
    mc = M
    while mc > 1 and mc * B * K > budget:
        next_mc = mc - 1
        while next_mc > 1 and M % next_mc != 0:
            next_mc -= 1
        mc = next_mc
    return mc


@torch.no_grad()
def encode(embeds: torch.Tensor, centroids: torch.Tensor,
           use_constraint: bool = False, sk_epsilon: float = 0.003,
           sk_iters: int = 100, m_chunk: Optional[int] = None,
           group=None) -> torch.Tensor:
    """Codes (B, M) int64: nearest centroid, or the Sinkhorn-constrained
    assignment (codebook.py:85-127). No gradient flows: the assignment is
    discrete.

    m_chunk: subspaces per chunk (None = auto). Subspace problems are
    independent (the centring and both marginals are per subspace), so the
    result is the same for every chunking. Ties go to the lowest index, as
    jnp.argmin's and jnp.argmax's do. group: the process group whose ranks'
    rows the constraint spans (quant/sinkhorn.py), None for one process;
    every rank must pass the same number of rows."""
    embeds, centroids = embeds.detach(), centroids.detach()
    M, K = centroids.shape[0], centroids.shape[1]
    B = embeds.shape[0]
    mc = _auto_m_chunk(B, M, K) if m_chunk is None else round_to_divisor(M, m_chunk)
    x = subvector_view(embeds, M).transpose(0, 1)  # (M, B, dsub)
    codes = []
    for s in range(0, M, mc):
        d = _sqdist_mbk(x[s:s + mc], centroids[s:s + mc])  # (mc, B, K)
        codes.append(sinkhorn_assign(d, sk_epsilon, sk_iters, group)
                     if use_constraint else d.argmin(-1).T)
    return torch.cat(codes, 1).contiguous()


def decode(codes: torch.Tensor, centroids: torch.Tensor,
           b_chunk: Optional[int] = None) -> torch.Tensor:
    """Reconstruct (B, D) from codes (B, M), differentiable with respect to
    the centroids (codebook.py:142-168).

    b_chunk: rows per chunk, each under torch.utils.checkpoint (None: one
    gather). The JAX package chunks to bound its (B, M, K) one-hot; the
    gather has none, so the default takes the whole batch at once."""
    B = codes.shape[0]
    if b_chunk is None or b_chunk >= B:
        return decode_gather(codes, centroids)
    parts = [checkpoint(decode_gather, codes[s:s + b_chunk], centroids,
                        use_reentrant=False)
             for s in range(0, B, max(1, b_chunk))]
    return torch.cat(parts, 0)


def decode_gather(codes: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Reconstruct (B, D) from codes (B, M). Out-of-range codes clamp to
    the nearest valid row, as jnp.take(mode="clip") does (:171-184)."""
    M, K = centroids.shape[0], centroids.shape[1]
    idx = codes.long().clamp(0, K - 1)
    m = torch.arange(M, device=codes.device)[None, :]
    return centroids[m, idx].reshape(codes.shape[0], -1)


def normalize_centroids(centroids: torch.Tensor) -> torch.Tensor:
    """Per-centroid L2 normalization for METRIC_CENTROID_COS."""
    return centroids / centroids.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def normalize_subvectors(embeds: torch.Tensor, M: int) -> torch.Tensor:
    """Per-subvector L2 normalization for METRIC_CENTROID_COS."""
    x = subvector_view(embeds, M)
    x = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return x.reshape(embeds.shape)
