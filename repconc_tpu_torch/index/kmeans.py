"""k-means for the IVF coarse quantizer (counterpart of
repconc_tpu/index/kmeans.py:29-188 and index/opq.py:94-109).

Lloyd's algorithm in fp32 with TF32 off (the JAX package forces
Precision.HIGHEST at kmeans.py:26,33-34,42-43):

* assignment: argmin of ||x||^2 - 2 x.C^T + ||C||^2, one matmul per chunk;
* update: cluster sums as a one-hot matmul (onehot^T x) and counts as its
  column sums, as the JAX package computes them. `index_add_` would move
  fewer bytes, but on CUDA it adds with atomics in no fixed order, so two
  runs of the same build would differ in the last bits of the centroids
  and could then assign a near-tie doc to another cell; the matmul adds in
  a fixed order;
* rows are chunked above _CHUNK_ELEMS (N, K) elements, at the same row
  boundaries as the JAX package: the IVF build at 262,144 train points x
  4096 cells is 1.07e9 elements;
* empty clusters take a deterministic sin-jittered copy of the largest
  cluster (faiss's split policy), as in the JAX package.

k-means++ seeding draws from an explicit torch.Generator on the device, so
its seeds differ from jax.random's at the same seed. Product quantization
(`pq_fit`, `pq_encode_chunked`, kmeans.py:235-291) runs the M subspaces'
k-means one after another, where the JAX package vmaps them: each is a
few (N, K) matmuls, and a Lloyd step from given centroids is the same
computation either way. Balanced k-means (`balanced_kmeans_fit`,
kmeans.py:191-232) assigns under the Sinkhorn uniform-assignment
constraint of quant/sinkhorn.py; its (N, K) cost matrix is whole, since
the constraint's marginals couple every row.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repconc_tpu_torch.core.device import resolve_device

_CHUNK_ELEMS = 2 ** 27  # 512 MB fp32 per (rows, K) buffer (kmeans.py:56)


def subsample_for_training(x, max_points: int = 65536, seed: int = 2022):
    """Random training subsample (opq.py:94-109) of a host array or a
    tensor: the indices come from numpy's default_rng, so the rows equal
    the JAX package's at the same seed."""
    n = x.shape[0]
    if n <= max_points:
        return x
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=max_points, replace=False)
    idx.sort()
    if torch.is_tensor(x):
        return x[torch.from_numpy(idx).to(x.device)]
    return x[idx]


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids (N,) int64 for x (N, d), centroids (K, d);
    ties go to the lowest id, as jnp.argmin's do."""
    x_sq = (x * x).sum(-1, keepdim=True)
    c_sq = (centroids * centroids).sum(-1)
    dist = x_sq - 2.0 * (x @ centroids.T) + c_sq[None, :]
    return dist.argmin(-1)


def _accumulate(x: torch.Tensor, codes: torch.Tensor, K: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster sums (K, d) and counts (K,) as a one-hot matmul."""
    onehot = torch.zeros((x.shape[0], K), dtype=x.dtype, device=x.device)
    onehot.scatter_(1, codes[:, None], 1.0)
    return onehot.T @ x, onehot.sum(0)


def _assign_accumulate(x: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd step's statistics: (sums (K, d), counts (K,), err), with
    the rows chunked when the (N, K) buffers would exceed _CHUNK_ELEMS."""
    K = centroids.shape[0]
    N = x.shape[0]
    if N * K <= _CHUNK_ELEMS or N <= 1:
        rows = N
    else:
        c = -(-N // max(1, _CHUNK_ELEMS // K))
        rows = -(-N // c)
    sums = torch.zeros_like(centroids)
    counts = torch.zeros(K, dtype=x.dtype, device=x.device)
    err = torch.zeros((), dtype=x.dtype, device=x.device)
    for start in range(0, N, rows):
        xc = x[start:start + rows]
        codes = assign(xc, centroids)
        s, n = _accumulate(xc, codes, K)
        sums += s
        counts += n
        err += ((xc - centroids[codes]) ** 2).sum()
    return sums, counts, err


def lloyd_step(x: torch.Tensor, centroids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration: (new centroids, mean squared error of x under
    the old ones). Each empty cluster gets its own deterministic
    perturbation of the largest cluster (kmeans.py:95-125)."""
    K, d = centroids.shape
    sums, counts, err = _assign_accumulate(x, centroids)
    new = sums / counts.clamp(min=1.0)[:, None]
    empty = counts < 0.5
    donor = new[counts.argmax()]
    slot = torch.arange(K, dtype=new.dtype, device=new.device)[:, None]
    dim = torch.arange(d, dtype=new.dtype, device=new.device)[None, :]
    jitter = 1e-3 * torch.sin(slot * 12.9898 + dim * 78.233)
    new = torch.where(empty[:, None], donor[None, :] * (1.0 + jitter) + jitter,
                      new)
    return new, err / max(x.shape[0], 1)


def kmeans_plusplus_init(x: torch.Tensor, K: int,
                         generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (kmeans.py:128-146): each next seed is drawn with
    probability proportional to its squared distance from the chosen set.
    `generator` lives on x's device. Distances to each new seed use the
    ||x||^2 - 2 x.c + ||c||^2 expansion (one matrix-vector product), where
    the JAX package subtracts: the draws differ from jax.random's anyway."""
    n = x.shape[0]
    x_sq = (x * x).sum(-1)
    first = int(torch.randint(0, n, (1,), generator=generator,
                              device=x.device))
    seeds = [x[first]]
    d2 = ((x - x[first][None, :]) ** 2).sum(-1)
    for _ in range(K - 1):
        idx = torch.multinomial(d2.clamp(min=1e-30), 1, generator=generator)
        nxt = x[idx[0]]
        seeds.append(nxt)
        d_new = (x_sq - 2.0 * (x @ nxt) + (nxt * nxt).sum()).clamp(min=0.0)
        d2 = torch.minimum(d2, d_new)
    return torch.stack(seeds)


def kmeans_fit_from(x: torch.Tensor, init_centroids: torch.Tensor,
                    iters: int = 25) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iters` Lloyd steps from init: (centroids, the last step's mse)."""
    centroids = init_centroids
    mse = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        centroids, mse = lloyd_step(x, centroids)
    return centroids, mse


@torch.no_grad()
def kmeans_fit(x: torch.Tensor, K: int, iters: int = 25, seed: int = 2022
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means++ seeding, then Lloyd: (centroids (K, d), final mse)."""
    generator = torch.Generator(device=x.device).manual_seed(seed)
    return kmeans_fit_from(x, kmeans_plusplus_init(x, K, generator), iters)


@torch.no_grad()
def balanced_kmeans_fit(x: torch.Tensor, K: int, iters: int = 25,
                        seed: int = 2022, sk_epsilon: float = 0.05,
                        sk_iters: int = 30,
                        init: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Balanced k-means (kmeans.py:191-232): Lloyd updates whose
    assignment is the Sinkhorn uniform-assignment constraint over the
    whole (N, K) cost ||x||^2 - 2 x.C^T + ||C||^2, so that every cluster
    gets about N / K points. Returns (centroids (K, d), the last step's
    mse). Seeds by k-means++ from a generator on x's device seeded with
    `seed`, unless `init` (K, d) is given. A cluster left empty keeps
    zeros, as the JAX package's does (no split).

    Memory: the cost matrix and Sinkhorn's log-plan are N * K fp32 each;
    at 2^18 points and 4096 cells, 4.3 GB each on the device."""
    from repconc_tpu_torch.quant.sinkhorn import sinkhorn_assign

    resolve_device(x.device)  # TF32 off on a card
    if init is None:
        generator = torch.Generator(device=x.device).manual_seed(seed)
        init = kmeans_plusplus_init(x, K, generator)
    centroids = init.to(x.device, torch.float32)
    mse = torch.zeros((), dtype=torch.float32, device=x.device)
    x_sq = (x * x).sum(-1, keepdim=True)
    for _ in range(iters):
        c_sq = (centroids * centroids).sum(-1)
        dist = x_sq - 2.0 * (x @ centroids.T) + c_sq[None, :]
        codes = sinkhorn_assign(dist[None], sk_epsilon, sk_iters)[:, 0]
        del dist
        sums, counts = _accumulate(x, codes, K)
        centroids = sums / counts.clamp(min=1.0)[:, None]
        mse = ((x - centroids[codes]) ** 2).sum(-1).mean()
    return centroids, mse


@torch.no_grad()
def pq_fit(x: torch.Tensor, M: int, K: int = 256, iters: int = 25,
           seed: int = 2022, init_centroids: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train a product quantizer: an independent k-means in each of the M
    subspaces of x (N, D), D % M == 0 (kmeans.py:235-261). Returns
    (centroids (M, K, D / M), mse (M,) of each subspace's last step).
    Without `init_centroids`, each subspace seeds by k-means++ from one
    generator on x's device seeded with `seed`."""
    resolve_device(x.device)  # TF32 off on a card
    N, D = x.shape
    xs = x.reshape(N, M, D // M)
    generator = (torch.Generator(device=x.device).manual_seed(seed)
                 if init_centroids is None else None)
    cents, mses = [], []
    for m in range(M):
        xm = xs[:, m].contiguous()
        init = (kmeans_plusplus_init(xm, K, generator) if generator is not None
                else init_centroids[m].to(x.device, torch.float32))
        c, mse = kmeans_fit_from(xm, init, iters)
        cents.append(c)
        mses.append(mse)
    return torch.stack(cents), torch.stack(mses)


def pq_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """PQ codes (n, M) int64 of x (n, D) against centroids (M, K, dsub):
    the nearest centroid of each subspace, ties to the lowest id."""
    M = centroids.shape[0]
    xs = x.reshape(x.shape[0], M, -1)
    return torch.stack([assign(xs[:, m], centroids[m]) for m in range(M)], 1)


@torch.no_grad()
def pq_encode_chunked(x, centroids, chunk: int = 65536, device="cuda"
                      ) -> np.ndarray:
    """PQ codes (N, M) uint8 on the host of x (N, D), a host array or a
    tensor, `chunk` rows at a time on `device` (kmeans.py:264-281)."""
    dev = resolve_device(device)
    cent = torch.as_tensor(centroids).to(dev, torch.float32)
    out = np.empty((x.shape[0], cent.shape[0]), dtype=np.uint8)
    for start in range(0, x.shape[0], chunk):
        xc = torch.as_tensor(x[start:start + chunk]).to(dev, torch.float32)
        out[start:start + chunk] = pq_assign(xc, cent).cpu().numpy()
    return out
