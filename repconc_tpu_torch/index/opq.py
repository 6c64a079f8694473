"""OPQ (optimized product quantization) training (counterpart of
repconc_tpu/index/opq.py:29-93; reference: faiss OPQMatrix in
run_warmup.py:98-122). OPQ-NP (Ge et al.) alternates:

  1. rotate:        y = x R
  2. fit PQ:        a few Lloyd steps per subspace, from the last centroids
  3. reconstruct:   y_hat = decode(encode(y))
  4. Procrustes:    R <- U V^T where U S V^T = svd(x^T y_hat)

`opq_step` is one such outer iteration, so each can be held to the JAX
package's from the same R and centroids; `opq_fit` draws the starting
rotation and the k-means++ seeds from torch generators, which differ from
jax.random's, so a whole fit is held to quality bounds only. Everything
runs in fp32 with TF32 off (the JAX package: Precision.HIGHEST), except the
Procrustes SVD of the (D, D) covariance, which runs in fp64: on the card
torch's default fp32 SVD (cuSOLVER's Jacobi method, gesvdj) stops at a
tolerance that leaves U V^T further from orthogonal than the 1e-4 the
warm-up is held to, while in fp64 it is orthogonal to rounding on either
device. The returned rotation is applied as `embeds @ rotation.T`, the
reference's convention for faiss's matrix A.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.index.kmeans import pq_assign, pq_fit


@torch.no_grad()
def random_rotation(d: int, seed: int = 2022, device="cuda") -> torch.Tensor:
    """A random orthogonal (d, d) matrix: QR of a Gaussian drawn from a
    generator seeded with `seed`, signs fixed by R's diagonal."""
    dev = resolve_device(device)
    g = torch.randn((d, d), generator=torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    q, r = torch.linalg.qr(g)
    return q * torch.sign(torch.diagonal(r))[None, :]


def _pq_reconstruct(y: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """encode + decode of y (N, D) against centroids (M, K, dsub)."""
    codes = pq_assign(y, centroids)
    m = torch.arange(centroids.shape[0], device=y.device)[None, :]
    return centroids[m, codes].reshape(y.shape)


@torch.no_grad()
def opq_step(x: torch.Tensor, R: torch.Tensor, centroids: torch.Tensor,
             pq_iters: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """One outer iteration (opq.py:74-83) from rotation R (applied as
    x @ R) and centroids (M, K, dsub): returns the new (R, centroids)."""
    resolve_device(x.device)
    M, K = centroids.shape[:2]
    y = x @ R
    centroids, _ = pq_fit(y, M, K, iters=pq_iters, init_centroids=centroids)
    y_hat = _pq_reconstruct(y, centroids)
    # orthogonal Procrustes: min_R ||x R - y_hat||_F, the SVD in fp64 (see
    # the module docstring)
    u, _, vt = torch.linalg.svd((x.T @ y_hat).double(), full_matrices=False)
    return (u @ vt).float(), centroids


@torch.no_grad()
def opq_fit(x: torch.Tensor, M: int, K: int = 256, outer_iters: int = 20,
            pq_iters: int = 4, final_pq_iters: int = 25, seed: int = 2022
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train OPQ on x (N, D) fp32 on its device (opq.py:50-91). Returns
    (rotation (D, D), centroids (M, K, D / M), mse (M,) of the final
    fit); rotated = x @ rotation.T."""
    resolve_device(x.device)
    R = random_rotation(x.shape[1], seed, device=x.device)
    centroids, _ = pq_fit(x @ R, M, K, iters=pq_iters, seed=seed + 1)
    for _ in range(outer_iters):
        R, centroids = opq_step(x, R, centroids, pq_iters)
    # the final, longer PQ fit at the converged rotation
    centroids, mse = pq_fit(x @ R, M, K, iters=final_pq_iters,
                            init_centroids=centroids)
    return R.T.contiguous(), centroids, mse
