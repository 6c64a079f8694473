"""Flat (uncompressed) inner-product search, and the top-k helpers the ADC
searches share (counterpart of repconc_tpu/index/flat.py:58-135).

The dense search is an exact fp32 `q @ chunk.T` (TF32 off, as the JAX
package runs it at Precision.HIGHEST) and a `torch.topk` per corpus chunk,
merged into a running top-k. The JAX package's `approx_max_k` and
`topk_wide` (:21-45) stood in for a top-k sort that wedged the TPU
compiler; `torch.topk` is exact and is used directly.

The corpus may be a host numpy array, streamed to the device a chunk at a
time, or a tensor already on the device (an H100 holds MS MARCO's 8.8 M x
768 fp32 embeddings, 27.2 GB): `batch_flat_search` uploads a host corpus
once when it is at most PIN_BYTES, as the JAX package pins one below 6 GB.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from repconc_tpu_torch.core.device import resolve_device

PIN_BYTES = 6 << 30  # a host corpus up to this size is uploaded once (flat.py:121)


def merge_topk(best_s: torch.Tensor, best_i: torch.Tensor,
               new_s: torch.Tensor, new_i: torch.Tensor):
    """Exact running top-k merge: keeps best_s.shape[1] entries."""
    s = torch.cat([best_s, new_s], dim=1)
    i = torch.cat([best_i, new_i], dim=1)
    ms, pos = torch.topk(s, best_s.shape[1], dim=1)
    return ms, torch.gather(i, 1, pos)


def fixed_query_batches(query_embeds, batch_size: int
                        ) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (padded_chunk, n_real) with one batch shape; the short final
    chunk is zero-padded (flat.py:96-108)."""
    Q = len(query_embeds)
    b = min(batch_size, Q)
    for start in range(0, Q, b):
        qc = np.asarray(query_embeds[start:start + b], dtype=np.float32)
        real = qc.shape[0]
        if real < b:
            qc = np.pad(qc, ((0, b - real), (0, 0)))
        yield qc, real


@torch.no_grad()
def flat_search(query_embeds, corpus_embeds, topk: int = 1000,
                chunk_size: int = 1 << 20, device="cuda"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k inner-product search (flat.py:67-93). query_embeds:
    (Q, D); corpus_embeds: (N, D), a host array or a tensor on `device`.
    Returns (scores (Q, k), row ids (Q, k)) as numpy, best first,
    k = min(topk, N)."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(query_embeds, dtype=np.float32)).to(dev)
    N = corpus_embeds.shape[0]
    k = min(topk, N)
    best_s = torch.full((q.shape[0], k), -torch.inf, device=dev)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=dev)
    for start in range(0, N, chunk_size):
        cc = torch.as_tensor(corpus_embeds[start:start + chunk_size]).to(
            dev, torch.float32)
        s, i = torch.topk(q @ cc.T, min(k, cc.shape[0]), dim=1)
        best_s, best_i = merge_topk(best_s, best_i, s, i + start)
    return best_s.cpu().numpy(), best_i.cpu().numpy()


def batch_flat_search(query_ids: np.ndarray, query_embeds: np.ndarray,
                      corpus_ids: np.ndarray, corpus_embeds, topk: int,
                      batch_size: int = 1200, chunk_size: int = 1 << 20,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Query-batched flat search returning docids (flat.py:111-135;
    reference: evaluate_dense.py:92-110)."""
    dev = resolve_device(device)
    if (not torch.is_tensor(corpus_embeds)
            and corpus_embeds.shape[0] * corpus_embeds.shape[1] * 4 <= PIN_BYTES):
        corpus_embeds = torch.as_tensor(
            np.asarray(corpus_embeds, dtype=np.float32)).to(dev)
    k = min(topk, corpus_embeds.shape[0])
    if len(query_ids) == 0:
        return (np.zeros((0, k), np.float32),
                np.zeros((0, k), corpus_ids.dtype))
    all_scores, all_ids = [], []
    for start in range(0, len(query_ids), batch_size):
        s, i = flat_search(query_embeds[start:start + batch_size],
                           corpus_embeds, topk, chunk_size, device=dev)
        all_scores.append(s)
        all_ids.append(corpus_ids[i])
    return np.concatenate(all_scores, 0), np.concatenate(all_ids, 0)
