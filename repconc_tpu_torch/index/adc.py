"""Asymmetric distance computation (ADC) search over PQ codes.

Counterpart of repconc_tpu/index/adc.py:27-134. The score of doc n for
query q is

    score(q, n) = sum_m LUT[q, m, codes[n, m]],   LUT[q, m, k] = <q_m, C[m, k]>

`score_codes_reference` is the plain PyTorch version of the CUDA scan in
index/cuda_adc.py (the port of the TPU kernel `_adc_onehot_kernel`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.index.flat import fixed_query_batches, merge_topk


def build_lut(query_embeds: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Per-query inner-product tables in fp32: (Q, D) x (M, K, dsub) ->
    (Q, M, K). TF32 stays off here (adc.py:24,32-33)."""
    Q = query_embeds.shape[0]
    M = centroids.shape[0]
    qs = query_embeds.reshape(Q, M, -1)
    return torch.einsum("qmd,mkd->qmk", qs, centroids)


def score_codes_reference(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(Q, M, K) x (N, M) uint8 -> (Q, N) f32, adc.py:37-53.

    A loop over the M subspaces, each a gather of one LUT column added into
    one (Q, N) f32 buffer in m order: the CUDA kernel adds in the same
    order. Codes above K - 1 clamp to K - 1, as the kernel's do. The LUT
    may be bf16 (the kernel's input type); sums are f32 either way.
    """
    lut = lut.float()
    K = lut.shape[2]
    idx = codes.long().clamp(max=K - 1)
    acc = torch.zeros((lut.shape[0], codes.shape[0]), dtype=torch.float32,
                      device=lut.device)
    for m in range(codes.shape[1]):
        acc += lut[:, m].index_select(1, idx[:, m])
    return acc


def adc_search(query_embeds, codes, centroids, topk: int = 1000,
               chunk_size: int = 1 << 16, device="cuda"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force ADC top-k with the plain scorer and an fp32 LUT.

    query_embeds (Q, D); codes (N, M) uint8, host numpy or a tensor;
    centroids (M, K, dsub). Returns numpy (scores, indices), each (Q, topk).
    """
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(query_embeds, dtype=np.float32), device=dev)
    cent = torch.as_tensor(np.asarray(centroids, dtype=np.float32), device=dev)
    lut = build_lut(q, cent)
    N = codes.shape[0]
    topk = min(topk, N)
    best_s = torch.full((q.shape[0], topk), -torch.inf, device=dev)
    best_i = torch.zeros((q.shape[0], topk), dtype=torch.long, device=dev)
    for start in range(0, N, chunk_size):
        cc = torch.as_tensor(codes[start:start + chunk_size], device=dev)
        scores = score_codes_reference(lut, cc)
        s, i = torch.topk(scores, min(topk, cc.shape[0]), dim=1)
        best_s, best_i = merge_topk(best_s, best_i, s, i + start)
    return best_s.cpu().numpy(), best_i.cpu().numpy()


def batch_adc_search(query_ids, query_embeds, corpus_ids, codes, centroids,
                     topk: int, batch_size: int = 1200, device="cuda"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Query-batched ADC search returning docid strings (adc.py:101-134).

    Dispatch differs from the JAX package, which takes the Pallas index only
    off-CPU with N >= 20 000 (adc.py:115) to spare a Pallas compile on the
    TPU. Here a CUDA device always takes CudaADCIndex, at every N, with the
    LUT rounded to bf16 as the TPU kernel takes it; the CPU takes
    adc_search with the fp32 LUT, as JAX does on the CPU.
    """
    dev = resolve_device(device)
    searcher = None
    if dev.type == "cuda":
        from repconc_tpu_torch.index.cuda_adc import CudaADCIndex

        searcher = CudaADCIndex(codes, centroids, device=dev)
    k = min(topk, codes.shape[0])
    if len(query_ids) == 0:
        return (np.zeros((0, k), np.float32),
                np.zeros((0, k), corpus_ids.dtype))
    all_scores, all_ids = [], []
    for q_chunk, real in fixed_query_batches(query_embeds, batch_size):
        if searcher is not None:
            s, i = searcher.search(q_chunk, topk=topk)
        else:
            s, i = adc_search(q_chunk, codes, centroids, topk, device=dev)
        all_scores.append(s[:real])
        all_ids.append(corpus_ids[i[:real]])
    return np.concatenate(all_scores, 0), np.concatenate(all_ids, 0)
