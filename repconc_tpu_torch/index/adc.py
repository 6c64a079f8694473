"""Asymmetric distance computation (ADC) search over PQ codes.

Counterpart of repconc_tpu/index/adc.py:27-134. The score of doc n for
query q is

    score(q, n) = sum_m LUT[q, m, codes[n, m]],   LUT[q, m, k] = <q_m, C[m, k]>

`score_codes_reference` is the plain PyTorch version of the CUDA scan in
index/cuda_adc.py (the port of the TPU kernel `_adc_onehot_kernel`), and
`score_codes_int8_reference` that of its int8-LUT twin (the port of
`_adc_onehot_kernel_i8`), with the LUT from `quantize_lut_int8`.
`adc_group_max_reference` and `adc_filter_reference` are the plain versions
of the two passes of the fused top-k (cuda_adc.py::adc_topk), built on
`score_codes_reference`.
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


RUN = 32  # docs per run: group g of G holds runs g, g + G, g + 2G, ...


def doc_groups(n: int, groups: int, device=None) -> torch.Tensor:
    """The group of each of docs 0..n-1: (doc // RUN) % groups."""
    return (torch.arange(n, device=device) // RUN) % groups


def adc_group_max_reference(lut: torch.Tensor, codes: torch.Tensor,
                            n_valid: int, groups: int) -> torch.Tensor:
    """gmax (Q, groups) f32: the largest score of each group's valid docs
    (docs 0..n_valid-1; a group with none is -inf)."""
    scores = score_codes_reference(lut, codes[:n_valid])
    gmax = torch.full((lut.shape[0], groups), -torch.inf, device=lut.device)
    index = doc_groups(n_valid, groups, lut.device).expand_as(scores)
    return gmax.scatter_reduce_(1, index, scores, "amax")


def adc_filter_reference(lut: torch.Tensor, codes: torch.Tensor,
                         n_valid: int, tau: torch.Tensor, cap: int):
    """Every valid doc with score >= tau[q], per query.

    Returns (cand_s (Q, cap) f32, cand_i (Q, cap) int64, count (Q,) int32):
    count[q] docs pass; the first min(count[q], cap) of them, in id order,
    fill the first slots; the other slots hold -inf and id -1. The CUDA pass
    stores the same set in arrival order, and, past cap, another subset of
    it.
    """
    scores = score_codes_reference(lut, codes[:n_valid])
    hit = scores >= tau[:, None]
    slot = hit.cumsum(1) - 1
    keep = hit & (slot < cap)
    Q = lut.shape[0]
    cand_s = torch.full((Q, cap), -torch.inf, device=lut.device)
    cand_i = torch.full((Q, cap), -1, dtype=torch.long, device=lut.device)
    rows, docs = keep.nonzero(as_tuple=True)
    cand_s[rows, slot[rows, docs]] = scores[rows, docs]
    cand_i[rows, slot[rows, docs]] = docs
    return cand_s, cand_i, hit.sum(1).to(torch.int32)


def group_size(M: int, K: int) -> int:
    """m-group size of the int8 LUT (pallas_adc.py:57-61): the largest of 8,
    4, 2, 1 dividing M with gm * K a multiple of 128. Scales are per
    (query, group), so gm is part of the int8 result and is kept as the JAX
    package picks it: gm=4 at M=12, gm=8 at M=48 (K=256)."""
    for gm in (8, 4, 2, 1):
        if M % gm == 0 and (gm * K) % 128 == 0:
            return gm
    raise ValueError(f"unsupported (M={M}, K={K})")


# fp32(1 / 127). The JAX package's int8 scales divide by 127.0
# (pallas_adc.py:144, pallas_ivf.py:433,541), but every caller runs them
# inside jax.jit, where XLA computes x / 127.0 as x * fp32(1 / 127), 1 ulp
# off the division for some x. The port multiplies, bit for bit with what
# JAX serves.
INV127 = float(np.float32(1.0 / 127.0))


def quantize_lut_int8(lut: torch.Tensor, gm: int):
    """Per-(query, group) symmetric int8 quantization (pallas_adc.py:133-146),
    bit-equal to JAX's jitted quantize_lut_int8, the form every JAX caller
    runs (_ivf_search_device and the sharded search, pallas_ivf.py:339-366,
    :816-819).

    lut (Q, M, K) f32 -> (lut_i8 (Q, M, K) int8, scales (Q, M // gm) f32).
    Quantizes the plain layout viewed as (Q, G, gm * K): a group's amax
    does not depend on the TPU's k-major lane order (`permute_lut`), so the
    values equal JAX's after undoing it. The scale is amax * INV127, as XLA
    computes it; XLA leaves the division by the scale tensor a division.
    torch.round rounds half to even, as jnp.round does.
    """
    Q, M, K = lut.shape
    grouped = lut.reshape(Q, M // gm, gm * K)
    amax = grouped.abs().amax(-1)
    scale = amax.clamp(min=1e-12) * INV127
    q = torch.round(grouped / scale[:, :, None]).clamp(-127, 127)
    return q.to(torch.int8).reshape(Q, M, K), scale


def score_codes_int8_reference(lut_i8: torch.Tensor, scales: torch.Tensor,
                               codes: torch.Tensor) -> torch.Tensor:
    """(Q, M, K) int8 LUT, (Q, G) f32 scales, (N, M) uint8 codes -> (Q, N)
    f32: per m-group an exact int32 sum of LUT entries, then
    acc = acc + part * scale in f32, g in order, as the CUDA kernel adds.
    Codes above K - 1 clamp to K - 1."""
    Q, M, K = lut_i8.shape
    G = scales.shape[1]
    gm = M // G
    idx = codes.long().clamp(max=K - 1)
    lut = lut_i8.to(torch.int32)
    acc = torch.zeros((Q, codes.shape[0]), dtype=torch.float32,
                      device=lut.device)
    for g in range(G):
        part = torch.zeros((Q, codes.shape[0]), dtype=torch.int32,
                           device=lut.device)
        for m in range(g * gm, (g + 1) * gm):
            part += lut[:, m].index_select(1, idx[:, m])
        acc = acc + part.float() * scales[:, g:g + 1]
    return acc


def plain_topk(lut: torch.Tensor, codes: torch.Tensor, n_valid: int,
               topk: int, chunk_size: int = 1 << 16):
    """Exact top-k of docs 0..n_valid-1 (topk <= n_valid) by the plain
    scorer over `lut`, a chunk of docs at a time, so no (Q, N) buffer is
    held: (scores, ids), each (Q, topk)."""
    Q = lut.shape[0]
    best_s = torch.full((Q, topk), -torch.inf, device=lut.device)
    best_i = torch.zeros((Q, topk), dtype=torch.long, device=lut.device)
    for start in range(0, n_valid, chunk_size):
        scores = score_codes_reference(
            lut, codes[start:min(start + chunk_size, n_valid)])
        s, i = torch.topk(scores, min(topk, scores.shape[1]), dim=1)
        best_s, best_i = merge_topk(best_s, best_i, s, i + start)
    return best_s, best_i


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
    N = codes.shape[0]
    s, i = plain_topk(build_lut(q, cent), torch.as_tensor(codes, device=dev),
                      N, min(topk, N), chunk_size)
    return s.cpu().numpy(), i.cpu().numpy()


def batch_adc_search(query_ids, query_embeds, corpus_ids, codes, centroids,
                     topk: int, batch_size: int = 1200, device="cuda",
                     searcher=None) -> Tuple[np.ndarray, np.ndarray]:
    """Query-batched ADC search returning docid strings (adc.py:101-134).

    Dispatch differs from the JAX package, which takes the Pallas index only
    off-CPU with N >= 20 000 (adc.py:115) to spare a Pallas compile on the
    TPU. Here a CUDA device always takes CudaADCIndex, at every N, with the
    LUT rounded to bf16 as the TPU kernel takes it; the CPU takes
    adc_search with the fp32 LUT, as JAX does on the CPU. `searcher`: a
    CudaADCIndex on the CUDA device already holding `codes`, searched with
    `centroids` swapped in, so the codes are not uploaded again (stage 2's
    validation); the CPU ignores it.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        searcher = None
    elif searcher is None:
        from repconc_tpu_torch.index.cuda_adc import CudaADCIndex

        searcher = CudaADCIndex(codes, centroids, device=dev)
    else:
        searcher.set_centroids(centroids)
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
