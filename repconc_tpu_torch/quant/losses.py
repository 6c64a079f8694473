"""Training losses: global-batch contrastive with masking, MSE, straight-through.

Counterpart of repconc_tpu/quant/losses.py:25-190. The reference's GradCache
surrogate (finetune_repconc.py:346-431) sends the gradient of the
contrastive loss on QUANTIZED doc embeddings to both the encoder (through
the continuous embeddings) and the centroids (through decode), each with
the same upstream gradient. `straight_through` is that composition: its
value is `quantized` bit for bit and its backward returns (g, g).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repconc_tpu_torch.quant.codebook import round_to_divisor

NEG_INF_MASK = 10000.0


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, quantized, continuous):
        return quantized.view_as(quantized)

    @staticmethod
    def backward(ctx, g):
        return g, g


def straight_through(quantized: torch.Tensor,
                     continuous: torch.Tensor) -> torch.Tensor:
    """value = quantized (bit-exact); the gradient flows to both inputs."""
    return _StraightThrough.apply(quantized, continuous)


def false_negative_mask(qids: torch.Tensor, doc_ids: torch.Tensor,
                        query_positives: torch.Tensor) -> torch.Tensor:
    """mask[i, j] = True where doc j is a judged positive of query i, off
    the diagonal. query_positives: (B, P) positive docids, -1 padded
    (losses.py:48-71). Accumulates over the small P axis instead of
    building a (B, Bd, P) buffer."""
    B, P = query_positives.shape
    Bd = doc_ids.shape[0]
    mask = torch.zeros((B, Bd), dtype=torch.bool, device=doc_ids.device)
    for p in range(P):
        col = query_positives[:, p:p + 1]
        mask |= (col == doc_ids[None, :]) & (col >= 0)
    diag = torch.eye(B, Bd, dtype=torch.bool, device=doc_ids.device)
    return mask & ~diag


def duplicate_negative_mask(qids: torch.Tensor,
                            doc_ids: torch.Tensor) -> torch.Tensor:
    """Mask repeated docids so each doc scores once per query, off the
    diagonal (losses.py:74-93). A stable sort finds the duplicates; the
    first occurrence survives."""
    n = doc_ids.shape[0]
    sorted_ids, order = torch.sort(doc_ids, stable=True)
    dup_sorted = torch.cat([torch.zeros(1, dtype=torch.bool,
                                        device=doc_ids.device),
                            sorted_ids[1:] == sorted_ids[:-1]])
    dup = torch.zeros(n, dtype=torch.bool, device=doc_ids.device)
    dup[order] = dup_sorted
    B = qids.shape[0]
    diag = torch.eye(B, n, dtype=torch.bool, device=doc_ids.device)
    return dup[None, :].expand(B, n) & ~diag


def _row_ce(query_embeds, doc_embeds, negative_mask, labels, mcq_m: int,
            metric_centroid_cos: bool, temperature: float,
            dynamic_topk_hard_negative: Optional[int]) -> torch.Tensor:
    """Per-query cross-entropy terms (logZ - pos) for a block of query rows
    (losses.py:96-136). labels: (Bq,) global column of each row's
    positive."""
    Bd = doc_embeds.shape[0]
    sims = query_embeds @ doc_embeds.T
    if metric_centroid_cos:
        sims = sims / mcq_m
    # mask BEFORE the temperature: at a small temperature an additive
    # -10000 applied after the division no longer dominates a METRIC_IP
    # similarity, and a masked positive would leak back into the softmax
    sims = sims - NEG_INF_MASK * negative_mask.to(sims.dtype)
    if temperature != 1.0:
        sims = sims / temperature
    if dynamic_topk_hard_negative is not None and dynamic_topk_hard_negative > 0:
        # keep [positive + the k hardest negatives] per row, by -inf; the
        # k-th value is exact (the JAX package asks approx_max_k for
        # recall 1.0, which is exact too), and ties at it are all kept
        col = torch.arange(Bd, device=sims.device)[None, :]
        is_label = col == labels[:, None]
        neg_sims = sims.detach().masked_fill(is_label, float("-inf"))
        kth = neg_sims.topk(dynamic_topk_hard_negative, dim=-1).values[:, -1:]
        sims = sims.masked_fill(~((neg_sims >= kth) | is_label), float("-inf"))
    logz = torch.logsumexp(sims, dim=-1)
    pos = sims.gather(1, labels[:, None])[:, 0]
    return logz - pos


def _auto_q_chunk(B: int, Bd: int) -> int:
    """Largest divisor of B keeping one (qc, Bd) fp32 block <= ~128 MB."""
    budget = 128 * 1024 * 1024 // 4
    qc = B
    while qc > 1 and qc * Bd > budget:
        next_qc = qc - 1
        while next_qc > 1 and B % next_qc != 0:
            next_qc -= 1
        qc = next_qc
    return qc


def contrastive_loss(query_embeds: torch.Tensor, doc_embeds: torch.Tensor,
                     negative_mask: torch.Tensor, mcq_m: int,
                     metric_centroid_cos: bool = False,
                     temperature: float = 1.0,
                     dynamic_topk_hard_negative: Optional[int] = None,
                     q_chunk: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy over the global batch with diagonal labels
    (losses.py:139-184). query_embeds (B, D); doc_embeds (Bd, D), Bd >= B,
    the first B docs being the positives; negative_mask (B, Bd) bool, True
    where a similarity is suppressed.

    Query rows go in chunks under torch.utils.checkpoint (q_chunk=None:
    auto): each row's term needs only its own (1, Bd) score row, so the
    chunking is exact while it bounds the live (B, Bd) buffers."""
    B, Bd = query_embeds.shape[0], doc_embeds.shape[0]
    qc = _auto_q_chunk(B, Bd) if q_chunk is None else round_to_divisor(B, q_chunk)
    labels = torch.arange(B, device=query_embeds.device)
    args = (mcq_m, metric_centroid_cos, temperature,
            dynamic_topk_hard_negative)
    if qc < B:
        def rows(q, docs, mask, lab):
            return _row_ce(q, docs, mask, lab, *args).sum()

        sums = [checkpoint(rows, query_embeds[s:s + qc], doc_embeds,
                           negative_mask[s:s + qc], labels[s:s + qc],
                           use_reentrant=False)
                for s in range(0, B, qc)]
        return torch.stack(sums).sum() / B
    return _row_ce(query_embeds, doc_embeds, negative_mask, labels,
                   *args).mean()


def mse_loss(quantized: torch.Tensor, continuous: torch.Tensor) -> torch.Tensor:
    """Reconstruction MSE, summed over dims, averaged over the batch
    (losses.py:187-190)."""
    return ((quantized - continuous) ** 2).sum(-1).mean()
