"""OPQ warm-up: a RepCONC model's rotation and centroids from dense corpus
embeddings (counterpart of repconc_tpu/train/warmup.py:26-75; reference:
the faiss warm-up of train/run_warmup.py:85-132).

OPQ is fitted on a subsample of the corpus, its rotation and centroids are
installed into the model, and the whole corpus is encoded into the warm-up
index's codes. The corpus may be a host array, streamed to the device a
chunk at a time as the JAX package streams it, or a tensor already on the
device: an H100 holds MS MARCO's 8.8 M x 768 fp32 embeddings (27.2 GB).
"""
from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from repconc_tpu_torch.core.config import METRIC_CENTROID_COS
from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.core.profiling import Stopwatch
from repconc_tpu_torch.index.kmeans import (pq_encode_chunked,
                                            subsample_for_training)
from repconc_tpu_torch.index.opq import opq_fit
from repconc_tpu_torch.quant import codebook

logger = logging.getLogger(__name__)


@torch.no_grad()
def warmup_from_embeds(corpus_embeds, model, max_train_points: int = 1 << 18,
                       outer_iters: int = 20, pq_iters: int = 4,
                       final_pq_iters: int = 25, seed: int = 2022,
                       encode_chunk: int = 1 << 16, device="cuda",
                       stopwatch: Stopwatch = None
                       ) -> Tuple[object, np.ndarray]:
    """Fit OPQ on `device`, set the model's rotation and centroids in place
    and encode the corpus. Returns (model, codes (N, M) uint8).
    `stopwatch` collects the phases opq_fit and encode."""
    dev = resolve_device(device)
    sw = stopwatch if stopwatch is not None else Stopwatch()
    config = model.config
    M, K = config.MCQ_M, config.MCQ_K
    mcc = config.similarity_metric == METRIC_CENTROID_COS
    with sw("opq_fit"):
        train = torch.as_tensor(subsample_for_training(
            corpus_embeds, max_train_points, seed)).to(dev, torch.float32)
        logger.info("OPQ training on %d points (corpus %d), M=%d K=%d",
                    len(train), len(corpus_embeds), M, K)
        rotation, centroids, mse = opq_fit(
            train, M=M, K=K, outer_iters=outer_iters, pq_iters=pq_iters,
            final_pq_iters=final_pq_iters, seed=seed)
        # float() waits for the device, so the phase holds the whole fit
        logger.info("OPQ warmup reconstruction mse (sum over subspaces): "
                    "%.4f", float(mse.sum()))
    del train
    if mcc:
        centroids = codebook.normalize_centroids(centroids)
    model.rotation.copy_(rotation)
    model.centroids.copy_(centroids)

    with sw("encode"):
        codes = np.empty((len(corpus_embeds), M), dtype=np.uint8)
        for start in range(0, len(corpus_embeds), encode_chunk):
            chunk = torch.as_tensor(corpus_embeds[start:start + encode_chunk]
                                    ).to(dev, torch.float32) @ rotation.T
            if mcc:
                chunk = codebook.normalize_subvectors(chunk, M)
            codes[start:start + len(chunk)] = pq_encode_chunked(
                chunk, centroids, chunk=encode_chunk, device=dev)
    return model, codes
