"""Top-k helpers shared by the ADC searches (counterpart of
repconc_tpu/index/flat.py:58-108).

The JAX package's `approx_max_k` and `topk_wide` (:21-45) stood in for a
top-k sort that wedged the TPU compiler; here `torch.topk` is exact and
is used directly.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch


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
