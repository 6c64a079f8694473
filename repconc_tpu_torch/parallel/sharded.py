"""Corpus-sharded search and data-parallel encoding across ranks
(counterpart of repconc_tpu/parallel/sharded.py).

The reference replicates its faiss GPU index on every device
(evaluate_repconc.py:121-135, GpuMultipleClonerOptions(shard=False)); here,
as in the JAX package, each rank holds a contiguous shard of the corpus,
ceil(N / W) rows, scans it, and one all_gather of the local top-k lists
and a merge give every rank the global top-k. Index memory scales 1/W.

Each search is two parts, so that one process can run every rank's part
in turn (core/mesh.py::local_mesh) and merge them as the gather would:

  local_search(q, topk) -> (Q, k_l) scores and GLOBAL ids, -inf / -1 pads
  merge_topk(parts, topk) -> the exact global top-k

`gather_merge` is the thin collective between them. The merge orders by
(score DESC, id ASC) through cuda_adc.py::select_topk, as every unsharded
search of the port's kernels does, so a sharded search returns the
unsharded one's scores bit for bit and its ids but for the order of exact
ties. The dense search's matmul stays torch.matmul; `ShardedCudaADCIndex`
scans its shard with K1's two passes (cuda_adc.py::adc_topk).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repconc_tpu_torch.core import distributed
from repconc_tpu_torch.index.adc import build_lut, plain_topk
from repconc_tpu_torch.index.cuda_adc import adc_topk, select_topk
from repconc_tpu_torch.index.flat import fixed_query_batches, flat_topk


def merge_topk(parts_s: Sequence[torch.Tensor], parts_i: Sequence[torch.Tensor],
               topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact top-min(topk, width) of the ranks' (Q, k_l) candidate
    lists by (score DESC, id ASC) (_local_topk_gather_merge, sharded.py:
    262-268); -inf / -1 pads never beat a real candidate. -0.0 becomes
    +0.0 first: select_topk's key would put it below +0.0."""
    s = torch.cat(list(parts_s), 1) + 0.0
    i = torch.cat(list(parts_i), 1)
    return select_topk(s, i, min(topk, s.shape[1]))


def gather(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's t (equal shapes) stacked in rank order, (W, ...). A mesh
    without a process group has only its own part: one rank of a larger
    mesh raises (run each rank's local part and merge_topk instead)."""
    if mesh.group is None:
        if mesh.size != 1:
            raise ValueError(f"rank {mesh.rank} of {mesh.size} has no process "
                             "group to gather over")
        return t[None]
    return distributed.all_gather(t, mesh.group).reshape(
        (mesh.size,) + tuple(t.shape))


def gather_merge(mesh, s: torch.Tensor, i: torch.Tensor, topk: int):
    """all_gather the local candidates, then merge_topk on every rank."""
    return merge_topk(list(gather(mesh, s)), list(gather(mesh, i)), topk)


def _pad_cols(s: torch.Tensor, i: torch.Tensor, k: int):
    """(Q, k) with -inf / -1 past the real columns: equal shapes for the
    gather on every rank, whatever its shard holds."""
    short = k - s.shape[1]
    if short <= 0:
        return s, i
    return (torch.nn.functional.pad(s, (0, short), value=-torch.inf),
            torch.nn.functional.pad(i, (0, short), value=-1))


class _CorpusShard:
    """This rank's contiguous block of N rows: ceil(N / W) rows from
    base = rank * n_local, n_valid of them real (the last ranks may hold
    fewer, or none)."""

    def _shard(self, mesh, rows):
        self.mesh = mesh
        self.N = rows.shape[0]
        self.n_local = -(-self.N // mesh.size)
        self.base = mesh.rank * self.n_local
        self.n_valid = max(0, min(self.N - self.base, self.n_local))
        return rows[self.base:self.base + self.n_valid]

    def _widths(self, topk: int):
        """(global k, local k_l): k_l = min(k, n_local) on every rank, and
        W * k_l >= k, so the merge widens back to k."""
        k = min(topk, self.N)
        return k, min(k, self.n_local)

    def _globalize(self, s, i, k_l):
        return _pad_cols(s, i + self.base, k_l)

    def search_device(self, query_embeds, topk: int = 1000):
        """(scores, row ids) tensors on the mesh's device, each
        (Q, min(topk, N)), the same on every rank."""
        s, i = self.local_search(query_embeds, topk)
        return gather_merge(self.mesh, s, i, min(topk, self.N))

    def search(self, query_embeds, topk: int = 1000):
        s, i = self.search_device(query_embeds, topk)
        return s.cpu().numpy(), i.cpu().numpy()


class ShardedFlatIndex(_CorpusShard):
    """Corpus-sharded exact inner-product index (ShardedFlatIndex,
    sharded.py:110-131): this rank's fp32 rows live on its device once;
    each search is q @ shard.T with a torch.topk per chunk of rows, then
    the merge."""

    def __init__(self, mesh, corpus_embeds, chunk_size: int = 1 << 20):
        rows = self._shard(mesh, corpus_embeds)
        self.corpus = torch.as_tensor(rows).to(mesh.device, torch.float32)
        self.chunk_size = chunk_size

    @torch.no_grad()
    def local_search(self, query_embeds, topk: int = 1000):
        k, k_l = self._widths(topk)
        q = torch.as_tensor(np.asarray(query_embeds, dtype=np.float32)).to(
            self.mesh.device)
        s, i = flat_topk(q, self.corpus, min(k_l, self.n_valid),
                         self.chunk_size)
        return self._globalize(s, i, k_l)


def sharded_flat_search(mesh, query_embeds, corpus_embeds, topk: int = 1000
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact inner-product search with the corpus sharded over the mesh,
    any N, topk wider than a shard included (sharded.py:57-77)."""
    return ShardedFlatIndex(mesh, corpus_embeds).search(query_embeds, topk)


def sharded_batch_flat_search(mesh, query_ids, query_embeds, corpus_ids,
                              corpus_embeds, topk: int,
                              batch_size: int = 1200):
    """batch_flat_search over a ShardedFlatIndex (the dense eval's
    --data_parallel path, run_dense_eval.py:155-158): (scores, docids), the
    same on every rank."""
    index = ShardedFlatIndex(mesh, corpus_embeds)
    k = min(topk, index.N)
    if len(query_ids) == 0:
        return np.zeros((0, k), np.float32), np.zeros((0, k), corpus_ids.dtype)
    all_s, all_i = [], []
    for start in range(0, len(query_ids), batch_size):
        s, i = index.search(query_embeds[start:start + batch_size], topk)
        all_s.append(s)
        all_i.append(corpus_ids[i])
    return np.concatenate(all_s, 0), np.concatenate(all_i, 0)


class ShardedADCIndex(_CorpusShard):
    """Corpus-sharded ADC index with the plain scorer and an fp32 LUT
    (ShardedADCIndex, sharded.py:134-163): the search of the CPU, as
    index/adc.py::adc_search is the unsharded one's."""

    def __init__(self, mesh, codes, centroids):
        rows = self._shard(mesh, codes)
        self.codes = torch.as_tensor(rows).to(mesh.device, torch.uint8)
        self.set_centroids(centroids)

    def set_centroids(self, centroids) -> None:
        self.centroids = torch.as_tensor(centroids, dtype=torch.float32,
                                         device=self.mesh.device)

    @torch.no_grad()
    def local_search(self, query_embeds, topk: int = 1000):
        k, k_l = self._widths(topk)
        q = torch.as_tensor(query_embeds, dtype=torch.float32,
                            device=self.mesh.device)
        s, i = plain_topk(build_lut(q, self.centroids), self.codes,
                          self.n_valid, min(k_l, self.n_valid))
        return self._globalize(s, i, k_l)


def sharded_adc_search(mesh, query_embeds, codes, centroids,
                       topk: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
    """ADC top-k with the codes sharded over the corpus (sharded.py:
    166-181); inside a serving loop build the index once instead."""
    return ShardedADCIndex(mesh, codes, centroids).search(query_embeds, topk)


class ShardedCudaADCIndex(_CorpusShard):
    """Corpus-sharded K1 index (ShardedPallasADCIndex, sharded.py:184-259):
    this rank's ceil(N / W) rows of uint8 codes on its device once; each
    search rounds the fp32 LUT to bf16, scans the shard's n_valid real rows
    with adc_topk (K1's two passes on a CUDA device, their plain versions
    on the CPU), adds base = rank * n_local to the ids and merges."""

    def __init__(self, mesh, codes, centroids):
        rows = self._shard(mesh, codes)
        self.codes = torch.zeros((self.n_local, codes.shape[1]),
                                 dtype=torch.uint8, device=mesh.device)
        self.codes[:self.n_valid] = torch.as_tensor(rows).to(mesh.device)
        self.set_centroids(centroids)

    def set_centroids(self, centroids) -> None:
        """Swap codebooks (the query model's centroids)."""
        self.centroids = torch.as_tensor(centroids, dtype=torch.float32,
                                         device=self.mesh.device)

    @torch.no_grad()
    def local_search(self, query_embeds, topk: int = 1000):
        k, k_l = self._widths(topk)
        q = torch.as_tensor(query_embeds, dtype=torch.float32,
                            device=self.mesh.device)
        lut = build_lut(q, self.centroids).to(torch.bfloat16).contiguous()
        s, i = adc_topk(lut, self.codes, self.n_valid, k_l)
        return self._globalize(s, i, k_l)


def sharded_batch_adc_search(mesh, query_embeds, codes, centroids,
                             topk: int = 1000, batch_size: int = 1200
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Query-batched corpus-sharded ADC search, the eval CLIs'
    --data_parallel path (sharded.py:271-297): query chunks of batch_size,
    the short last chunk zero-padded. A CUDA mesh scans its shard with K1
    (ShardedCudaADCIndex), the CPU with the fp32 plain scorer
    (ShardedADCIndex), as batch_adc_search dispatches. Returns numpy
    (scores, ROW ids), the same on every rank."""
    index_cls = (ShardedCudaADCIndex if mesh.device.type == "cuda"
                 else ShardedADCIndex)
    searcher = index_cls(mesh, codes, centroids)
    k = min(topk, codes.shape[0])
    if len(query_embeds) == 0:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
    all_s, all_i = [], []
    for qc, real in fixed_query_batches(query_embeds, batch_size):
        s, i = searcher.search(qc, topk=topk)
        all_s.append(s[:real])
        all_i.append(i[:real])
    return np.concatenate(all_s, 0), np.concatenate(all_i, 0)


def sharded_encode(mesh, encode_fn: Callable, ids: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """encode_fn(ids, mask) over the mesh (sharded_encode_fn, sharded.py:
    300-308): each rank encodes its contiguous block of the batch, the
    blocks padded to ceil(B / W) rows with copies of the last row (the
    gather needs equal shapes), and a gather in rank order gives every rank
    the whole batch's output."""
    W = mesh.size
    if W == 1 and mesh.group is None:
        return encode_fn(ids, mask)
    B = ids.shape[0]
    per = -(-B // W)
    pad = per * W - B
    if pad:
        ids = torch.cat([ids, ids[-1:].expand(pad, -1)])
        mask = torch.cat([mask, mask[-1:].expand(pad, -1)])
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    out = encode_fn(ids[rows], mask[rows])
    return gather(mesh, out).reshape((W * per,) + tuple(out.shape[1:]))[:B]

