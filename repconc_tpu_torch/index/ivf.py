"""IVF-PQ: the inverted file over the PQ code store (counterpart of
repconc_tpu/index/ivf.py:40-459).

* Coarse quantizer: k-means over PQ reconstructions (or dense embeddings),
  nlist cells; no residual encoding, so the PQ codes are the flat index's
  and the stage-2 centroid swap works unchanged: the IVF only prunes.
* Layout: every cell's posting list is padded to one Lpad (a quantile of
  the list lengths, capped at 4x the mean, rounded up to 128); docs past
  Lpad go to a spill segment that every query brute-forces, so results are
  exact with respect to the probed cells.
* Probing: the top-nprobe cells by q.c - ||c||^2 / 2, in fp32 with TF32 off.

`ivf_index.npz` has the JAX package's keys, so either package loads the
other's file. Searches: `search_xla`, the exact fp32-LUT reference (plain
torch, any device), and `serve_search`, which takes the cell-grouped
kernels of index/cuda_ivf.py on a CUDA device.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.core.profiling import Stopwatch
from repconc_tpu_torch.index.adc import adc_search, build_lut
from repconc_tpu_torch.index.kmeans import (assign, balanced_kmeans_fit,
                                            kmeans_fit,
                                            subsample_for_training)
from repconc_tpu_torch.quant.codebook import decode_gather

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class IVFIndex:
    """Host-side container (numpy); device copies are made on demand."""

    coarse_centroids: np.ndarray   # (nlist, D) f32
    cell_codes: np.ndarray         # (nlist, Lpad, M) uint8, padded
    cell_ids: np.ndarray           # (nlist, Lpad) int32, -1 = pad
    cell_sizes: np.ndarray         # (nlist,) int32 (true sizes, <= Lpad)
    spill_codes: np.ndarray        # (S, M) uint8 (overflow docs)
    spill_ids: np.ndarray          # (S,) int32
    centroids: np.ndarray          # (M, K, dsub) f32 PQ codebook

    @property
    def nlist(self) -> int:
        return self.coarse_centroids.shape[0]

    @property
    def Lpad(self) -> int:
        return self.cell_codes.shape[1]

    @property
    def ntotal(self) -> int:
        return int(self.cell_sizes.sum()) + len(self.spill_ids)

    def set_centroids(self, centroids) -> None:
        """Stage-2 codebook swap: replace the array, drop device copies."""
        self.centroids = np.asarray(centroids, dtype=np.float32)
        self._dev = None

    def device_arrays(self, device="cuda"):
        """(centroids, coarse, cell_codes, cell_ids) as tensors on `device`,
        copied once per device and codebook."""
        dev = resolve_device(device)
        cached = getattr(self, "_dev", None)
        if cached is None or cached[0] != dev:
            self._dev = (dev, tuple(torch.as_tensor(a, device=dev) for a in (
                np.asarray(self.centroids, dtype=np.float32),
                np.asarray(self.coarse_centroids, dtype=np.float32),
                self.cell_codes, self.cell_ids)))
        return self._dev[1]

    def save(self, out_dir: str) -> None:
        """Atomic write of ivf_index.npz: a crash leaves no partial file
        under the final name."""
        os.makedirs(out_dir, exist_ok=True)
        tmp = os.path.join(out_dir, "ivf_index.tmp.npz")
        np.savez(tmp, **{f.name: getattr(self, f.name)
                         for f in dataclasses.fields(self)})
        os.replace(tmp, os.path.join(out_dir, "ivf_index.npz"))

    @classmethod
    def load(cls, load_dir: str) -> "IVFIndex":
        z = np.load(os.path.join(load_dir, "ivf_index.npz"))
        return cls(**{k: z[k] for k in z.files})


def _rows(codes, idx, device) -> torch.Tensor:
    """codes[idx] as a tensor on `device`; codes is numpy or a tensor."""
    if torch.is_tensor(codes):
        if isinstance(idx, np.ndarray):
            idx = torch.as_tensor(idx, device=codes.device)
        return codes[idx].to(device)
    return torch.as_tensor(np.asarray(codes[idx]), device=device)


class ReconstructionView:
    """Lazy (N, D) fp32 view over PQ codes, decoded on `device` on demand,
    so the IVF builds from the codes alone (ivf.py:107-143): at MS MARCO
    scale the fp32 embeddings are ~27 GB and the codes 0.1-0.4 GB. codes is
    a numpy array or a tensor (then it may already lie on the device)."""

    def __init__(self, codes, pq_centroids, device="cuda"):
        self.device = resolve_device(device)
        self._codes = codes
        self._cent = torch.as_tensor(np.asarray(pq_centroids, np.float32),
                                     device=self.device)
        self.shape = (codes.shape[0],
                      pq_centroids.shape[0] * pq_centroids.shape[2])

    def decode_device(self, idx) -> torch.Tensor:
        """Rows `idx` decoded, left on the device."""
        return decode_gather(_rows(self._codes, idx, self.device), self._cent)


def _decode_assign(codes_u8: torch.Tensor, pq_cent: torch.Tensor,
                   coarse: torch.Tensor) -> torch.Tensor:
    """Coarse cells of PQ reconstructions, decoded and assigned on the
    device (ivf.py:146-155)."""
    return assign(decode_gather(codes_u8, pq_cent), coarse)


def build_ivf_from_codes(codes: np.ndarray, pq_centroids: np.ndarray,
                         **kwargs) -> IVFIndex:
    """build_ivf from the uint8 codes alone: the coarse quantizer trains
    on and assigns PQ reconstructions decoded on the device."""
    device = kwargs.pop("device", "cuda")
    return build_ivf(ReconstructionView(codes, pq_centroids, device), codes,
                     pq_centroids, device=device, **kwargs)


def assign_cells(corpus_embeds, coarse: torch.Tensor,
                 assign_chunk: int = 1 << 16) -> torch.Tensor:
    """Nearest coarse cell (N,) int64 of every doc, chunked, on coarse's
    device; a ReconstructionView decodes each chunk there first."""
    N = corpus_embeds.shape[0]
    dev = coarse.device
    cells = torch.empty(N, dtype=torch.long, device=dev)
    is_view = isinstance(corpus_embeds, ReconstructionView)
    for start in range(0, N, assign_chunk):
        stop = min(start + assign_chunk, N)
        if is_view:
            chunk = _rows(corpus_embeds._codes, slice(start, stop), dev)
            cells[start:stop] = _decode_assign(chunk, corpus_embeds._cent, coarse)
        else:
            chunk = torch.as_tensor(np.asarray(corpus_embeds[start:stop],
                                               dtype=np.float32), device=dev)
            cells[start:stop] = assign(chunk, coarse)
    return cells


def fill_cells(cells: torch.Tensor, codes, nlist: int,
               pad_quantile: float = 0.995):
    """Posting lists from each doc's cell (ivf.py:230-269), on cells'
    device: Lpad is the pad_quantile of the list sizes, capped at 4x the
    mean and rounded up to 128; a stable sort by cell gives each doc its
    rank in its cell; ranks >= Lpad form the spill segment. Returns numpy
    (cell_codes, cell_ids, cell_sizes, spill_codes, spill_ids)."""
    dev = cells.device
    N = cells.shape[0]
    codes = torch.as_tensor(codes, device=dev)
    M = codes.shape[1]
    sizes = torch.bincount(cells, minlength=nlist).cpu().numpy()
    Lpad = int(np.quantile(sizes, pad_quantile))
    Lpad = min(Lpad, int(4 * max(sizes.mean(), 1)))
    Lpad = max(int(np.ceil(Lpad / 128.0)) * 128, 128)
    logger.info("list sizes: mean %.1f max %d -> Lpad %d",
                sizes.mean(), sizes.max(), Lpad)
    order = torch.sort(cells, stable=True).indices
    sorted_cells = cells[order]
    boundaries = torch.searchsorted(
        sorted_cells, torch.arange(nlist + 1, device=dev))
    ranks = torch.arange(N, device=dev) - boundaries[sorted_cells]
    kept = ranks < Lpad
    cell_codes = torch.zeros((nlist, Lpad, M), dtype=torch.uint8, device=dev)
    cell_ids = torch.full((nlist, Lpad), -1, dtype=torch.int32, device=dev)
    cell_codes[sorted_cells[kept], ranks[kept]] = codes[order[kept]]
    cell_ids[sorted_cells[kept], ranks[kept]] = order[kept].to(torch.int32)
    spill_ids = order[~kept]
    logger.info("spill segment: %d docs (%.3f%%)", len(spill_ids),
                100.0 * len(spill_ids) / max(N, 1))
    return (cell_codes.cpu().numpy(), cell_ids.cpu().numpy(),
            np.minimum(sizes, Lpad).astype(np.int32),
            codes[spill_ids].cpu().numpy().reshape(-1, M),
            spill_ids.to(torch.int32).cpu().numpy())


def build_ivf(corpus_embeds, codes: np.ndarray, pq_centroids: np.ndarray,
              nlist: int = 4096, pad_quantile: float = 0.995,
              kmeans_iters: int = 20, max_train_points: int = 1 << 18,
              seed: int = 2022, assign_chunk: int = 1 << 16,
              balanced: bool = False, device="cuda",
              stopwatch: Optional[Stopwatch] = None) -> IVFIndex:
    """Build the inverted file (ivf.py:158-269) on `device`.

    corpus_embeds: (N, D) embeddings in the PQ codes' (rotated) space, or a
    ReconstructionView; codes: (N, M) uint8; pq_centroids: (M, K, dsub).
    The training subsample's rows equal the JAX package's at the same seed;
    the k-means++ draws do not (torch's generator). balanced=True trains
    the coarse quantizer with balanced_kmeans_fit (the Sinkhorn
    uniform-assignment constraint): more even lists, so less spill; the
    docs are then assigned to their nearest cell, and Lpad and the spill
    follow as for the plain build. `stopwatch` collects the
    phases ivf_kmeans, ivf_assign and ivf_fill.
    """
    dev = resolve_device(device)
    sw = stopwatch if stopwatch is not None else Stopwatch()
    N = corpus_embeds.shape[0]
    nlist = min(nlist, N)
    is_view = isinstance(corpus_embeds, ReconstructionView)
    with sw("ivf_kmeans"):
        if is_view:  # subsample the codes, as subsample_for_training draws
            idx = slice(None)
            if N > max_train_points:
                rng = np.random.default_rng(seed)
                idx = np.sort(rng.choice(N, size=max_train_points,
                                         replace=False))
            train = corpus_embeds.decode_device(idx)
        else:
            train = torch.as_tensor(np.asarray(subsample_for_training(
                corpus_embeds, max_train_points, seed), dtype=np.float32),
                device=dev)
        logger.info("IVF coarse k-means: nlist=%d on %d train points "
                    "(balanced=%s)", nlist, len(train), balanced)
        fit = balanced_kmeans_fit if balanced else kmeans_fit
        coarse, _ = fit(train, nlist, iters=kmeans_iters, seed=seed)
        del train
        coarse_np = coarse.cpu().numpy()
    with sw("ivf_assign"):
        cells = assign_cells(corpus_embeds, coarse, assign_chunk)
        cells.cpu()  # wait for the device
    with sw("ivf_fill"):
        cell_codes, cell_ids, sizes, spill_codes, spill_ids = fill_cells(
            cells, codes, nlist, pad_quantile)
    return IVFIndex(coarse_centroids=coarse_np, cell_codes=cell_codes,
                    cell_ids=cell_ids, cell_sizes=sizes,
                    spill_codes=spill_codes, spill_ids=spill_ids,
                    centroids=np.asarray(pq_centroids, dtype=np.float32))


def probe_cells(query_embeds: torch.Tensor, coarse: torch.Tensor,
                nprobe: int) -> torch.Tensor:
    """Top-nprobe cells (Q, nprobe) int64 per query by q.c - ||c||^2 / 2,
    fp32 with TF32 off (ivf.py:272-289), exact torch.topk, best first."""
    score = query_embeds @ coarse.T - 0.5 * (coarse * coarse).sum(-1)[None, :]
    nlist = score.shape[1]
    if nprobe >= nlist:
        return torch.arange(nlist, device=score.device).expand(
            score.shape[0], nlist)
    return torch.topk(score, nprobe, dim=1).indices


def _ivf_search_chunk_xla(lut, cells, cell_codes, cell_ids, topk: int):
    """Exact scan of the probed cells with an fp32 LUT (ivf.py:292-326):
    gathers per query, f32 adds in m order, pad slots at -inf."""
    Qc, nprobe = cells.shape
    _, Lpad, M = cell_codes.shape
    codes_g = cell_codes[cells].reshape(Qc, nprobe * Lpad, M).long()
    ids = cell_ids[cells].reshape(Qc, nprobe * Lpad)
    acc = torch.zeros(ids.shape, dtype=torch.float32, device=lut.device)
    for m in range(M):
        acc += torch.gather(lut[:, m, :], 1, codes_g[:, :, m])
    acc = torch.where(ids >= 0, acc, -torch.inf)
    s, pos = torch.topk(acc, min(topk, acc.shape[1]), dim=1)
    return s, torch.gather(ids, 1, pos)


@torch.no_grad()
def search_xla(index: IVFIndex, query_embeds, topk: int = 1000,
               nprobe: int = 64, query_chunk: int = 128, device="cuda"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference IVF search (ivf.py:329-374): exact fp32 LUT, plain torch.
    Returns numpy (scores, doc ROW ids into the corpus as built); pad slots
    come back as -inf with id -1. The name is the JAX package's: here it
    means the plain path, on whatever device is asked."""
    dev = resolve_device(device)
    nprobe = min(nprobe, index.nlist)
    cent, coarse, cell_codes, cell_ids = index.device_arrays(dev)
    q = torch.as_tensor(np.asarray(query_embeds, dtype=np.float32), device=dev)
    all_s, all_i = [], []
    for start in range(0, q.shape[0], query_chunk):
        qc = q[start:start + query_chunk]
        s, i = _ivf_search_chunk_xla(build_lut(qc, cent),
                                     probe_cells(qc, coarse, nprobe),
                                     cell_codes, cell_ids, topk)
        all_s.append(s.cpu().numpy())
        all_i.append(i.cpu().numpy())
    scores = np.concatenate(all_s, axis=0)
    ids = np.concatenate(all_i, axis=0)
    if len(index.spill_ids):
        s_sp, i_sp = adc_search(query_embeds, index.spill_codes,
                                index.centroids,
                                topk=min(topk, len(index.spill_ids)),
                                device=dev)
        scores = np.concatenate([scores, s_sp], axis=1)
        ids = np.concatenate([ids, index.spill_ids[i_sp]], axis=1)
        order = np.argsort(-scores, axis=1)[:, :topk]
        scores = np.take_along_axis(scores, order, axis=1)
        ids = np.take_along_axis(ids, order, axis=1)
    return scores, ids


def serve_search(index: IVFIndex, query_embeds, topk: int = 1000,
                 nprobe: int = 64, search_batch: int = 1200,
                 mode: str = "auto", mesh=None, lut_dtype: str = "bf16",
                 serving: str = "adc", device="cuda"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The IVF serving path of the eval CLI (ivf.py:377-459). Returns numpy
    (scores, doc row ids).

    mode keeps the JAX package's names. In the port:
      "auto"   - the cell-grouped kernels (CudaIVFIndex) on a CUDA device,
                 search_xla on the CPU, as the JAX package takes Pallas on
                 the TPU and XLA elsewhere;
      "pallas" - the cell-grouped path forced: the two passes of
                 cuda_ivf.ivf_topk (K2's scan with a bf16 LUT, K3's with
                 int8) on a CUDA device, their plain versions on the CPU;
      "xla"    - search_xla, the exact fp32-LUT scan; lut_dtype and
                 serving do not apply (a warning says so).
    serving: "adc" (the code store), or decoded residency with the cell-
    grouped path, "decoded" (bf16 reconstructions resident) or
    "decoded_int8" (int8 reconstructions and a per-dimension scale); the
    decoded scorers are torch ops, so they run on the CPU too.
    Queries go in search_batch chunks, the short last chunk zero-padded, as
    in the JAX package.
    mesh (core/mesh.py): serve from the cells this rank owns
    (cuda_ivf.ShardedCudaIVFIndex), every rank taking part and getting the
    whole result; "auto" is then the cell-grouped path on every device, on
    the CPU the passes' plain versions. mode="xla" has no cell-sharded
    scan and raises, as a mesh never serves the unsharded index; the
    device is the mesh's.
    """
    serving = serving or "adc"
    if serving not in ("adc", "decoded", "decoded_int8"):
        raise ValueError(f"serving must be adc, decoded or decoded_int8, not "
                         f"{serving!r}")
    if lut_dtype not in ("bf16", "int8"):
        raise ValueError(f"lut_dtype must be bf16 or int8, not {lut_dtype!r}")
    dev = resolve_device(device) if mesh is None else mesh.device
    if mode == "auto":
        mode = "pallas" if dev.type == "cuda" or mesh is not None else "xla"
    if mode == "xla" and mesh is not None:
        raise ValueError("serve_search: mode='xla' has no cell-sharded "
                         "variant; under a mesh take mode auto or pallas")
    if mode == "xla":
        if lut_dtype != "bf16":
            logger.warning("serve_search: lut_dtype=%s applies to the "
                           "cell-grouped path only; the xla scan scores "
                           "exact fp32 LUTs", lut_dtype)
        if serving != "adc":
            logger.warning("serve_search: serving=%s applies to the "
                           "cell-grouped path only; the xla scan serves from "
                           "the code store (exact scores)", serving)
        return search_xla(index, query_embeds, topk=topk, nprobe=nprobe,
                          device=dev)
    if mode != "pallas":
        raise ValueError(f"mode must be auto, pallas or xla, not {mode!r}")
    from repconc_tpu_torch.index.cuda_ivf import (CudaIVFIndex,
                                                 ShardedCudaIVFIndex)

    searcher = (CudaIVFIndex(index, serving=serving, device=dev)
                if mesh is None else
                ShardedCudaIVFIndex(mesh, index, serving=serving))
    Q = len(query_embeds)
    if Q == 0:
        return (np.zeros((0, topk), np.float32), np.zeros((0, topk), np.int64))
    search_batch = min(search_batch, Q)
    all_s, all_i = [], []
    for start in range(0, Q, search_batch):
        qc = np.asarray(query_embeds[start:start + search_batch],
                        dtype=np.float32)
        real = qc.shape[0]
        if real < search_batch:
            qc = np.pad(qc, ((0, search_batch - real), (0, 0)))
        s, i = searcher.search(qc, topk=topk, nprobe=nprobe,
                               lut_dtype=lut_dtype)
        all_s.append(s[:real])
        all_i.append(i[:real])
    return np.concatenate(all_s, axis=0), np.concatenate(all_i, axis=0)
