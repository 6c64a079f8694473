"""K2 and K3 on Hopper: cell-grouped IVF-PQ serving (counterpart of the
host side of repconc_tpu/index/pallas_ivf.py:149-385,897-1028).

The batch is grouped by cell: every (query, probed cell) pair gets a slot
in a work tile of QT_G query slots that all score one cell, so each tile
reads its cell's codes once for up to QT_G queries. `score_work_tiles`
wraps the kernels of csrc/ivf_scan.cu: K2 (bf16 LUT) replaces
`_ivf_kernel` (pallas_ivf.py:90-109) and K3 (int8 LUT) replaces
`_ivf_kernel_i8` (:112-142). The spill segment is brute-forced with
`CudaADCIndex` (K1, bf16 LUT) and merged, with either LUT type for the
cells, as the JAX package does.

The TPU sized a static tile grid T_max from `_tile_budget` because XLA
needs static shapes, and searched again at the worst-case shape when pairs
overflowed it (:1016-1028). PyTorch has no such constraint, so the grid
here is exact: T = sum_c ceil(count_c / QT_G), one device-to-host read of
one integer per batch. No pair can overflow and there is no retry.
`group_pairs` still takes a T_max and counts the overflow, as the JAX
function does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repconc_tpu_torch import build
from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.index.adc import build_lut, group_size, quantize_lut_int8
from repconc_tpu_torch.index.cuda_adc import CudaADCIndex
from repconc_tpu_torch.index.ivf import IVFIndex, probe_cells

SOURCE = "ivf_scan.cu"
QT_G = 32  # query slots per work tile (the kernel's warp-wide slot ballot)


def group_pairs(cells: torch.Tensor, Q: int, nlist: int, nprobe: int,
                T_max: Optional[int] = None):
    """Sort-free grouping of the (query, cell) probe pairs into work tiles
    (pallas_ivf.py:268-311).

    Cells within one query are distinct, so a pair's rank inside its cell
    is the number of earlier queries that probed the cell: an exclusive
    cumsum over the (Q, nlist) 0/1 incidence matrix. Tiles are laid out
    cell-ascending, queries in order within a cell.

    cells: (Q, nprobe) int. T_max=None sizes the grid exactly (one
    device-to-host read). Returns (row, work_cell, qidx, overflow):
      row (Q * nprobe,) int64 - each pair's slot row (tile * QT_G + slot),
        q-major;
      work_cell (T_max,) int32 - tile -> cell (0 for unused tiles);
      qidx (T_max, QT_G) int32 - slot -> query, Q for an empty slot;
      overflow - a 0-dim tensor, the pairs whose tile fell past T_max
        (dropped); always 0 with the exact grid.
    """
    dev = cells.device
    pair_cell = cells.reshape(-1).long()
    pair_q = torch.arange(Q, device=dev).repeat_interleave(nprobe)
    incidence = torch.zeros((Q, nlist), dtype=torch.int32, device=dev)
    incidence[pair_q, pair_cell] = 1
    counts = incidence.sum(0)
    before = torch.cumsum(incidence, 0, dtype=torch.int32) - incidence
    rank = before.reshape(-1)[pair_q * nlist + pair_cell].long()
    tiles_per_cell = (counts + QT_G - 1) // QT_G
    if T_max is None:
        T_max = int(tiles_per_cell.sum())
    tiles_before = (torch.cumsum(tiles_per_cell, 0) - tiles_per_cell).long()
    work_id = tiles_before[pair_cell] + rank // QT_G
    fits = work_id < T_max
    overflow = (~fits).sum()
    row = work_id * QT_G + rank % QT_G
    work_cell = torch.zeros(T_max, dtype=torch.int32, device=dev)
    work_cell[work_id[fits]] = pair_cell[fits].to(torch.int32)
    qidx = torch.full((T_max * QT_G,), Q, dtype=torch.int32, device=dev)
    qidx[row[fits]] = pair_q[fits].to(torch.int32)
    return row, work_cell, qidx.reshape(T_max, QT_G), overflow


def score_work_tiles_reference(work_cell: torch.Tensor, qidx: torch.Tensor,
                               lut_z: torch.Tensor, cell_codes: torch.Tensor,
                               scales_z: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version of K2 / K3: (T, QT_G, Lpad) f32 with
    out[t, s, l] = sum_m lut_z[qidx[t, s], m, cell_codes[work_cell[t], l, m]],
    a gather and an add per m, in m order (bf16 LUT); or with an int8 LUT
    and scales_z (Qz, G), per group an int32 sum then
    acc = acc + part * scale in f32, g in order. Empty slots index the zero
    row Qz - 1 and come out 0; codes above K - 1 clamp to K - 1."""
    Qz, M, K = lut_z.shape
    q = qidx.long()
    q = torch.where((q >= 0) & (q < Qz - 1), q, Qz - 1)[:, :, None]  # (T, S, 1)
    tile_codes = cell_codes[work_cell.long()].long().clamp(max=K - 1)
    shape = (q.shape[0], q.shape[1], cell_codes.shape[1])

    def lookup(table, m):
        return table[:, m][q, tile_codes[:, None, :, m]]      # (T, S, Lpad)

    if scales_z is None:
        lut = lut_z.float()
        acc = torch.zeros(shape, dtype=torch.float32, device=lut.device)
        for m in range(M):
            acc += lookup(lut, m)
        return acc
    lut = lut_z.to(torch.int32)
    G = scales_z.shape[1]
    gm = M // G
    acc = torch.zeros(shape, dtype=torch.float32, device=lut.device)
    for g in range(G):
        part = torch.zeros(shape, dtype=torch.int32, device=lut.device)
        for m in range(g * gm, (g + 1) * gm):
            part += lookup(lut, m)
        acc = acc + part.float() * scales_z[:, g][q]
    return acc


def _scan_fns():
    """The kernels' C entry points, with their argument types declared."""
    lib = build.load_library(SOURCE)
    bf16, i8 = lib.repconc_ivf_scan_bf16, lib.repconc_ivf_scan_i8
    ints = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
    bf16.argtypes = [ctypes.c_void_p] * 5 + ints + [ctypes.c_void_p]
    i8.argtypes = [ctypes.c_void_p] * 6 + ints + [ctypes.c_int, ctypes.c_void_p]
    bf16.restype = i8.restype = ctypes.c_int
    return bf16, i8


def score_work_tiles(work_cell: torch.Tensor, qidx: torch.Tensor,
                     lut_z: torch.Tensor, cell_codes: torch.Tensor,
                     scales_z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Score every work tile: (T, QT_G, Lpad) f32 (pallas_ivf.py:149-225).

    work_cell (T,) int32; qidx (T, QT_G) int32, Qz - 1 for an empty slot;
    lut_z (Qz, M, K) with K <= 256, bf16 (K2) or int8 with scales_z
    (Qz, G) f32 (K3), its last row zero; cell_codes (nlist, Lpad, M) uint8;
    all contiguous on one device. A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes the plain version,
    score_work_tiles_reference. Each launch adds one to
    score_work_tiles.launches["bf16"] or ["int8"].
    """
    int8 = scales_z is not None
    if (work_cell.dim() != 1 or qidx.shape != (work_cell.shape[0], QT_G)
            or lut_z.dim() != 3 or cell_codes.dim() != 3
            or cell_codes.shape[2] != lut_z.shape[1]):
        raise ValueError(
            f"work_cell {tuple(work_cell.shape)}, qidx {tuple(qidx.shape)}, "
            f"lut {tuple(lut_z.shape)} and codes {tuple(cell_codes.shape)} do "
            f"not fit (T,), (T, {QT_G}), (Qz, M, K), (nlist, Lpad, M)")
    Qz, M, K = lut_z.shape
    want = torch.int8 if int8 else torch.bfloat16
    if (lut_z.dtype != want or work_cell.dtype != torch.int32
            or qidx.dtype != torch.int32 or cell_codes.dtype != torch.uint8):
        raise TypeError(f"want a {want} lut, int32 work_cell and qidx and "
                        f"uint8 codes, got {lut_z.dtype}, {work_cell.dtype}, "
                        f"{qidx.dtype} and {cell_codes.dtype}")
    tensors = [work_cell, qidx, lut_z, cell_codes]
    if int8:
        if (scales_z.dtype != torch.float32 or scales_z.dim() != 2
                or scales_z.shape[0] != Qz or M % scales_z.shape[1] != 0):
            raise ValueError(f"scales {tuple(scales_z.shape)} "
                             f"{scales_z.dtype} do not fit (Qz={Qz}, G) f32")
        tensors.append(scales_z)
    if K > 256:
        raise ValueError(f"K={K} > 256 does not fit uint8 codes")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("score_work_tiles needs contiguous inputs")
    dev = lut_z.device
    if dev.type == "cpu":
        return score_work_tiles_reference(work_cell, qidx, lut_z, cell_codes,
                                          scales_z)
    if dev.type != "cuda":
        raise ValueError(f"score_work_tiles runs on cuda or cpu, not {dev}")
    T = work_cell.shape[0]
    nlist, Lpad, _ = cell_codes.shape
    out = torch.empty((T, QT_G, Lpad), dtype=torch.float32, device=dev)
    fn_bf16, fn_i8 = _scan_fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if int8:
            err = fn_i8(lut_z.data_ptr(), scales_z.data_ptr(),
                        work_cell.data_ptr(), qidx.data_ptr(),
                        cell_codes.data_ptr(), out.data_ptr(), T, Qz, nlist,
                        Lpad, M, K, M // scales_z.shape[1], stream)
        else:
            err = fn_bf16(lut_z.data_ptr(), work_cell.data_ptr(),
                          qidx.data_ptr(), cell_codes.data_ptr(),
                          out.data_ptr(), T, Qz, nlist, Lpad, M, K, stream)
    kind = "int8" if int8 else "bf16"
    if err != 0:
        raise RuntimeError(f"ivf_scan ({kind}) launch failed: cudaError {err} "
                           f"(T={T}, Qz={Qz}, nlist={nlist}, Lpad={Lpad}, "
                           f"M={M}, K={K})")
    score_work_tiles.launches[kind] += 1
    return out


score_work_tiles.launches = {"bf16": 0, "int8": 0}


def regroup_topk(scores_flat: torch.Tensor, row: torch.Tensor,
                 cells: torch.Tensor, cell_ids: torch.Tensor, Q: int,
                 nprobe: int, topk: int):
    """Each query's candidate rows gathered back (row is q-major, so this
    is a reshape), pad slots and overflowed pairs at -inf, exact top-k
    (pallas_ivf.py:314-336). Returns (scores, ids) on the device, ids -1
    for a pad."""
    Lpad = cell_ids.shape[1]
    n_rows = scores_flat.shape[0]
    row_ok = (row < n_rows).reshape(Q, nprobe, 1)
    cand = scores_flat[row.clamp(max=n_rows - 1)].reshape(Q, nprobe, Lpad)
    cand = torch.where(row_ok, cand, -torch.inf).reshape(Q, nprobe * Lpad)
    ids = cell_ids[cells.reshape(-1).long()].reshape(Q, nprobe * Lpad)
    cand = torch.where(ids >= 0, cand, -torch.inf)
    s, pos = torch.topk(cand, min(topk, cand.shape[1]), dim=1)
    return s, torch.gather(ids, 1, pos)


def make_lut_z(query_embeds: torch.Tensor, pq_centroids: torch.Tensor,
               lut_dtype: str = "bf16"):
    """(lut_z, scales_z): the (Q + 1, M, K) LUT with a zero row at Q for
    the empty slots, bf16 (scales_z None) or int8 with its (Q + 1, G)
    scales (gm as group_size picks it)."""
    lut = build_lut(query_embeds, pq_centroids)
    Q, M, K = lut.shape
    if lut_dtype == "int8":
        lut_i8, scales = quantize_lut_int8(lut, group_size(M, K))
        return (torch.cat([lut_i8, lut_i8.new_zeros((1, M, K))]).contiguous(),
                torch.cat([scales, scales.new_zeros((1, scales.shape[1]))]))
    lut = lut.to(torch.bfloat16)
    return torch.cat([lut, lut.new_zeros((1, M, K))]).contiguous(), None


@torch.no_grad()
def ivf_search_device(query_embeds, pq_centroids, coarse, cell_codes,
                      cell_ids, nprobe: int, topk: int,
                      lut_dtype: str = "bf16"):
    """Probe, group, score the tiles with K2 / K3, regroup and take the
    top-k (pallas_ivf.py:339-385). Returns (scores, ids) on the device."""
    Q = query_embeds.shape[0]
    nlist = cell_codes.shape[0]
    cells = probe_cells(query_embeds, coarse, nprobe)
    row, work_cell, qidx, _ = group_pairs(cells, Q, nlist, nprobe)
    lut_z, scales_z = make_lut_z(query_embeds, pq_centroids, lut_dtype)
    scores = score_work_tiles(work_cell, qidx, lut_z, cell_codes, scales_z)
    return regroup_topk(scores.reshape(-1, cell_codes.shape[1]), row, cells,
                        cell_ids, Q, nprobe, topk)


def merge_spill(s: torch.Tensor, i: torch.Tensor, spill: Optional[CudaADCIndex],
                spill_ids: Optional[torch.Tensor], query_embeds, topk: int):
    """Brute-force the spill segment with K1 (bf16 LUT, whatever LUT type
    scored the cells) and merge it into the IVF top-k
    (pallas_ivf.py:228-239), on the device."""
    if spill is None:
        return s, i
    s_sp, i_sp = spill.search_device(query_embeds, topk=min(topk, spill.N))
    s = torch.cat([s, s_sp], dim=1)
    i = torch.cat([i, spill_ids[i_sp].to(i.dtype)], dim=1)
    s, pos = torch.topk(s, min(topk, s.shape[1]), dim=1)
    return s, torch.gather(i, 1, pos)


class CudaIVFIndex:
    """Device-resident IVF-PQ index served by the cell-grouped kernels
    (PallasIVFIndex, pallas_ivf.py:897-1028, with serving="adc" only): the
    cell codes, ids and coarse centroids live on the device once; each
    search probes, groups, scores with K2 (bf16 LUT) or K3 (int8 LUT) and
    merges the spill segment, scanned with K1 (bf16 LUT). On a CPU
    device the kernels' plain versions run instead."""

    def __init__(self, index: IVFIndex, serving: str = "adc", device="cuda"):
        if serving != "adc":
            raise NotImplementedError(
                f"serving={serving!r} (decoded residency) is not ported yet "
                "(ROADMAP.md, Queue 1 item 7)")
        self.device = resolve_device(device)
        self.host = index
        self.nlist = index.nlist
        self.cell_codes = torch.as_tensor(index.cell_codes, device=self.device)
        self.cell_ids = torch.as_tensor(index.cell_ids, device=self.device)
        self.coarse = torch.as_tensor(
            np.asarray(index.coarse_centroids, np.float32), device=self.device)
        self.spill, self.spill_ids = None, None
        if len(index.spill_ids):
            self.spill = CudaADCIndex(index.spill_codes, index.centroids,
                                      device=self.device)
            self.spill_ids = torch.as_tensor(index.spill_ids, device=self.device)
        self.set_centroids(index.centroids)

    def set_centroids(self, centroids) -> None:
        """Swap PQ codebooks (the query model's centroids)."""
        self.centroids = torch.as_tensor(np.asarray(centroids, np.float32),
                                         device=self.device)
        if self.spill is not None:
            self.spill.set_centroids(self.centroids)

    @torch.no_grad()
    def search_device(self, query_embeds, topk: int = 1000, nprobe: int = 64,
                      lut_dtype: str = "bf16"):
        """(scores, ids) tensors on the device, the spill merged; ids are
        corpus rows, -1 (score -inf) for a pad."""
        q = torch.as_tensor(query_embeds, dtype=torch.float32,
                            device=self.device)
        s, i = ivf_search_device(q, self.centroids, self.coarse,
                                 self.cell_codes, self.cell_ids,
                                 min(nprobe, self.nlist), topk, lut_dtype)
        return merge_spill(s, i, self.spill, self.spill_ids, q, topk)

    def search(self, query_embeds, topk: int = 1000, nprobe: int = 64,
               lut_dtype: str = "bf16"):
        s, i = self.search_device(query_embeds, topk, nprobe, lut_dtype)
        return s.cpu().numpy(), i.cpu().numpy()
