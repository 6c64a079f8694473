"""K2 and K3 on Hopper: cell-grouped IVF-PQ serving (counterpart of the
host side of repconc_tpu/index/pallas_ivf.py:149-385,897-1028).

The batch is grouped by cell: every (query, probed cell) pair gets a slot
in a work tile of QT_G query slots that all score one cell, so each tile
reads its cell's codes once for up to QT_G queries. The kernels of
csrc/ivf_scan.cu score the tiles with one scan body: K2 (bf16 LUT)
replaces `_ivf_kernel` (pallas_ivf.py:90-109) and K3 (int8 LUT)
`_ivf_kernel_i8` (:112-142).

A search runs them as two passes with a per-query top-k, driven by
`ivf_topk` (the counterpart of cuda_adc.py::adc_topk): `ivf_group_max`
takes the max of each run of 32 real docs of every probed cell, tau[q] is
the k-th largest of a query's run maxima, and `ivf_filter` keeps the real
docs at or above it, with their corpus ids; one sort of about k candidates
per query ends the search. This replaces JAX's score-every-slot scan and
regroup (`_score_work_tiles` then `_regroup_topk`, :314-336): no
(T, QT_G, Lpad) score buffer is written. `score_work_tiles` (K2 / K3
writing every score) and `regroup_topk` stay as the unfused yardstick, on
no search path. The spill segment is brute-forced with `CudaADCIndex` (K1,
bf16 LUT) and merged, with either LUT type for the cells, as the JAX
package does.

The TPU sized a static tile grid T_max from `_tile_budget` because XLA
needs static shapes, and searched again at the worst-case shape when pairs
overflowed it (:1016-1028). PyTorch has no such constraint, so the grid
here is exact: T = sum_c ceil(count_c / QT_G), one device-to-host read of
one integer per batch. No pair can overflow and there is no retry.

Decoded residency (pallas_ivf.py:389-557,942-1028) keeps the cells'
reconstructions on the device, bf16 (D * 2 bytes a slot) or int8 with a
per-dimension scale (D bytes a slot), and scores each work tile as one
batched matmul, (QT_G, D) queries against the cell's (Lpad, D) vectors.
The JAX package left these scorers to XLA, so here they are torch ops:
`decode_cells`, `decode_cells_int8`, `score_tiles_decoded`,
`score_tiles_decoded_int8` and `ivf_search_device_decoded`, which probes,
groups, regroups and takes the top-k as the unfused ADC search does
(`regroup_topk`). The spill is merged with K1, as for ADC serving.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repconc_tpu_torch import build
from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.index.adc import (RUN, build_lut, group_size,
                                         quantize_lut_int8)
from repconc_tpu_torch.index.cuda_adc import CudaADCIndex, select_topk
from repconc_tpu_torch.index.ivf import IVFIndex, probe_cells
from repconc_tpu_torch.parallel.sharded import gather_merge
from repconc_tpu_torch.quant.codebook import decode_gather

SOURCE = "ivf_scan.cu"
QT_G = 32  # query slots per work tile (the kernel's warp-wide slot ballot)


def group_pairs(cells: torch.Tensor, Q: int, nlist: int, nprobe: int,
                keep: Optional[torch.Tensor] = None):
    """Sort-free grouping of the (query, cell) probe pairs into work tiles
    (pallas_ivf.py:268-311), on an exact grid.

    Cells within one query are distinct, so a pair's rank inside its cell
    is the number of earlier queries that probed the cell: an exclusive
    cumsum over the (Q, nlist) 0/1 incidence matrix. Tiles are laid out
    cell-ascending, queries in order within a cell; T = sum_c
    ceil(count_c / QT_G) (one device-to-host read).

    cells: (Q, nprobe) int. Returns (row, work_cell, slot_pair):
      row (Q * nprobe,) int64 - each pair's slot row (tile * QT_G + slot),
        q-major;
      work_cell (T,) int32 - tile -> cell;
      slot_pair (T, QT_G) int32 - slot -> its pair q * nprobe + j, -1 for
        an empty slot (`slot_queries` gives the slot's query).
    keep: (Q, nprobe) bool, the pairs to group (None: all). The others get
    no slot and row -1: the passes score them nowhere (a cell-sharded
    rank's pairs of cells it does not own).
    """
    dev = cells.device
    pair_cell = cells.reshape(-1).long()
    pair_q = torch.arange(Q, device=dev).repeat_interleave(nprobe)
    incidence = torch.zeros((Q, nlist), dtype=torch.int32, device=dev)
    if keep is not None:
        kept = keep.reshape(-1)
        pair_cell = torch.where(kept, pair_cell, 0)
        incidence[pair_q[kept], pair_cell[kept]] = 1
    else:
        incidence[pair_q, pair_cell] = 1
    counts = incidence.sum(0)
    before = torch.cumsum(incidence, 0, dtype=torch.int32) - incidence
    rank = before.reshape(-1)[pair_q * nlist + pair_cell].long()
    tiles_per_cell = (counts + QT_G - 1) // QT_G
    T = int(tiles_per_cell.sum())
    tiles_before = (torch.cumsum(tiles_per_cell, 0) - tiles_per_cell).long()
    work_id = tiles_before[pair_cell] + rank // QT_G
    row = work_id * QT_G + rank % QT_G
    pair = torch.arange(Q * nprobe, dtype=torch.int32, device=dev)
    if keep is not None:
        row = torch.where(kept, row, -1)
        work_id, pair_cell, pair = work_id[kept], pair_cell[kept], pair[kept]
    work_cell = torch.zeros(T, dtype=torch.int32, device=dev)
    work_cell[work_id] = pair_cell.to(torch.int32)
    slot_pair = torch.full((T * QT_G,), -1, dtype=torch.int32, device=dev)
    slot_pair[row if keep is None else row[kept]] = pair
    return row, work_cell, slot_pair.reshape(T, QT_G)


def slot_queries(slot_pair: torch.Tensor, nprobe: int, Q: int) -> torch.Tensor:
    """(T, QT_G) int32 slot -> query map (JAX's qidx): the query of each
    slot's pair, Q (the LUT's zero row) for an empty slot."""
    return torch.where(slot_pair >= 0, slot_pair // nprobe,
                       Q).to(torch.int32)


def cell_lengths(cell_ids: torch.Tensor) -> torch.Tensor:
    """(nlist,) int32: the real docs of each cell. The passes take docs
    0 .. len - 1 of a cell as its real ones, as `fill_cells` of both
    packages leaves them (pads, id -1, after every real doc); an index laid
    out otherwise raises ValueError."""
    real = cell_ids >= 0
    n = real.sum(1, dtype=torch.int32)
    first = torch.arange(cell_ids.shape[1], device=cell_ids.device)[None, :]
    if not torch.equal(real, first < n[:, None]):
        raise ValueError("cell_ids holds a pad (-1) before a real doc; the "
                         "IVF passes need each cell's pads after its docs")
    return n


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


def _pair_scores(work_cell, slot_pair, lut_z, cell_codes, cell_len, nprobe,
                 scales_z):
    """The plain passes' common part: every slot's scores from
    score_work_tiles_reference laid out by pair, (Q * nprobe, Lpad), with
    the real-doc mask of the pair's cell (doc l < cell_len) and the pair's
    cell; pairs in no slot score -inf, real nowhere."""
    Q = lut_z.shape[0] - 1
    Lpad = cell_codes.shape[1]
    scores = score_work_tiles_reference(
        work_cell, slot_queries(slot_pair, nprobe, Q), lut_z, cell_codes,
        scales_z)
    occ = slot_pair >= 0
    pairs = slot_pair[occ].long()
    tile_cell = work_cell.long()[:, None].expand_as(slot_pair)[occ]
    dev = lut_z.device
    pair_scores = torch.full((Q * nprobe, Lpad), -torch.inf, device=dev)
    pair_scores[pairs] = scores[occ]
    pair_cell = torch.zeros(Q * nprobe, dtype=torch.long, device=dev)
    pair_cell[pairs] = tile_cell
    real = torch.zeros((Q * nprobe, Lpad), dtype=torch.bool, device=dev)
    real[pairs] = (torch.arange(Lpad, device=dev)[None, :]
                   < cell_len.long()[tile_cell][:, None])
    return pair_scores, real, pair_cell


def ivf_group_max_reference(work_cell: torch.Tensor, slot_pair: torch.Tensor,
                            lut_z: torch.Tensor, cell_codes: torch.Tensor,
                            cell_len: torch.Tensor, nprobe: int,
                            scales_z: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain version of pass 1: gmax (Q, nprobe, R) f32, R = ceil(Lpad /
    32): the largest score of each run of 32 docs of the pair's cell
    (docs 32 r .. 32 r + 31), pads (docs at or past cell_len) excluded; a
    run with no real doc is -inf."""
    s, real, _ = _pair_scores(work_cell, slot_pair, lut_z, cell_codes,
                              cell_len, nprobe, scales_z)
    Q, Lpad = lut_z.shape[0] - 1, cell_codes.shape[1]
    R = -(-Lpad // RUN)
    s = torch.where(real, s, -torch.inf)
    s = torch.nn.functional.pad(s, (0, R * RUN - Lpad), value=-torch.inf)
    return s.reshape(Q, nprobe, R, RUN).amax(-1)


def ivf_filter_reference(work_cell: torch.Tensor, slot_pair: torch.Tensor,
                         lut_z: torch.Tensor, cell_codes: torch.Tensor,
                         cell_ids: torch.Tensor, cell_len: torch.Tensor,
                         nprobe: int, tau: torch.Tensor, cap: int,
                         scales_z: Optional[torch.Tensor] = None):
    """Plain version of pass 2: every real doc of each query's probed cells
    with score >= tau[q].

    Returns (cand_s (Q, cap) f32, cand_i (Q, cap) int64 corpus ids from
    cell_ids, count (Q,) int32): count[q] docs pass; the first min(count[q],
    cap) of them, in pair then doc order, fill the first slots; the other
    slots hold -inf and id -1. The CUDA pass stores the same set in arrival
    order, and, past cap, another subset of it.
    """
    s, real, pair_cell = _pair_scores(work_cell, slot_pair, lut_z,
                                      cell_codes, cell_len, nprobe, scales_z)
    Q = lut_z.shape[0] - 1
    s = s.reshape(Q, -1)
    ids = cell_ids.long()[pair_cell].reshape(Q, -1)
    hit = real.reshape(Q, -1) & (s >= tau[:, None])
    slot = hit.cumsum(1) - 1
    keep = hit & (slot < cap)
    cand_s = torch.full((Q, cap), -torch.inf, device=s.device)
    cand_i = torch.full((Q, cap), -1, dtype=torch.long, device=s.device)
    rows, cols = keep.nonzero(as_tuple=True)
    cand_s[rows, slot[rows, cols]] = s[rows, cols]
    cand_i[rows, slot[rows, cols]] = ids[rows, cols]
    return cand_s, cand_i, hit.sum(1).to(torch.int32)


def _scan_fns():
    """K2's and K3's C entry points, with their argument types declared."""
    lib = build.load_library(SOURCE)
    bf16, i8 = lib.repconc_ivf_scan_bf16, lib.repconc_ivf_scan_i8
    ints = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
    bf16.argtypes = [ctypes.c_void_p] * 5 + ints + [ctypes.c_void_p]
    i8.argtypes = [ctypes.c_void_p] * 6 + ints + [ctypes.c_int, ctypes.c_void_p]
    bf16.restype = i8.restype = ctypes.c_int
    return bf16, i8


_PASS_SHAPE = [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 6


def _group_max_fn():
    fn = build.load_library(SOURCE).repconc_ivf_group_max
    fn.argtypes = [ctypes.c_void_p] * 7 + _PASS_SHAPE + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _filter_fn():
    fn = build.load_library(SOURCE).repconc_ivf_filter
    fn.argtypes = ([ctypes.c_void_p] * 12 + _PASS_SHAPE
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_tiles(name, work_cell, slots, lut_z, cell_codes, scales_z,
                 *more):
    """What K2 / K3 and their passes take: work_cell (T,) int32, slots
    (T, QT_G) int32, lut_z (Qz, M, K) with K <= 256, bf16 or int8 with
    scales_z (Qz, G) f32, cell_codes (nlist, Lpad, M) uint8, and `more`
    tensors, all contiguous on one device, cuda or cpu. Returns "bf16" or
    "int8"."""
    int8 = scales_z is not None
    if (work_cell.dim() != 1 or slots.shape != (work_cell.shape[0], QT_G)
            or lut_z.dim() != 3 or cell_codes.dim() != 3
            or cell_codes.shape[2] != lut_z.shape[1]):
        raise ValueError(
            f"work_cell {tuple(work_cell.shape)}, slots {tuple(slots.shape)}, "
            f"lut {tuple(lut_z.shape)} and codes {tuple(cell_codes.shape)} do "
            f"not fit (T,), (T, {QT_G}), (Qz, M, K), (nlist, Lpad, M)")
    Qz, M, K = lut_z.shape
    want = torch.int8 if int8 else torch.bfloat16
    if (lut_z.dtype != want or work_cell.dtype != torch.int32
            or slots.dtype != torch.int32 or cell_codes.dtype != torch.uint8):
        raise TypeError(f"want a {want} lut, int32 work_cell and slots and "
                        f"uint8 codes, got {lut_z.dtype}, {work_cell.dtype}, "
                        f"{slots.dtype} and {cell_codes.dtype}")
    tensors = [work_cell, slots, lut_z, cell_codes, *more]
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
        raise ValueError(f"{name} needs contiguous inputs")
    if lut_z.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {lut_z.device}")
    return "int8" if int8 else "bf16"


def _check_cells(cell_codes, cell_len, cell_ids=None):
    nlist, Lpad, _ = cell_codes.shape
    if cell_len.shape != (nlist,) or cell_len.dtype != torch.int32:
        raise ValueError(f"cell_len must be ({nlist},) int32, not "
                         f"{tuple(cell_len.shape)} {cell_len.dtype}")
    if cell_ids is not None and (cell_ids.shape != (nlist, Lpad)
                                 or cell_ids.dtype != torch.int32):
        raise ValueError(f"cell_ids must be ({nlist}, {Lpad}) int32, not "
                         f"{tuple(cell_ids.shape)} {cell_ids.dtype}")


def _launch(name, kind, fn, *args, device):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} ({kind}) launch failed: cudaError {err}")


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
    score_work_tiles.launches["bf16"] or ["int8"]. On no search path: the
    passes below took its place.
    """
    kind = _check_tiles("score_work_tiles", work_cell, qidx, lut_z,
                        cell_codes, scales_z)
    dev = lut_z.device
    if dev.type == "cpu":
        return score_work_tiles_reference(work_cell, qidx, lut_z, cell_codes,
                                          scales_z)
    Qz, M, K = lut_z.shape
    T = work_cell.shape[0]
    nlist, Lpad, _ = cell_codes.shape
    out = torch.empty((T, QT_G, Lpad), dtype=torch.float32, device=dev)
    fn_bf16, fn_i8 = _scan_fns()
    if kind == "int8":
        _launch("ivf_scan", kind, fn_i8, lut_z.data_ptr(), scales_z.data_ptr(),
                work_cell.data_ptr(), qidx.data_ptr(), cell_codes.data_ptr(),
                out.data_ptr(), T, Qz, nlist, Lpad, M, K,
                M // scales_z.shape[1], device=dev)
    else:
        _launch("ivf_scan", kind, fn_bf16, lut_z.data_ptr(),
                work_cell.data_ptr(), qidx.data_ptr(), cell_codes.data_ptr(),
                out.data_ptr(), T, Qz, nlist, Lpad, M, K, device=dev)
    score_work_tiles.launches[kind] += 1
    return out


score_work_tiles.launches = {"bf16": 0, "int8": 0}


def _pass_shape(work_cell, lut_z, cell_codes, nprobe, scales_z):
    """The shape arguments of both C passes: T, Q, nprobe, nlist, Lpad, M,
    K, gm (0 for a bf16 LUT)."""
    nlist, Lpad, M = cell_codes.shape
    gm = 0 if scales_z is None else M // scales_z.shape[1]
    return (work_cell.shape[0], lut_z.shape[0] - 1, nprobe, nlist, Lpad, M,
            lut_z.shape[2], gm)


def ivf_group_max(work_cell: torch.Tensor, slot_pair: torch.Tensor,
                  lut_z: torch.Tensor, cell_codes: torch.Tensor,
                  cell_len: torch.Tensor, nprobe: int,
                  scales_z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pass 1: gmax (Q, nprobe, R) f32, the largest score of each run of
    32 real docs of every pair's cell, in pair order (Q = Qz - 1, R =
    ceil(Lpad / 32); see ivf_group_max_reference). Inputs as
    score_work_tiles' with slot_pair (group_pairs) for qidx, and cell_len
    (nlist,) int32 (cell_lengths). A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes ivf_group_max_reference. Each launch adds
    one to ivf_group_max.launches["bf16"] or ["int8"]."""
    kind = _check_tiles("ivf_group_max", work_cell, slot_pair, lut_z,
                        cell_codes, scales_z, cell_len)
    _check_cells(cell_codes, cell_len)
    if nprobe < 1:
        raise ValueError(f"nprobe={nprobe} < 1")
    if lut_z.device.type == "cpu":
        return ivf_group_max_reference(work_cell, slot_pair, lut_z,
                                       cell_codes, cell_len, nprobe, scales_z)
    Q, Lpad = lut_z.shape[0] - 1, cell_codes.shape[1]
    gmax = torch.full((Q, nprobe, -(-Lpad // RUN)), -torch.inf,
                      device=lut_z.device)
    _launch("ivf_group_max", kind, _group_max_fn(), lut_z.data_ptr(),
            None if scales_z is None else scales_z.data_ptr(),
            work_cell.data_ptr(), slot_pair.data_ptr(), cell_codes.data_ptr(),
            cell_len.data_ptr(), gmax.data_ptr(),
            *_pass_shape(work_cell, lut_z, cell_codes, nprobe, scales_z),
            device=lut_z.device)
    ivf_group_max.launches[kind] += 1
    return gmax


ivf_group_max.launches = {"bf16": 0, "int8": 0}


def ivf_filter(work_cell: torch.Tensor, slot_pair: torch.Tensor,
               lut_z: torch.Tensor, cell_codes: torch.Tensor,
               cell_ids: torch.Tensor, cell_len: torch.Tensor, nprobe: int,
               tau: torch.Tensor, cap: int, gmax=None,
               scales_z: Optional[torch.Tensor] = None):
    """Pass 2: every real doc of each query's probed cells with score >=
    tau[q].

    Returns (cand_s (Q, cap) f32, cand_i (Q, cap) int64, count (Q,) int32):
    count[q] docs pass, and min(count[q], cap) of them fill slots 0.. with
    their score and corpus id (cell_ids (nlist, Lpad) int32), in an order
    that varies from run to run; the other slots hold -inf and id -1. With
    pass 1's gmax the kernel re-scans only the runs where some slot of a
    sub-tile reaches its tau; the result is the same. A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes
    ivf_filter_reference. Each launch adds one to
    ivf_filter.launches["bf16"] or ["int8"].
    """
    kind = _check_tiles("ivf_filter", work_cell, slot_pair, lut_z, cell_codes,
                        scales_z, cell_len, cell_ids, tau)
    _check_cells(cell_codes, cell_len, cell_ids)
    Q, Lpad = lut_z.shape[0] - 1, cell_codes.shape[1]
    if tau.shape != (Q,) or tau.dtype != torch.float32:
        raise ValueError(f"tau must be a ({Q},) f32 tensor")
    if gmax is not None and (gmax.shape != (Q, nprobe, -(-Lpad // RUN))
                             or gmax.dtype != torch.float32
                             or gmax.device != lut_z.device
                             or not gmax.is_contiguous()):
        raise ValueError(f"gmax must be a contiguous ({Q}, {nprobe}, R) f32 "
                         f"tensor on {lut_z.device}")
    if nprobe < 1 or cap < 1:
        raise ValueError(f"nprobe={nprobe} and cap={cap} must be >= 1")
    if lut_z.device.type == "cpu":
        return ivf_filter_reference(work_cell, slot_pair, lut_z, cell_codes,
                                    cell_ids, cell_len, nprobe, tau, cap,
                                    scales_z)
    dev = lut_z.device
    cand_s = torch.full((Q, cap), -torch.inf, device=dev)
    cand_i = torch.full((Q, cap), -1, dtype=torch.long, device=dev)
    count = torch.zeros(Q, dtype=torch.int32, device=dev)
    _launch("ivf_filter", kind, _filter_fn(), lut_z.data_ptr(),
            None if scales_z is None else scales_z.data_ptr(),
            work_cell.data_ptr(), slot_pair.data_ptr(), cell_codes.data_ptr(),
            cell_len.data_ptr(), cell_ids.data_ptr(), tau.data_ptr(),
            None if gmax is None else gmax.data_ptr(), cand_s.data_ptr(),
            cand_i.data_ptr(), count.data_ptr(),
            *_pass_shape(work_cell, lut_z, cell_codes, nprobe, scales_z), cap,
            device=dev)
    ivf_filter.launches[kind] += 1
    return cand_s, cand_i, count


ivf_filter.launches = {"bf16": 0, "int8": 0}


def ivf_plan(nprobe: int, Lpad: int, topk: int):
    """(pass 1 runs, cap) of ivf_topk: where a query can have k runs of 32
    docs (nprobe * ceil(Lpad / 32) >= k) and k < nprobe * Lpad, pass 1 runs
    and pass 2 gets 2k candidate slots; else tau is -inf, every real doc
    passes and cap = nprobe * Lpad."""
    k = min(topk, nprobe * Lpad)
    if k < nprobe * Lpad and nprobe * -(-Lpad // RUN) >= k:
        return True, 2 * k
    return False, nprobe * Lpad


def ivf_topk(work_cell: torch.Tensor, slot_pair: torch.Tensor,
             lut_z: torch.Tensor, cell_codes: torch.Tensor,
             cell_ids: torch.Tensor, cell_len: torch.Tensor, nprobe: int,
             topk: int, scales_z: Optional[torch.Tensor] = None):
    """Exact top-k of each query's probed cells by IVF score, (scores, ids)
    each (Q, min(topk, nprobe * Lpad)), sorted by score DESC, id ASC; ids
    are corpus ids, -1 (score -inf) where a query has fewer real docs.

    Pass 1 (ivf_group_max) takes the max of each run of 32 real docs;
    tau[q], the k-th largest of the query's run maxima, is reached by k
    distinct docs, so it bounds the k-th best score from below. Pass 2
    (ivf_filter) keeps the real docs at or above tau: about k per query.
    Its count is read once; above the cap (ivf_plan) pass 2 runs again with
    cap = the count, adding one to `ivf_topk.reruns`. Where tau would be
    -inf for every query, pass 1 is skipped. Scores equal
    regroup_topk(score_work_tiles(...))'s bit for bit; ids equal except in
    the order among exact ties.
    """
    Q, dev = lut_z.shape[0] - 1, lut_z.device
    k = min(topk, nprobe * cell_codes.shape[1])
    if Q <= 0 or k <= 0:
        return (torch.empty((max(Q, 0), max(k, 0)), device=dev),
                torch.empty((max(Q, 0), max(k, 0)), dtype=torch.long,
                            device=dev))
    pass1, cap = ivf_plan(nprobe, cell_codes.shape[1], k)
    tiles = (work_cell, slot_pair, lut_z, cell_codes)
    gmax = None
    tau = torch.full((Q,), -torch.inf, device=dev)
    if pass1:
        gmax = ivf_group_max(*tiles, cell_len, nprobe, scales_z)
        tau = torch.topk(gmax.reshape(Q, -1), k, dim=1).values[:, -1]
        tau = tau.contiguous()
    cand_s, cand_i, count = ivf_filter(*tiles, cell_ids, cell_len, nprobe,
                                       tau, cap, gmax, scales_z)
    most = int(count.max())
    if most > cap:
        ivf_topk.reruns += 1
        cand_s, cand_i, count = ivf_filter(*tiles, cell_ids, cell_len, nprobe,
                                           tau, most, gmax, scales_z)
    return select_topk(cand_s, cand_i, k)


ivf_topk.reruns = 0


def regroup_topk(scores_flat: torch.Tensor, row: torch.Tensor,
                 cells: torch.Tensor, cell_ids: torch.Tensor, Q: int,
                 nprobe: int, topk: int):
    """The unfused search's end (pallas_ivf.py:314-336), kept as the
    yardstick of ivf_topk: each query's candidate rows gathered back from
    K2's (T * QT_G, Lpad) scores (row is q-major, so this is a reshape),
    pad slots at -inf, exact top-k. Returns (scores, ids) on the device,
    ids -1 for a pad. A pair without a slot (row -1, group_pairs' keep)
    counts as a cell of pads."""
    Lpad = cell_ids.shape[1]
    cand = scores_flat[row.clamp(min=0)].reshape(Q, nprobe * Lpad)
    ids = cell_ids[cells.reshape(-1).long()]
    ids = torch.where(row[:, None] >= 0, ids, -1).reshape(Q, nprobe * Lpad)
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


def owned_probes(query_embeds, coarse, nprobe: int, owner=None):
    """(cells, keep): each query's top-nprobe cells (probe_cells) and the
    pairs to score. owner None: every pair, cells as probed. owner
    (rank, W): the cell-sharded rank's share (pallas_ivf.py:596-602), the
    pairs of the cells c % W == rank, at their local index c // W; keep
    marks them and the other pairs point at local cell 0."""
    cells = probe_cells(query_embeds, coarse, nprobe)
    if owner is None:
        return cells, None
    rank, world = owner
    keep = cells % world == rank
    return torch.where(keep, cells // world, 0), keep


@torch.no_grad()
def ivf_search_device(query_embeds, pq_centroids, coarse, cell_codes,
                      cell_ids, cell_len, nprobe: int, topk: int,
                      lut_dtype: str = "bf16", owner=None):
    """Probe, group, and take each query's top-k of its probed cells with
    the two passes of ivf_topk (pallas_ivf.py:339-385 computes the same
    with K2 / K3 and a regroup). Returns (scores, ids) on the device.
    owner (rank, W): cell_codes, cell_ids and cell_len hold only the cells
    that rank owns (owned_probes), and only their pairs are scored."""
    Q = query_embeds.shape[0]
    cells, keep = owned_probes(query_embeds, coarse, nprobe, owner)
    _, work_cell, slot_pair = group_pairs(cells, Q, cell_codes.shape[0],
                                          nprobe, keep)
    lut_z, scales_z = make_lut_z(query_embeds, pq_centroids, lut_dtype)
    return ivf_topk(work_cell, slot_pair, lut_z, cell_codes, cell_ids,
                    cell_len, nprobe, topk, scales_z)


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


SERVINGS = ("adc", "decoded", "decoded_int8")
# The JAX package's int8 scales are x / 127.0 inside jit, which XLA
# computes as x * fp32(1 / 127): the port multiplies too, bit for bit.
INV127 = 1.0 / 127.0


@torch.no_grad()
def decode_cells(cell_codes: torch.Tensor, pq_centroids: torch.Tensor,
                 chunk: int = 64) -> torch.Tensor:
    """Every slot's reconstruction, (nlist, Lpad, M) uint8 codes ->
    (nlist, Lpad, D) bf16 (pallas_ivf.py:389-409): the fp32 gather,
    rounded once to bf16, `chunk` cells at a time. Pad slots decode their
    code 0s, as in the JAX package; the ids mask them."""
    nlist, Lpad, M = cell_codes.shape
    D = pq_centroids.shape[0] * pq_centroids.shape[2]
    out = torch.empty((nlist, Lpad, D), dtype=torch.bfloat16,
                      device=cell_codes.device)
    for c in range(0, nlist, chunk):
        codes = cell_codes[c:c + chunk].reshape(-1, M)
        out[c:c + chunk] = decode_gather(codes, pq_centroids).reshape(
            -1, Lpad, D).to(torch.bfloat16)
    return out


@torch.no_grad()
def decode_cells_int8(cell_codes: torch.Tensor, pq_centroids: torch.Tensor,
                      chunk: int = 64):
    """int8 decoded residency (pallas_ivf.py:412-442): ((nlist, Lpad, D)
    int8, (D,) f32 scale), each value round(x / scale) half to even,
    clipped to +-127. The per-dimension scale is the largest |value| any
    reconstruction can take there (the codebook's, exact) over 127; it
    folds into the query at search time, so each tile scores as an
    integer product."""
    nlist, Lpad, M = cell_codes.shape
    D = pq_centroids.shape[0] * pq_centroids.shape[2]
    scale = pq_centroids.abs().amax(1).reshape(D).clamp(min=1e-12) * INV127
    out = torch.empty((nlist, Lpad, D), dtype=torch.int8,
                      device=cell_codes.device)
    for c in range(0, nlist, chunk):
        flat = decode_gather(cell_codes[c:c + chunk].reshape(-1, M),
                             pq_centroids)
        out[c:c + chunk] = torch.clamp(torch.round(flat / scale), -127,
                                       127).to(torch.int8).reshape(-1, Lpad, D)
    return out, scale


def _score_tiles(work_cell, qidx, q_rows_z, cell_vecs, row_scale_z=None):
    """(T, QT_G, Lpad) f32: out[t, s, l] = sum_d q_rows_z[qidx[t, s], d] *
    cell_vecs[work_cell[t], l, d], as an fp32 batched matmul of the two
    operands' values (TF32 off), then times row_scale_z[qidx[t, s]]. Each
    batched matmul takes as many tiles as hold about 2^26 fp32 values of
    their cells' vectors."""
    T = work_cell.shape[0]
    _, Lpad, D = cell_vecs.shape
    out = torch.empty((T, QT_G, Lpad), dtype=torch.float32,
                      device=cell_vecs.device)
    tc = max(1, (1 << 26) // max(Lpad * D, 1))
    for t in range(0, T, tc):
        wc, qi = work_cell[t:t + tc].long(), qidx[t:t + tc].long()
        q_rows = q_rows_z[qi].float()                      # (tc, QT_G, D)
        tile_vecs = cell_vecs[wc].float()                  # (tc, Lpad, D)
        acc = torch.bmm(q_rows, tile_vecs.transpose(1, 2))
        if row_scale_z is not None:
            acc *= row_scale_z[qi][:, :, None]
        out[t:t + tc] = acc
    return out


def score_tiles_decoded(work_cell: torch.Tensor, qidx: torch.Tensor,
                        q_z: torch.Tensor, cell_vecs: torch.Tensor
                        ) -> torch.Tensor:
    """The bf16 decoded scorer (pallas_ivf.py:475-515): (T, QT_G, Lpad)
    f32 scores of bf16 queries q_z (Qz, D), row Qz - 1 zero for empty
    slots, against bf16 cell vectors. XLA multiplies the bf16 values into
    an fp32 result (preferred_element_type); torch.bmm on bf16 returns
    bf16, so the values are multiplied in fp32 instead: a product of two
    bf16 values is exact there, and only the order of the fp32 sums
    differs."""
    return _score_tiles(work_cell, qidx, q_z, cell_vecs)


def score_tiles_decoded_int8(work_cell: torch.Tensor, qidx: torch.Tensor,
                             q8_z: torch.Tensor, qscale_z: torch.Tensor,
                             cell_vecs_i8: torch.Tensor) -> torch.Tensor:
    """The int8 decoded scorer (pallas_ivf.py:445-472): the s8 x s8 -> s32
    sum of each slot, times its query's scale, (T, QT_G, Lpad) f32.
    torch.bmm has no int8 on CUDA and torch._int_mm is 2-D, so the int8
    values are multiplied as fp32: every product and partial sum is an
    integer below D * 127^2 < 2^24 (D <= 1040), which fp32 holds exactly,
    so the sums are the int32 sums in any order."""
    D = cell_vecs_i8.shape[2]
    if D * 127 * 127 >= 1 << 24:
        raise ValueError(f"D={D}: int8 sums above 2^24 are not exact in fp32")
    return _score_tiles(work_cell, qidx, q8_z, cell_vecs_i8, qscale_z)


def quantize_queries_int8(query_embeds: torch.Tensor, doc_scale: torch.Tensor):
    """(q8 (Q, D) int8, qscale (Q,) f32): the queries with the store's
    per-dimension scale folded in, quantized per query
    (pallas_ivf.py:537-543)."""
    q_f = query_embeds * doc_scale[None, :]
    qscale = q_f.abs().amax(1).clamp(min=1e-12) * INV127
    q8 = torch.clamp(torch.round(q_f / qscale[:, None]), -127,
                     127).to(torch.int8)
    return q8, qscale


@torch.no_grad()
def ivf_search_device_decoded(query_embeds, coarse, cell_vecs, cell_ids,
                              nprobe: int, topk: int, doc_scale=None,
                              owner=None):
    """IVF search over a decoded store (pallas_ivf.py:518-557): the probe,
    the grouping into tiles, the masking and the top-k of the ADC search,
    with the tiles scored by score_tiles_decoded (bf16 cell_vecs) or
    score_tiles_decoded_int8 (int8, with doc_scale). Returns (scores, ids)
    on the device, ids -1 (score -inf) for a pad. owner: as for
    ivf_search_device."""
    Q, D = query_embeds.shape
    nlist = cell_vecs.shape[0]
    cells, keep = owned_probes(query_embeds, coarse, nprobe, owner)
    row, work_cell, slot_pair = group_pairs(cells, Q, nlist, nprobe, keep)
    qidx = slot_queries(slot_pair, nprobe, Q)
    if cell_vecs.dtype == torch.int8:
        q8, qscale = quantize_queries_int8(query_embeds, doc_scale)
        scores = score_tiles_decoded_int8(
            work_cell, qidx, torch.cat([q8, q8.new_zeros((1, D))]),
            torch.cat([qscale, qscale.new_zeros(1)]), cell_vecs)
    else:
        q = query_embeds.to(torch.bfloat16)
        scores = score_tiles_decoded(work_cell, qidx,
                                     torch.cat([q, q.new_zeros((1, D))]),
                                     cell_vecs)
    return regroup_topk(scores.reshape(-1, cell_vecs.shape[1]), row, cells,
                        cell_ids, Q, nprobe, topk)


class CudaIVFIndex:
    """Device-resident IVF-PQ index (PallasIVFIndex, pallas_ivf.py:
    897-1028): the cell codes, ids, real-doc counts and coarse centroids
    live on the device once. serving="adc" takes each query's top-k of its
    probed cells with the two passes of ivf_topk (bf16 or int8 LUT);
    "decoded" / "decoded_int8" score the tiles against a resident store of
    reconstructions (ivf_search_device_decoded), one dtype resident at a
    time. Either way the spill segment is scanned with K1 (bf16 LUT) and
    merged. On a CPU device the kernels' plain versions run instead."""

    def __init__(self, index: IVFIndex, serving: str = "adc", device="cuda"):
        if serving not in SERVINGS:
            raise ValueError(f"serving must be one of {SERVINGS}, not "
                             f"{serving!r}")
        self.device = resolve_device(device)
        self.host = index
        self.nlist = index.nlist
        self.owner = None  # (rank, W) of a cell-sharded rank
        self.serving = serving
        self.store = None  # (dtype, vectors, doc scale or None)
        self.cell_codes = torch.as_tensor(index.cell_codes, device=self.device)
        self.cell_ids = torch.as_tensor(index.cell_ids, device=self.device)
        self.cell_len = cell_lengths(self.cell_ids)
        self.coarse = torch.as_tensor(
            np.asarray(index.coarse_centroids, np.float32), device=self.device)
        self.spill, self.spill_ids = None, None
        if len(index.spill_ids):
            self.spill = CudaADCIndex(index.spill_codes, index.centroids,
                                      device=self.device)
            self.spill_ids = torch.as_tensor(index.spill_ids, device=self.device)
        self.set_centroids(index.centroids)

    def set_centroids(self, centroids) -> None:
        """Swap PQ codebooks (the query model's centroids). A decoded store
        bakes in the codebook: it is dropped, and rebuilt at once when
        decoded residency is the default serving (pallas_ivf.py:927-940)."""
        self.centroids = torch.as_tensor(np.asarray(centroids, np.float32),
                                         device=self.device)
        if self.spill is not None:
            self.spill.set_centroids(self.centroids)
        self.store = None
        if self.serving != "adc":
            self.decoded_store(_store_dtype(self.serving))

    def decoded_bytes(self, dtype: str = "bf16") -> int:
        """Device bytes of the decoded store: nlist * Lpad * D, times 2 for
        bf16."""
        nlist, Lpad, _ = self.cell_codes.shape
        D = self.centroids.shape[0] * self.centroids.shape[2]
        return nlist * Lpad * D * (1 if dtype == "int8" else 2)

    def decoded_store(self, dtype: str):
        """(vectors, doc scale or None) of the `dtype` store, built when
        another dtype or none is resident; the serving default stays. A
        store that cannot fit the card's free memory raises MemoryError
        (decoded_bytes); nothing falls back to ADC."""
        if dtype not in ("bf16", "int8"):
            raise ValueError(f"decoded dtype must be bf16 or int8, not "
                             f"{dtype!r}")
        if self.store is None or self.store[0] != dtype:
            self.store = None  # free the other dtype's store first
            if self.device.type == "cuda":
                free, _ = torch.cuda.mem_get_info(self.device)
                need = self.decoded_bytes(dtype)
                if need > free:
                    raise MemoryError(
                        f"decoded {dtype} store needs {need} bytes "
                        f"(decoded_bytes), the card has {free} free")
            if dtype == "int8":
                vecs, scale = decode_cells_int8(self.cell_codes,
                                                self.centroids)
            else:
                vecs, scale = decode_cells(self.cell_codes,
                                           self.centroids), None
            self.store = (dtype, vecs, scale)
        return self.store[1], self.store[2]

    def enable_decoded_serving(self, dtype: str = "bf16") -> "CudaIVFIndex":
        """Build the `dtype` store and make decoded residency the default
        serving; search(serving=...) overrides it per call."""
        self.decoded_store(dtype)
        self.serving = "decoded_int8" if dtype == "int8" else "decoded"
        return self

    @torch.no_grad()
    def search_device(self, query_embeds, topk: int = 1000, nprobe: int = 64,
                      lut_dtype: str = "bf16", serving: Optional[str] = None):
        """(scores, ids) tensors on the device, the spill merged; ids are
        corpus rows, -1 (score -inf) for a pad. lut_dtype applies to ADC
        serving; serving overrides the default for this call."""
        q = torch.as_tensor(query_embeds, dtype=torch.float32,
                            device=self.device)
        s, i = self.cells_topk(q, topk, nprobe, lut_dtype, serving)
        return merge_spill(s, i, self.spill, self.spill_ids, q, topk)

    @torch.no_grad()
    def cells_topk(self, q: torch.Tensor, topk: int, nprobe: int,
                   lut_dtype: str = "bf16", serving: Optional[str] = None):
        """Each query's top-k of its probed cells held here, the spill
        left out: (scores, ids) each (Q, min(topk, nprobe * Lpad))."""
        mode = serving or self.serving
        if mode not in SERVINGS:
            raise ValueError(f"serving must be one of {SERVINGS}, not "
                             f"{mode!r}")
        nprobe = min(nprobe, self.nlist)
        if mode == "adc":
            return ivf_search_device(q, self.centroids, self.coarse,
                                     self.cell_codes, self.cell_ids,
                                     self.cell_len, nprobe, topk, lut_dtype,
                                     self.owner)
        vecs, scale = self.decoded_store(_store_dtype(mode))
        return ivf_search_device_decoded(q, self.coarse, vecs, self.cell_ids,
                                         nprobe, topk, scale, self.owner)

    def search(self, query_embeds, topk: int = 1000, nprobe: int = 64,
               lut_dtype: str = "bf16", serving: Optional[str] = None):
        s, i = self.search_device(query_embeds, topk, nprobe, lut_dtype,
                                  serving)
        return s.cpu().numpy(), i.cpu().numpy()


def _store_dtype(serving: str) -> str:
    return "int8" if serving == "decoded_int8" else "bf16"


class ShardedCudaIVFIndex(CudaIVFIndex):
    """IVF-PQ with its CELLS sharded round-robin over the mesh
    (ShardedPallasIVFIndex, pallas_ivf.py:560-894): rank d owns the cells
    {c : c % W == d} (:596-602) and holds a CudaIVFIndex over them alone,
    each cell at local index c // W with its global doc ids and its
    trailing pads; the coarse centroids and the spill are replicated.

    A search probes the replicated coarse centroids, keeps the pairs of
    the cells this rank owns, scores them with K2's or K3's passes
    (ivf_topk; on the CPU their plain versions) or the decoded store, takes
    a local top-k, and gathers and merges the ranks' lists
    (parallel/sharded.py::gather_merge); every pair is scored by exactly
    one rank, so the merge is exact. The spill is scanned by K1 with the
    bf16 LUT and merged once, after the gather, as on one device. Decoded
    residency shards the same way: each rank decodes only its own cells
    (:624-663).

    The JAX package's per-device tile capacity, its overflow count and its
    retry (:611-623,866-893) exist because XLA needs static shapes; the
    port's tile grid is exact (group_pairs), so no pair can overflow and
    there is nothing to retry.
    """

    def __init__(self, mesh, index: IVFIndex, serving: str = "adc"):
        owned = np.arange(mesh.rank, index.nlist, mesh.size)
        local = dataclasses.replace(
            index, cell_codes=index.cell_codes[owned],
            cell_ids=index.cell_ids[owned], cell_sizes=index.cell_sizes[owned])
        super().__init__(local, serving=serving, device=mesh.device)
        self.mesh = mesh
        self.owner = (mesh.rank, mesh.size)

    def local_search(self, query_embeds, topk: int = 1000, nprobe: int = 64,
                     lut_dtype: str = "bf16", serving: Optional[str] = None):
        """This rank's part: (scores, global ids) each (Q, min(topk,
        nprobe * Lpad)) over the pairs of its own cells, -inf / -1 pads;
        the spill left out."""
        q = torch.as_tensor(query_embeds, dtype=torch.float32,
                            device=self.device)
        return self.cells_topk(q, topk, nprobe, lut_dtype, serving)

    def merge_spill(self, s, i, query_embeds, topk: int):
        """The merged cells' top-k with the replicated spill merged in."""
        q = torch.as_tensor(query_embeds, dtype=torch.float32,
                            device=self.device)
        return merge_spill(s, i, self.spill, self.spill_ids, q, topk)

    @torch.no_grad()
    def search_device(self, query_embeds, topk: int = 1000, nprobe: int = 64,
                      lut_dtype: str = "bf16", serving: Optional[str] = None):
        """(scores, ids) tensors on this rank's device, the same on every
        rank: the local part, the gather and merge, then the spill."""
        s, i = self.local_search(query_embeds, topk, nprobe, lut_dtype,
                                 serving)
        s, i = gather_merge(self.mesh, s, i, s.shape[1])
        return self.merge_spill(s, i, query_embeds, topk)
