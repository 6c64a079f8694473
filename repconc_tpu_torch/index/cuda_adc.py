"""K1 and K4 on Hopper: the CUDA ADC scans and the device-resident index.

Counterpart of repconc_tpu/index/pallas_adc.py:149-307. `adc_scores` is the
wrapper of the hand-written kernel in csrc/adc_scan.cu, which replaces the
TPU kernel `_adc_onehot_kernel` (pallas_adc.py:89-104); `adc_scores_int8`
wraps csrc/adc_scan_i8.cu, which replaces its int8-LUT twin
`_adc_onehot_kernel_i8` (pallas_adc.py:107-130). `adc_group_max` and
`adc_filter` wrap the two passes of the same source that `adc_topk` drives
in place of the TPU search loop (`_search_device`, pallas_adc.py:229-260):
group maxima, a threshold, the docs above it, one sort. `CudaADCIndex` is
the counterpart of `PallasADCIndex`: padded uint8 codes on the device once,
`set_centroids`, and a search through `adc_topk`.
"""
from __future__ import annotations

import ctypes

import torch

from repconc_tpu_torch import build
from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.index.adc import (RUN, adc_filter_reference,
                                         adc_group_max_reference, build_lut,
                                         score_codes_int8_reference,
                                         score_codes_reference)

SOURCE = "adc_scan.cu"
SOURCE_I8 = "adc_scan_i8.cu"
GROUPS_MAX = 65536  # pass 1's groups: gmax is Q * G * 4 bytes


def _scan_fn():
    """The kernel's C entry point, with its argument types declared."""
    fn = build.load_library(SOURCE).repconc_adc_scan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _group_max_fn():
    fn = build.load_library(SOURCE).repconc_adc_group_max
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _filter_fn():
    fn = build.load_library(SOURCE).repconc_adc_filter
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scan_i8_fn():
    fn = build.load_library(SOURCE_I8).repconc_adc_scan_i8
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def adc_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """scores (Q, N) f32 = sum_m lut[q, m, codes[n, m]].

    lut: (Q, M, K) bf16 with K <= 256; codes: (N, M) uint8; both contiguous
    on one device. A CUDA tensor launches the kernel (or raises); a CPU
    tensor takes the plain version, score_codes_reference. Each launch adds
    one to `adc_scores.launches`.
    """
    if lut.dim() != 3 or codes.dim() != 2 or codes.shape[1] != lut.shape[1]:
        raise ValueError(f"lut {tuple(lut.shape)} and codes "
                         f"{tuple(codes.shape)} do not fit (Q, M, K), (N, M)")
    if lut.dtype != torch.bfloat16 or codes.dtype != torch.uint8:
        raise TypeError(f"want a bf16 lut and uint8 codes, got {lut.dtype} "
                        f"and {codes.dtype}")
    if lut.shape[2] > 256:
        raise ValueError(f"K={lut.shape[2]} > 256 does not fit uint8 codes")
    if lut.device != codes.device:
        raise ValueError(f"lut on {lut.device}, codes on {codes.device}")
    if not (lut.is_contiguous() and codes.is_contiguous()):
        raise ValueError("adc_scores needs contiguous lut and codes")
    if lut.device.type == "cpu":
        return score_codes_reference(lut, codes)
    if lut.device.type != "cuda":
        raise ValueError(f"adc_scores runs on cuda or cpu, not {lut.device}")
    Q, M, K = lut.shape
    N = codes.shape[0]
    out = torch.empty((Q, N), dtype=torch.float32, device=lut.device)
    fn = _scan_fn()
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream(lut.device).cuda_stream
        err = fn(lut.data_ptr(), codes.data_ptr(), out.data_ptr(), Q, N, M, K,
                 lut.device.index, stream)
    if err != 0:
        raise RuntimeError(f"adc_scan launch failed: cudaError {err} "
                           f"(Q={Q}, N={N}, M={M}, K={K})")
    adc_scores.launches += 1
    return out


adc_scores.launches = 0


def adc_scores_int8(lut_i8: torch.Tensor, scales: torch.Tensor,
                    codes: torch.Tensor) -> torch.Tensor:
    """scores (Q, N) f32 from an int8 LUT (index/adc.py::quantize_lut_int8):
    per m-group an int32 sum, then sum_g part_g * scales[q, g] in f32.

    lut_i8: (Q, M, K) int8 with K <= 256; scales: (Q, G) f32 with G
    dividing M; codes: (N, M) uint8; all contiguous on one device. A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes the plain
    version, score_codes_int8_reference. Each launch adds one to
    `adc_scores_int8.launches`.
    """
    if lut_i8.dim() != 3 or codes.dim() != 2 or codes.shape[1] != lut_i8.shape[1]:
        raise ValueError(f"lut {tuple(lut_i8.shape)} and codes "
                         f"{tuple(codes.shape)} do not fit (Q, M, K), (N, M)")
    Q, M, K = lut_i8.shape
    if (scales.dim() != 2 or scales.shape[0] != Q or scales.shape[1] < 1
            or M % scales.shape[1] != 0):
        raise ValueError(f"scales {tuple(scales.shape)} do not fit (Q={Q}, G), "
                         f"G dividing M={M}")
    if (lut_i8.dtype != torch.int8 or scales.dtype != torch.float32
            or codes.dtype != torch.uint8):
        raise TypeError(f"want an int8 lut, f32 scales and uint8 codes, got "
                        f"{lut_i8.dtype}, {scales.dtype} and {codes.dtype}")
    if K > 256:
        raise ValueError(f"K={K} > 256 does not fit uint8 codes")
    if not (lut_i8.device == scales.device == codes.device):
        raise ValueError(f"lut on {lut_i8.device}, scales on {scales.device}, "
                         f"codes on {codes.device}")
    if not (lut_i8.is_contiguous() and scales.is_contiguous()
            and codes.is_contiguous()):
        raise ValueError("adc_scores_int8 needs contiguous inputs")
    if lut_i8.device.type == "cpu":
        return score_codes_int8_reference(lut_i8, scales, codes)
    if lut_i8.device.type != "cuda":
        raise ValueError(f"adc_scores_int8 runs on cuda or cpu, not "
                         f"{lut_i8.device}")
    N = codes.shape[0]
    gm = M // scales.shape[1]
    out = torch.empty((Q, N), dtype=torch.float32, device=lut_i8.device)
    fn = _scan_i8_fn()
    with torch.cuda.device(lut_i8.device):
        stream = torch.cuda.current_stream(lut_i8.device).cuda_stream
        err = fn(lut_i8.data_ptr(), scales.data_ptr(), codes.data_ptr(),
                 out.data_ptr(), Q, N, M, K, gm, lut_i8.device.index, stream)
    if err != 0:
        raise RuntimeError(f"adc_scan_i8 launch failed: cudaError {err} "
                           f"(Q={Q}, N={N}, M={M}, K={K}, gm={gm})")
    adc_scores_int8.launches += 1
    return out


adc_scores_int8.launches = 0


def _check_pass_inputs(name, lut, codes, n_valid):
    """What both passes take: lut (Q, M, K) bf16 with K <= 256, codes
    (>= n_valid, M) uint8, contiguous, on one device, cuda or cpu."""
    if lut.dim() != 3 or codes.dim() != 2 or codes.shape[1] != lut.shape[1]:
        raise ValueError(f"lut {tuple(lut.shape)} and codes "
                         f"{tuple(codes.shape)} do not fit (Q, M, K), (N, M)")
    if lut.dtype != torch.bfloat16 or codes.dtype != torch.uint8:
        raise TypeError(f"want a bf16 lut and uint8 codes, got {lut.dtype} "
                        f"and {codes.dtype}")
    if lut.shape[2] > 256:
        raise ValueError(f"K={lut.shape[2]} > 256 does not fit uint8 codes")
    if not 0 <= n_valid <= codes.shape[0]:
        raise ValueError(f"n_valid={n_valid} outside [0, {codes.shape[0]}]")
    if lut.device != codes.device:
        raise ValueError(f"lut on {lut.device}, codes on {codes.device}")
    if not (lut.is_contiguous() and codes.is_contiguous()):
        raise ValueError(f"{name} needs contiguous lut and codes")
    if lut.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {lut.device}")


def _launch(name, fn, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, device.index, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def adc_group_max(lut: torch.Tensor, codes: torch.Tensor, n_valid: int,
                  groups: int) -> torch.Tensor:
    """Pass 1: gmax (Q, groups) f32, the largest score of each group of
    docs 0..n_valid-1, group g holding runs g, g + G, ... of 32 docs
    (index/adc.py::doc_groups). A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes adc_group_max_reference. Each launch adds
    one to `adc_group_max.launches`."""
    _check_pass_inputs("adc_group_max", lut, codes, n_valid)
    if groups < 1:
        raise ValueError(f"groups={groups} < 1")
    if lut.device.type == "cpu":
        return adc_group_max_reference(lut, codes, n_valid, groups)
    Q, M, K = lut.shape
    gmax = torch.empty((Q, groups), dtype=torch.float32, device=lut.device)
    next_item = torch.zeros(1, dtype=torch.int32, device=lut.device)
    _launch("adc_group_max", _group_max_fn(), lut.device, lut.data_ptr(),
            codes.data_ptr(), gmax.data_ptr(), next_item.data_ptr(), Q,
            n_valid, M, K, groups)
    adc_group_max.launches += 1
    return gmax


adc_group_max.launches = 0


def adc_filter(lut: torch.Tensor, codes: torch.Tensor, n_valid: int,
               tau: torch.Tensor, cap: int, gmax=None):
    """Pass 2: every doc 0..n_valid-1 with score >= tau[q].

    Returns (cand_s (Q, cap) f32, cand_i (Q, cap) int64, count (Q,) int32):
    count[q] docs pass, and min(count[q], cap) of them fill slots 0.. in
    an order that varies from run to run; the other slots hold -inf and id
    -1. With pass 1's gmax (Q, G), the kernel skips the groups in which no
    query of a tile reaches tau; the result is the same. A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes
    adc_filter_reference. Each launch adds one to `adc_filter.launches`.
    """
    _check_pass_inputs("adc_filter", lut, codes, n_valid)
    Q = lut.shape[0]
    if (tau.shape != (Q,) or tau.dtype != torch.float32
            or tau.device != lut.device or not tau.is_contiguous()):
        raise ValueError(f"tau must be a contiguous ({Q},) f32 tensor on "
                         f"{lut.device}")
    if gmax is not None and (gmax.dim() != 2 or gmax.shape[0] != Q
                             or gmax.dtype != torch.float32
                             or gmax.device != lut.device
                             or not gmax.is_contiguous()):
        raise ValueError(f"gmax must be a contiguous ({Q}, G) f32 tensor on "
                         f"{lut.device}")
    if cap < 1:
        raise ValueError(f"cap={cap} < 1")
    if lut.device.type == "cpu":
        return adc_filter_reference(lut, codes, n_valid, tau, cap)
    M, K = lut.shape[1:]
    # without gmax, groups only split the work
    groups = (gmax.shape[1] if gmax is not None
              else max(1, min(GROUPS_MAX, -(-n_valid // RUN))))
    cand_s = torch.full((Q, cap), -torch.inf, device=lut.device)
    cand_i = torch.full((Q, cap), -1, dtype=torch.long, device=lut.device)
    counters = torch.zeros(Q + 1, dtype=torch.int32, device=lut.device)
    _launch("adc_filter", _filter_fn(), lut.device, lut.data_ptr(),
            codes.data_ptr(), tau.data_ptr(),
            None if gmax is None else gmax.data_ptr(), cand_s.data_ptr(),
            cand_i.data_ptr(), counters.data_ptr(), counters[Q:].data_ptr(),
            Q, n_valid, M, K, groups, cap)
    adc_filter.launches += 1
    return cand_s, cand_i, counters[:Q]


adc_filter.launches = 0


def select_topk(cand_s: torch.Tensor, cand_i: torch.Tensor, topk: int):
    """The first `topk` candidates by (score DESC, id ASC), so the result
    does not depend on the order in which pass 2 stored them: one
    torch.topk over a 64-bit key, the score's bits mapped to an int32 that
    orders as the floats do in the high half and 2^31 - 1 - id in the low
    half. Ids lie in [-1, 2^31) (-1 for an empty slot); scores are sums
    from +0.0, so never NaN and never -0.0 (which the key would put below
    +0.0)."""
    bits = cand_s.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    key = (key.long() << 32) | ((1 << 31) - 1 - cand_i)
    pos = torch.topk(key, topk, dim=1).indices
    return torch.gather(cand_s, 1, pos), torch.gather(cand_i, 1, pos)


def search_plan(n_valid: int, topk: int):
    """(groups, cap) of adc_topk over n_valid docs: G = min(GROUPS_MAX,
    runs of 32 docs) groups and 2k candidate slots, or (None, n_valid) when
    tau is -inf (k >= n_valid, or fewer than k groups: every doc passes)."""
    groups = min(GROUPS_MAX, -(-n_valid // RUN))
    if topk < n_valid and groups >= topk:
        return groups, 2 * topk
    return None, n_valid


def adc_topk(lut: torch.Tensor, codes: torch.Tensor, n_valid: int,
             topk: int):
    """Exact top-k of docs 0..n_valid-1 by ADC score, (scores, ids) each
    (Q, min(topk, n_valid)), sorted by score DESC, id ASC.

    Pass 1 (adc_group_max) takes the max of each of G groups; tau[q], the
    k-th largest of them, is reached by k distinct docs, so it bounds the
    k-th best score from below. Pass 2 (adc_filter) keeps the docs at or
    above tau: about k per query. Its count is read once; above the cap
    (search_plan) pass 2 runs again with cap = the count, adding one to
    `adc_topk.reruns`. Where tau would be -inf, pass 1 is skipped. Scores
    equal adc_scores' bit for bit; ids equal a top-k over them except in the
    order among exact ties.
    """
    Q, dev = lut.shape[0], lut.device
    topk = min(topk, n_valid)
    if Q == 0 or topk <= 0:
        return (torch.empty((Q, max(topk, 0)), device=dev),
                torch.empty((Q, max(topk, 0)), dtype=torch.long, device=dev))
    groups, cap = search_plan(n_valid, topk)
    gmax = None
    tau = torch.full((Q,), -torch.inf, device=dev)
    if groups is not None:
        gmax = adc_group_max(lut, codes, n_valid, groups)
        tau = torch.topk(gmax, topk, dim=1).values[:, -1].contiguous()
    cand_s, cand_i, count = adc_filter(lut, codes, n_valid, tau, cap, gmax)
    most = int(count.max())
    if most > cap:
        adc_topk.reruns += 1
        cand_s, cand_i, count = adc_filter(lut, codes, n_valid, tau, most,
                                           gmax)
    return select_topk(cand_s, cand_i, topk)


adc_topk.reruns = 0


class CudaADCIndex:
    """Device-resident PQ code index searched with the two-pass K1 top-k.

    codes (N, M) uint8 live on the device once, padded with zero rows to a
    whole number of `chunk_size` rows (the pad docs belong to no group and
    are never scored); every search builds an fp32 LUT, rounds it to bf16
    (the TPU kernel's input type) and runs adc_topk over the N real docs:
    two launches per query batch, no (Q, N) score buffer.
    """

    def __init__(self, codes, centroids, chunk_size: int = 1 << 17,
                 device="cuda"):
        self.device = resolve_device(device)
        codes = torch.as_tensor(codes)
        if codes.dtype != torch.uint8 or codes.dim() != 2:
            raise TypeError("codes must be an (N, M) uint8 array")
        self.N, self.M = codes.shape
        self.K = centroids.shape[1]
        self.chunk = max(1, min(chunk_size, self.N))
        npad = -(-self.N // self.chunk) * self.chunk
        padded = torch.zeros((npad, self.M), dtype=torch.uint8, device=self.device)
        padded[:self.N] = codes.to(self.device)
        self.codes = padded
        self.set_centroids(centroids)

    def set_centroids(self, centroids) -> None:
        """Swap codebooks (the query model's centroids, stage-2 updates)."""
        self.centroids = torch.as_tensor(centroids, dtype=torch.float32,
                                         device=self.device)

    @torch.no_grad()
    def search_device(self, query_embeds, topk: int = 1000):
        """(scores, indices) tensors on the device, each (Q, min(topk, N))."""
        q = torch.as_tensor(query_embeds, dtype=torch.float32,
                            device=self.device)
        lut = build_lut(q, self.centroids).to(torch.bfloat16).contiguous()
        return adc_topk(lut, self.codes, self.N, topk)

    def search(self, query_embeds, topk: int = 1000):
        s, i = self.search_device(query_embeds, topk)
        return s.cpu().numpy(), i.cpu().numpy()
