"""K1 and K4 on Hopper: the CUDA ADC scans and the device-resident index.

Counterpart of repconc_tpu/index/pallas_adc.py:149-307. `adc_scores` is the
wrapper of the hand-written kernel in csrc/adc_scan.cu, which replaces the
TPU kernel `_adc_onehot_kernel` (pallas_adc.py:89-104); `adc_scores_int8`
wraps csrc/adc_scan_i8.cu, which replaces its int8-LUT twin
`_adc_onehot_kernel_i8` (pallas_adc.py:107-130). `CudaADCIndex` is
the counterpart of `PallasADCIndex`: padded uint8 codes on the device once,
`set_centroids`, a chunked scan with a per-chunk top-k and one final merge
(`_search_device`, pallas_adc.py:229-260).
"""
from __future__ import annotations

import ctypes

import torch

from repconc_tpu_torch import build
from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.index.adc import (build_lut,
                                         score_codes_int8_reference,
                                         score_codes_reference)

SOURCE = "adc_scan.cu"
SOURCE_I8 = "adc_scan_i8.cu"


def _scan_fn():
    """The kernel's C entry point, with its argument types declared."""
    fn = build.load_library(SOURCE).repconc_adc_scan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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


class CudaADCIndex:
    """Device-resident PQ code index searched with the K1 scan.

    codes (N, M) uint8 live on the device once, padded to a whole number of
    chunks; every search builds an fp32 LUT, rounds it to bf16 (the TPU
    kernel's input type), scans chunk by chunk with a top-k per chunk, pad
    docs masked to -inf, and merges all chunks' candidates in one top-k.
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
        topk = min(topk, self.N)
        k_chunk = min(topk, self.chunk)
        nc = self.codes.shape[0] // self.chunk
        cand_s, cand_i = [], []
        for c in range(nc):
            base = c * self.chunk
            scores = adc_scores(lut, self.codes[base:base + self.chunk])
            valid = self.N - base
            if valid < self.chunk:
                scores[:, valid:] = -torch.inf
            s, i = torch.topk(scores, k_chunk, dim=1, sorted=nc == 1)
            cand_s.append(s)
            cand_i.append(i + base)
        if nc == 1:
            return cand_s[0], cand_i[0]
        s, pos = torch.topk(torch.cat(cand_s, 1), topk, dim=1)
        return s, torch.gather(torch.cat(cand_i, 1), 1, pos)

    def search(self, query_embeds, topk: int = 1000):
        s, i = self.search_device(query_embeds, topk)
        return s.cpu().numpy(), i.cpu().numpy()
