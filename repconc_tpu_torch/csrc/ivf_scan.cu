// K2 and K3: cell-grouped IVF-PQ scan for NVIDIA Hopper (sm_90a).
//
// For work tile t (one cell c = work_cell[t] and kSlots = 32 query slots
// qidx[t, s]) and each of the cell's Lpad padded docs l:
//
//   K2 (bf16 LUT):  out[t, s, l] = sum_m lut[q, m, codes[c, l, m]]
//                   (f32 sums, m in order)
//   K3 (int8 LUT):  part_g      = sum_{m in group g} lut_i8[q, m, code]  (int32)
//                   out[t, s, l] = sum_g part_g * scale[q, g]
//                   (f32, g in order, the product and the sum each rounded)
//
// with q = qidx[t, s]. A slot whose q is the LUT's last row (the all-zero
// row the host appends at index Q) or outside [0, Q) is empty: its row of
// `out` is written as exact zeros and its LUT is never staged.
//
// Replaces the TPU kernels repconc_tpu/index/pallas_ivf.py::_ivf_kernel (K2)
// and ::_ivf_kernel_i8 (K3), launched by _score_work_tiles
// (pallas_ivf.py:149-225). Those built each cell's one-hot expansion in VMEM
// and contracted it on the MXU against the tile's pre-gathered LUT rows.
// Hopper gathers from shared memory directly, so neither the one-hot form
// nor the (T * 32, M * K) pre-gathered LUT copy (3-4 GB at nlist=4096,
// nprobe=64, Q=1200, M=48) is carried over: the kernel reads work_cell, qidx,
// the per-query LUT and the cell codes where they lie.
//
// Design:
//   * A block owns one work tile and a slice of its Lpad docs (grid x =
//     tiles, y = doc slices). Warp 0 compacts the tile's occupied slots
//     with a ballot, so empty slots cost one zero store per doc.
//   * A whole tile's LUT (32 * M * K * 2 bytes: 786 KB at M=48) does not fit
//     the 227 KB of shared memory, so the block walks the occupied slots in
//     sub-tiles of S, staging each sub-tile's LUT as lut_s[m][k][j]
//     (j = slot within the sub-tile): one code byte then selects S entries
//     that sit next to each other, read with one vector load (K1's layout,
//     csrc/adc_scan.cu). Staging is repeated for every tile, so it loads
//     8-entry runs of all S rows at once (vector loads, S in flight) and
//     transposes them in registers: a first version that loaded one 2-byte
//     entry at a time spent most of its 5 ms (bench geometry, H100) waiting
//     on one load after another. S is the largest power of two (<= 8 for bf16,
//     <= 16 for int8, whose entries are half the size) whose LUT fits
//     kSmemBudget: at M=12 that is S=8 (bf16) and S=16 (int8), at M=48 S=4
//     and S=8.
//   * Each thread owns one doc at a time, reads its M code bytes and
//     accumulates the S slots' sums in registers, in m order (K2) or in
//     int32 per group then f32 in g order (K3). The plain versions
//     (index/cuda_ivf.py::score_work_tiles_reference) add in the same
//     order, so the two agree bit for bit. K3 combines groups with
//     __fmul_rn / __fadd_rn: nvcc would otherwise contract
//     acc + part * scale into one FMA, which rounds once where the plain
//     version rounds twice.
//   * No shape has to be a tile multiple: Lpad and the occupied slot count
//     are masked. Codes above K - 1 clamp to K - 1, as K1's do.
//
// Bound on this card (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32 outside the
// tensor cores): the function reads T * Lpad * M code bytes, each query's
// LUT once ((Q + 1) * M * K * b bytes, + scales) and writes T * 32 * Lpad * 4
// score bytes; it does T * 32 * Lpad * M lookups and adds. The score write
// dominates the bytes, and the bytes bound it: at M=48 about 40 adds per
// byte would be needed to be bound by the adds. The kernel itself re-reads
// each query's LUT once for every tile it is in (from L2, where the whole
// table fits) and each doc's codes once per sub-tile (from L1). Fusing the
// per-query top-k into the scan, to drop the score write, is later work.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise. Each C entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 32;                  // QT_G: query slots per tile
constexpr int kDocsPerThread = 4;           // docs per thread before a split
constexpr size_t kSmemBudget = 100 * 1024;  // two blocks per SM

__device__ __forceinline__ float bf16_lo(unsigned int w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ int s8_at(unsigned int w, int i) {
  return static_cast<int>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}

// acc[j] += bf16 entry j of the S entries at p (entry 0 in the low half).
template <int S>
__device__ __forceinline__ void add_bf16(const unsigned short* p, float* acc) {
  if constexpr (S == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    acc[0] += bf16_lo(v.x); acc[1] += bf16_hi(v.x);
    acc[2] += bf16_lo(v.y); acc[3] += bf16_hi(v.y);
    acc[4] += bf16_lo(v.z); acc[5] += bf16_hi(v.z);
    acc[6] += bf16_lo(v.w); acc[7] += bf16_hi(v.w);
  } else if constexpr (S == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    acc[0] += bf16_lo(v.x); acc[1] += bf16_hi(v.x);
    acc[2] += bf16_lo(v.y); acc[3] += bf16_hi(v.y);
  } else if constexpr (S == 2) {
    const unsigned int v = *reinterpret_cast<const unsigned int*>(p);
    acc[0] += bf16_lo(v); acc[1] += bf16_hi(v);
  } else {
    acc[0] += __uint_as_float(static_cast<unsigned int>(*p) << 16);
  }
}

// part[j] += int8 entry j of the S entries at p (entry 0 in the low byte).
template <int S>
__device__ __forceinline__ void add_s8(const int8_t* p, int* part) {
  if constexpr (S >= 4) {
    constexpr int W = S / 4;
    unsigned int w[W];
    if constexpr (S == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (S == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned int*>(p);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) part[i] += s8_at(w[i / 4], i % 4);
  } else if constexpr (S == 2) {
    const unsigned int v = *reinterpret_cast<const unsigned short*>(p);
    part[0] += s8_at(v, 0); part[1] += s8_at(v, 1);
  } else {
    part[0] += static_cast<int>(*p);
  }
}

__device__ __forceinline__ unsigned int word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// Stage the LUT rows of occupied slots base .. base + S - 1 (zero rows past
// n_occ) as lut_s[mk][j]. Each thread takes one 8-entry run of the M * K
// row and loads it for all S slots at once (S independent 16-byte loads in
// flight), then writes each of the 8 entries' S slot values with one vector
// store. Rows that are not 16-byte aligned take a scalar loop.
template <int S>
__device__ __forceinline__ void stage_bf16(const unsigned short* __restrict__ lut,
                                           const int* occ_q, int base, int n_occ,
                                           int MK, unsigned short* lut_s) {
  if ((MK & 7) == 0 && (reinterpret_cast<uintptr_t>(lut) & 15) == 0) {
    const int MK8 = MK >> 3;
    for (int v = threadIdx.x; v < MK8; v += blockDim.x) {
      uint4 w[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        w[j] = base + j < n_occ
            ? __ldg(reinterpret_cast<const uint4*>(
                  lut + static_cast<long long>(occ_q[base + j]) * MK) + v)
            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        unsigned int h[S];  // entry e of each slot, in the low 16 bits
#pragma unroll
        for (int j = 0; j < S; ++j)
          h[j] = (word_of(w[j], e >> 1) >> (16 * (e & 1))) & 0xffffu;
        unsigned short* dst = lut_s + (v * 8 + e) * S;
        if constexpr (S == 8) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(
              h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
        } else if constexpr (S == 4) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
        } else if constexpr (S == 2) {
          *reinterpret_cast<unsigned int*>(dst) = h[0] | h[1] << 16;
        } else {
          *dst = static_cast<unsigned short>(h[0]);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < S * MK; i += blockDim.x) {
      const int j = i / MK;
      const int mk = i - j * MK;
      lut_s[mk * S + j] =
          base + j < n_occ ? lut[static_cast<long long>(occ_q[base + j]) * MK + mk] : 0;
    }
  }
}

// As stage_bf16 for int8 entries: 8-entry runs, 8-byte loads, S-byte stores.
template <int S>
__device__ __forceinline__ void stage_s8(const int8_t* __restrict__ lut,
                                         const int* occ_q, int base, int n_occ,
                                         int MK, int8_t* lut_s) {
  if ((MK & 7) == 0 && (reinterpret_cast<uintptr_t>(lut) & 7) == 0) {
    const int MK8 = MK >> 3;
    for (int v = threadIdx.x; v < MK8; v += blockDim.x) {
      uint2 w[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        w[j] = base + j < n_occ
            ? __ldg(reinterpret_cast<const uint2*>(
                  lut + static_cast<long long>(occ_q[base + j]) * MK) + v)
            : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        unsigned int b[S];  // entry e of each slot, in the low 8 bits
#pragma unroll
        for (int j = 0; j < S; ++j)
          b[j] = ((e < 4 ? w[j].x : w[j].y) >> (8 * (e & 3))) & 0xffu;
        int8_t* dst = lut_s + (v * 8 + e) * S;
        if constexpr (S >= 4) {
          unsigned int packed[S / 4];
#pragma unroll
          for (int i = 0; i < S / 4; ++i)
            packed[i] = b[4 * i] | b[4 * i + 1] << 8 | b[4 * i + 2] << 16 | b[4 * i + 3] << 24;
          if constexpr (S == 16) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
          } else if constexpr (S == 8) {
            *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
          } else {
            *reinterpret_cast<unsigned int*>(dst) = packed[0];
          }
        } else if constexpr (S == 2) {
          *reinterpret_cast<unsigned short*>(dst) = static_cast<unsigned short>(b[0] | b[1] << 8);
        } else {
          *dst = static_cast<int8_t>(b[0]);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < S * MK; i += blockDim.x) {
      const int j = i / MK;
      const int mk = i - j * MK;
      lut_s[mk * S + j] =
          base + j < n_occ ? lut[static_cast<long long>(occ_q[base + j]) * MK + mk] : 0;
    }
  }
}

// Warp 0 lists the tile's occupied slots: occ_q[i] is the query and occ_s[i]
// the slot of the i-th occupied slot, in slot order; *empty_mask has a bit
// set for each empty slot. Returns after a __syncthreads().
__device__ __forceinline__ int list_slots(const int* __restrict__ qidx,
                                          long long t, long long Qz, bool cell_ok,
                                          int* occ_q, int* occ_s,
                                          unsigned int* empty_mask,
                                          int* n_occ) {
  if (threadIdx.x < kSlots) {
    const int lane = threadIdx.x;
    const int q = qidx[t * kSlots + lane];
    const bool occ = cell_ok && q >= 0 && q < Qz - 1;
    const unsigned int mask = __ballot_sync(0xffffffffu, occ);
    if (occ) {
      const int pos = __popc(mask & ((1u << lane) - 1u));
      occ_q[pos] = q;
      occ_s[pos] = lane;
    }
    if (lane == 0) {
      *n_occ = __popc(mask);
      *empty_mask = ~mask;
    }
  }
  __syncthreads();
  return *n_occ;
}

// grid: x = work tiles, y = doc slices. lut: (Qz, M, K) bf16 bits, row
// Qz - 1 the empty slots' zero row; work_cell (T,), qidx (T, 32) int32;
// codes (nlist, Lpad, M) uint8; out (T, 32, Lpad) f32.
template <int S>
__global__ void __launch_bounds__(kThreads)
ivf_scan_bf16_kernel(const unsigned short* __restrict__ lut,
                     const int* __restrict__ work_cell,
                     const int* __restrict__ qidx,
                     const uint8_t* __restrict__ codes,
                     float* __restrict__ out,
                     long long Qz, int nlist, int Lpad, int M, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* lut_s = reinterpret_cast<unsigned short*>(smem);
  __shared__ int occ_q[kSlots], occ_s[kSlots], n_occ_s;
  __shared__ unsigned int empty_s;
  const long long t = blockIdx.x;
  const int c = work_cell[t];
  const bool cell_ok = c >= 0 && c < nlist;
  const int n_occ = list_slots(qidx, t, Qz, cell_ok, occ_q, occ_s, &empty_s,
                               &n_occ_s);
  const unsigned int empty = empty_s;
  const int MK = M * K;
  const int l_stride = gridDim.y * blockDim.x;
  const int l_first = blockIdx.y * blockDim.x + threadIdx.x;
  float* out_t = out + t * kSlots * static_cast<long long>(Lpad);

  for (int l = l_first; l < Lpad; l += l_stride) {
    for (int s = 0; s < kSlots; ++s) {
      if (empty & (1u << s)) out_t[static_cast<long long>(s) * Lpad + l] = 0.0f;
    }
  }
  const uint8_t* cell = codes + static_cast<long long>(cell_ok ? c : 0) * Lpad * M;

  for (int base = 0; base < n_occ; base += S) {
    __syncthreads();  // the previous sub-tile's LUT is no longer read
    stage_bf16<S>(lut, occ_q, base, n_occ, MK, lut_s);
    __syncthreads();
    for (int l = l_first; l < Lpad; l += l_stride) {
      const uint8_t* row = cell + static_cast<long long>(l) * M;
      float acc[S];
#pragma unroll
      for (int j = 0; j < S; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
        const int code = min(static_cast<int>(row[m]), K - 1);
        add_bf16<S>(lut_s + (m * K + code) * S, acc);
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (base + j < n_occ)
          out_t[static_cast<long long>(occ_s[base + j]) * Lpad + l] = acc[j];
      }
    }
  }
}

// As ivf_scan_bf16_kernel with an int8 LUT and scales (Qz, G) f32; m-group g
// is m in [g * gm, (g + 1) * gm).
template <int S>
__global__ void __launch_bounds__(kThreads)
ivf_scan_i8_kernel(const int8_t* __restrict__ lut,
                   const float* __restrict__ scales,
                   const int* __restrict__ work_cell,
                   const int* __restrict__ qidx,
                   const uint8_t* __restrict__ codes,
                   float* __restrict__ out,
                   long long Qz, int nlist, int Lpad, int M, int K, int gm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int MK = M * K;
  const int G = M / gm;
  int8_t* lut_s = reinterpret_cast<int8_t*>(smem);
  float* scale_s = reinterpret_cast<float*>(smem + ((static_cast<size_t>(S) * MK + 15) & ~size_t(15)));
  __shared__ int occ_q[kSlots], occ_s[kSlots], n_occ_s;
  __shared__ unsigned int empty_s;
  const long long t = blockIdx.x;
  const int c = work_cell[t];
  const bool cell_ok = c >= 0 && c < nlist;
  const int n_occ = list_slots(qidx, t, Qz, cell_ok, occ_q, occ_s, &empty_s,
                               &n_occ_s);
  const unsigned int empty = empty_s;
  const int l_stride = gridDim.y * blockDim.x;
  const int l_first = blockIdx.y * blockDim.x + threadIdx.x;
  float* out_t = out + t * kSlots * static_cast<long long>(Lpad);

  for (int l = l_first; l < Lpad; l += l_stride) {
    for (int s = 0; s < kSlots; ++s) {
      if (empty & (1u << s)) out_t[static_cast<long long>(s) * Lpad + l] = 0.0f;
    }
  }
  const uint8_t* cell = codes + static_cast<long long>(cell_ok ? c : 0) * Lpad * M;

  for (int base = 0; base < n_occ; base += S) {
    __syncthreads();
    stage_s8<S>(lut, occ_q, base, n_occ, MK, lut_s);
    for (int i = threadIdx.x; i < S * G; i += blockDim.x) {
      const int j = i / G;
      scale_s[i] = base + j < n_occ
          ? scales[static_cast<long long>(occ_q[base + j]) * G + (i - j * G)] : 0.0f;
    }
    __syncthreads();
    for (int l = l_first; l < Lpad; l += l_stride) {
      const uint8_t* row = cell + static_cast<long long>(l) * M;
      float acc[S];
#pragma unroll
      for (int j = 0; j < S; ++j) acc[j] = 0.0f;
      for (int g = 0; g < G; ++g) {
        int part[S];
#pragma unroll
        for (int j = 0; j < S; ++j) part[j] = 0;
        for (int m = g * gm; m < (g + 1) * gm; ++m) {
          const int code = min(static_cast<int>(row[m]), K - 1);
          add_s8<S>(lut_s + (m * K + code) * S, part);
        }
#pragma unroll
        for (int j = 0; j < S; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(static_cast<float>(part[j]),
                                               scale_s[j * G + g]));
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (base + j < n_occ)
          out_t[static_cast<long long>(occ_s[base + j]) * Lpad + l] = acc[j];
      }
    }
  }
}

dim3 grid_for(long long T, int Lpad) {
  long long slices = (Lpad + kThreads * kDocsPerThread - 1) / (kThreads * kDocsPerThread);
  if (slices < 1) slices = 1;
  return dim3(static_cast<unsigned int>(T), static_cast<unsigned int>(slices));
}

bool shapes_ok(long long T, long long Qz, int nlist, int Lpad, int M, int K) {
  return T <= 0x7fffffffLL && Qz >= 1 && nlist >= 1 && Lpad >= 1 && M >= 1 &&
         K >= 1 && K <= 256 &&
         static_cast<long long>(Lpad) * M * nlist > 0;
}

template <int S>
cudaError_t launch_bf16(const void* lut, const void* work_cell, const void* qidx,
                        const void* codes, void* out, long long T, long long Qz,
                        int nlist, int Lpad, int M, int K, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(S) * M * K * 2;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_bf16_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ivf_scan_bf16_kernel<S><<<grid_for(T, Lpad), kThreads, smem, stream>>>(
      static_cast<const unsigned short*>(lut), static_cast<const int*>(work_cell),
      static_cast<const int*>(qidx), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), Qz, nlist, Lpad, M, K);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_i8(const void* lut, const void* scales, const void* work_cell,
                      const void* qidx, const void* codes, void* out, long long T,
                      long long Qz, int nlist, int Lpad, int M, int K, int gm,
                      cudaStream_t stream) {
  const size_t lut_bytes = (static_cast<size_t>(S) * M * K + 15) & ~size_t(15);
  const size_t smem = lut_bytes + static_cast<size_t>(S) * (M / gm) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_i8_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ivf_scan_i8_kernel<S><<<grid_for(T, Lpad), kThreads, smem, stream>>>(
      static_cast<const int8_t*>(lut), static_cast<const float*>(scales),
      static_cast<const int*>(work_cell), static_cast<const int*>(qidx),
      static_cast<const uint8_t*>(codes), static_cast<float*>(out), Qz, nlist,
      Lpad, M, K, gm);
  return cudaGetLastError();
}

}  // namespace

// lut: (Qz, M, K) bf16, row Qz - 1 zero; work_cell: (T,) int32; qidx:
// (T, 32) int32; codes: (nlist, Lpad, M) uint8; out: (T, 32, Lpad) f32; all
// contiguous on the current device. Returns a cudaError_t; 0 is success.
extern "C" int repconc_ivf_scan_bf16(const void* lut, const void* work_cell,
                                     const void* qidx, const void* codes,
                                     void* out, long long T, long long Qz,
                                     int nlist, int Lpad, int M, int K,
                                     void* stream) {
  if (T <= 0) return cudaSuccess;
  if (!shapes_ok(T, Qz, nlist, Lpad, M, K)) return cudaErrorInvalidValue;
  const size_t per_slot = static_cast<size_t>(M) * K * 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (8 * per_slot <= kSmemBudget)
    return launch_bf16<8>(lut, work_cell, qidx, codes, out, T, Qz, nlist, Lpad, M, K, s);
  if (4 * per_slot <= kSmemBudget)
    return launch_bf16<4>(lut, work_cell, qidx, codes, out, T, Qz, nlist, Lpad, M, K, s);
  if (2 * per_slot <= kSmemBudget)
    return launch_bf16<2>(lut, work_cell, qidx, codes, out, T, Qz, nlist, Lpad, M, K, s);
  if (per_slot <= 227 * 1024)
    return launch_bf16<1>(lut, work_cell, qidx, codes, out, T, Qz, nlist, Lpad, M, K, s);
  return cudaErrorInvalidValue;
}

// As repconc_ivf_scan_bf16 with lut (Qz, M, K) int8 and scales (Qz, M / gm)
// f32; gm divides M.
extern "C" int repconc_ivf_scan_i8(const void* lut, const void* scales,
                                   const void* work_cell, const void* qidx,
                                   const void* codes, void* out, long long T,
                                   long long Qz, int nlist, int Lpad, int M,
                                   int K, int gm, void* stream) {
  if (T <= 0) return cudaSuccess;
  if (!shapes_ok(T, Qz, nlist, Lpad, M, K) || gm < 1 || M % gm != 0)
    return cudaErrorInvalidValue;
  const size_t per_slot = static_cast<size_t>(M) * K + static_cast<size_t>(M / gm) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (16 * per_slot + 16 <= kSmemBudget)
    return launch_i8<16>(lut, scales, work_cell, qidx, codes, out, T, Qz, nlist, Lpad, M, K, gm, s);
  if (8 * per_slot + 16 <= kSmemBudget)
    return launch_i8<8>(lut, scales, work_cell, qidx, codes, out, T, Qz, nlist, Lpad, M, K, gm, s);
  if (4 * per_slot + 16 <= kSmemBudget)
    return launch_i8<4>(lut, scales, work_cell, qidx, codes, out, T, Qz, nlist, Lpad, M, K, gm, s);
  if (2 * per_slot + 16 <= kSmemBudget)
    return launch_i8<2>(lut, scales, work_cell, qidx, codes, out, T, Qz, nlist, Lpad, M, K, gm, s);
  if (per_slot + 16 <= 227 * 1024)
    return launch_i8<1>(lut, scales, work_cell, qidx, codes, out, T, Qz, nlist, Lpad, M, K, gm, s);
  return cudaErrorInvalidValue;
}
