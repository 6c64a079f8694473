// K2 and K3: cell-grouped IVF-PQ scan for NVIDIA Hopper (sm_90a), and the
// two passes of the fused per-query top-k that serve IVF search with them.
//
// For work tile t (one cell c = work_cell[t] and kSlots = 32 query slots)
// and each of the cell's Lpad padded docs l:
//
//   K2 (bf16 LUT):  score[t, s, l] = sum_m lut[q, m, codes[c, l, m]]
//                   (f32 sums, m in order)
//   K3 (int8 LUT):  part_g        = sum_{m in group g} lut_i8[q, m, code]  (int32)
//                   score[t, s, l] = sum_g part_g * scale[q, g]
//                   (f32, g in order, the product and the sum each rounded)
//
// with q the query of slot s. One scan body (score_bf16 / score_s8) serves
// three entry points per LUT type, so their scores are equal bit for bit:
//   * repconc_ivf_scan_{bf16,i8}  K2 / K3 proper: every score, as
//                                 out (T, 32, Lpad) f32. Kept as the
//                                 yardstick of the passes; on no serve path.
//   * repconc_ivf_group_max       pass 1: the largest score of each run of
//                                 32 consecutive real docs of a pair's cell,
//                                 gmax (Q, nprobe, R) f32 in pair order
//                                 (R = ceil(Lpad / 32)).
//   * repconc_ivf_filter          pass 2: every real doc with score >=
//                                 tau[q], appended with its corpus id
//                                 (cell_ids[c, l]) to a per-query (Q, cap)
//                                 buffer, with count[q].
// tau[q] is the k-th largest of the query's run maxima: k distinct real
// docs reach it, so it bounds the k-th best score from below and the exact
// top-k lies among the docs that pass (index/cuda_ivf.py::ivf_topk).
//
// Replaces the TPU kernels repconc_tpu/index/pallas_ivf.py::_ivf_kernel (K2)
// and ::_ivf_kernel_i8 (K3), launched by _score_work_tiles
// (pallas_ivf.py:149-225), and with the passes the regroup and top-k after
// them (_regroup_topk, :314-336). The TPU kernels built each cell's one-hot
// expansion in VMEM and contracted it on the MXU against the tile's
// pre-gathered LUT rows. Hopper gathers from shared memory directly, so
// neither the one-hot form nor the (T * 32, M * K) pre-gathered LUT copy is
// carried over: the kernels read the tile's cell, its slots and the
// per-query LUT where they lie.
//
// The scan body:
//   * A block owns one work tile and a slice of its docs (grid x = tiles,
//     y = slices of kDocsPerBlock docs). Warp 0 compacts the tile's occupied
//     slots with a ballot.
//   * A whole tile's LUT (32 * M * K * 2 bytes: 786 KB at M=48) does not fit
//     the 227 KB of shared memory, so the block walks the occupied slots in
//     sub-tiles of S, staging each sub-tile's LUT as lut_s[m][k][j]
//     (j = slot within the sub-tile): one code byte then selects S entries
//     that sit next to each other, read with one vector load (K1's layout,
//     csrc/adc_scan.cu). Staging loads 8-entry runs of all S rows at once
//     (S loads in flight) and transposes them in registers: a first version
//     that loaded one 2-byte entry at a time spent most of its 5 ms (bench
//     geometry, H100) waiting on one load after another. S is the largest
//     power of two (<= 8 for bf16, <= 16 for int8, whose entries are half
//     the size) whose LUT fits kSmemBudget: at M=12 S=8 (bf16) and S=16
//     (int8), at M=48 S=4 and S=8.
//   * Each thread owns one doc at a time, reads its M code bytes and
//     accumulates the S slots' sums in registers, in m order (K2) or in
//     int32 per group then f32 in g order (K3). The plain versions
//     (index/cuda_ivf.py::score_work_tiles_reference and the passes'
//     references built on it) add in the same order. K3 combines groups
//     with __fmul_rn / __fadd_rn: nvcc would otherwise contract
//     acc + part * scale into one FMA, which rounds once where the plain
//     version rounds twice.
//   * Codes above K - 1 clamp to K - 1, as K1's do.
//
// The passes:
//   * Pads. fill_cells (both packages) leaves a cell's real docs first and
//     its pads (id -1, codes 0, a real score) after them, so docs
//     0 .. cell_len[c] - 1 are the real ones (CudaIVFIndex checks this when
//     it loads an index). A pad enters no run maximum and is never a
//     candidate; a block whose slice holds no real doc returns at once. K2
//     scores every pad and the regroup masked them afterwards; in
//     chip_smoke.py's 8.8 M-doc IVF (random codes, Lpad 8,704) about half
//     of the probed cells' padded slots are pads.
//   * Runs. A warp's 32 lanes hold 32 consecutive docs of the slice, one
//     run. Pass 1 ends the run with a transposing butterfly (warp_max, as
//     K1's passes do) and one lane per slot writes gmax at the slot's pair
//     (slot_pair[t, s] = q * nprobe + j): every run maximum has exactly one
//     writer, no atomics, and tau is one top-k over (Q, nprobe * R) with no
//     gather.
//   * Pass 2 re-scans a run only where some occupied slot of the sub-tile
//     has gmax >= its query's tau (one ballot for the warp), and appends
//     with one warp-aggregated atomicAdd per slot and ballot; past cap it
//     stores nothing but keeps counting, and the wrapper reruns it with the
//     larger cap. Without gmax (pass 1 skipped: tau is -inf) every run of an
//     occupied slot is scanned.
//
// What bounds them on this card (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32
// outside the tensor cores):
//   * K2 / K3 read T * Lpad * M code bytes and each query's LUT and write
//     T * 32 * Lpad * 4 score bytes: the score write dominates the bytes and
//     the bytes bound them. At the 8.8 M-doc IVF (nlist 4096, nprobe 64,
//     Q 1200, Lpad 8,704) that write is 4.55 GB, and the regroup reads it
//     back. Pass 1 writes Q * nprobe * R floats instead (84 MB there) and
//     pass 2 about k candidates per query. Both are then bound by their
//     adds (M per real doc and occupied slot; pass 2 only in the runs that
//     reach tau), and limited in practice by the shared-memory gathers and
//     the LUT re-staging below.
//   * Every block re-stages the LUT of each occupied slot of its tile from
//     L2 (M * K * 2 bytes per slot: 24.6 KB at M=48, 6.1 KB at M=12), once
//     per kDocsPerBlock docs. At the bench geometry (M=48, Lpad 256) that
//     is about 16 x 24.6 KB per tile for 12 KB of codes: the re-staging,
//     not the score write, is most of the traffic there, and the passes do
//     not change it. There, too, a query has only 512 runs, fewer than
//     k = 1000, so pass 1 is skipped and pass 2 keeps every real doc.
//   * At M=12 a whole tile's LUT (32 * 12 * 256 * 2 = 196 KB) would fit one
//     block's 227 KB and read each doc's codes once instead of once per
//     sub-tile; the kernels keep the 100 KB budget (two blocks per SM).
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise. Each C entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 32;                  // QT_G: query slots per tile
constexpr int kRun = 32;                    // docs per run: one per lane
constexpr int kDocsPerThread = 4;           // docs per thread before a split
constexpr int kDocsPerBlock = kThreads * kDocsPerThread;
constexpr size_t kSmemBudget = 100 * 1024;  // two blocks per SM
constexpr size_t kSmemMax = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

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

// As stage_bf16 / stage_s8 for the int8 LUT's scales: scale_s[j * G + g] is
// group g of occupied slot base + j (0 past n_occ).
__device__ __forceinline__ void stage_scales(const float* __restrict__ scales,
                                             const int* occ_q, int base,
                                             int n_occ, int S, int G,
                                             float* scale_s) {
  for (int i = threadIdx.x; i < S * G; i += blockDim.x) {
    const int j = i / G;
    scale_s[i] = base + j < n_occ
        ? scales[static_cast<long long>(occ_q[base + j]) * G + (i - j * G)] : 0.0f;
  }
}

// The scan body of K2 and of its passes: acc[j] = sum_m lut_s[m][code][j]
// over the doc's code row, f32 adds in m order.
template <int S>
__device__ __forceinline__ void score_bf16(const unsigned short* lut_s,
                                           const uint8_t* row, int M, int K,
                                           float* acc) {
#pragma unroll
  for (int j = 0; j < S; ++j) acc[j] = 0.0f;
#pragma unroll 4
  for (int m = 0; m < M; ++m) {
    const int code = min(static_cast<int>(row[m]), K - 1);
    add_bf16<S>(lut_s + (m * K + code) * S, acc);
  }
}

// The scan body of K3 and of its passes: per m-group g (m in
// [g * gm, (g + 1) * gm)) an int32 sum, then acc = acc + part * scale, the
// product and the sum each rounded, g in order.
template <int S>
__device__ __forceinline__ void score_s8(const int8_t* lut_s,
                                         const float* scale_s,
                                         const uint8_t* row, int M, int K,
                                         int gm, float* acc) {
  const int G = M / gm;
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
}

// What the kernels need of the LUT type: the shared memory of a sub-tile
// of S slots, its staging and the scan body.
template <int S>
struct LutBf16 {
  static constexpr int kS = S;
  const unsigned short* lut;  // (Q + 1, M, K) bf16 bits
  __host__ __device__ static size_t smem(int M, int K, int) {
    return static_cast<size_t>(S) * M * K * 2;
  }
  __device__ void stage(const int* occ_q, int base, int n_occ, int M, int K,
                        unsigned char* sm) const {
    stage_bf16<S>(lut, occ_q, base, n_occ, M * K,
                  reinterpret_cast<unsigned short*>(sm));
  }
  __device__ void score(const unsigned char* sm, const uint8_t* row, int M,
                        int K, float* acc) const {
    score_bf16<S>(reinterpret_cast<const unsigned short*>(sm), row, M, K, acc);
  }
};

template <int S>
struct LutS8 {
  static constexpr int kS = S;
  const int8_t* lut;     // (Q + 1, M, K) int8
  const float* scales;   // (Q + 1, M / gm) f32
  int gm;
  __host__ __device__ static size_t lut_bytes(int M, int K) {
    return (static_cast<size_t>(S) * M * K + 15) & ~size_t(15);
  }
  __host__ __device__ static size_t smem(int M, int K, int gm) {
    return lut_bytes(M, K) + static_cast<size_t>(S) * (M / gm) * 4;
  }
  __device__ void stage(const int* occ_q, int base, int n_occ, int M, int K,
                        unsigned char* sm) const {
    stage_s8<S>(lut, occ_q, base, n_occ, M * K, reinterpret_cast<int8_t*>(sm));
    stage_scales(scales, occ_q, base, n_occ, S, M / gm,
                 reinterpret_cast<float*>(sm + lut_bytes(M, K)));
  }
  __device__ void score(const unsigned char* sm, const uint8_t* row, int M,
                        int K, float* acc) const {
    score_s8<S>(reinterpret_cast<const int8_t*>(sm),
                reinterpret_cast<const float*>(sm + lut_bytes(M, K)), row, M,
                K, gm, acc);
  }
};

// K2 / K3: every score. grid: x = work tiles, y = doc slices. work_cell
// (T,), qidx (T, 32) int32, the LUT's last row Qz - 1 (all zero) for an
// empty slot; codes (nlist, Lpad, M) uint8; out (T, 32, Lpad) f32. An
// empty slot's row of out is written as exact zeros and its LUT is never
// staged.
template <class Lut>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(Lut lut, const int* __restrict__ work_cell,
                const int* __restrict__ qidx,
                const uint8_t* __restrict__ codes, float* __restrict__ out,
                long long Qz, int nlist, int Lpad, int M, int K) {
  constexpr int S = Lut::kS;
  extern __shared__ __align__(16) unsigned char smem[];
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
    __syncthreads();  // the previous sub-tile's LUT is no longer read
    lut.stage(occ_q, base, n_occ, M, K, smem);
    __syncthreads();
    for (int l = l_first; l < Lpad; l += l_stride) {
      float acc[S];
      lut.score(smem, cell + static_cast<long long>(l) * M, M, K, acc);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (base + j < n_occ)
          out_t[static_cast<long long>(occ_s[base + j]) * Lpad + l] = acc[j];
      }
    }
  }
}

// ---- the passes ------------------------------------------------------------

// The max over the warp of v[j] for every j < S (S <= 32, a power of two).
// At each of the first log2(S) steps a lane keeps half of its values and
// trades the other half with its partner (K1's warp_max, csrc/adc_scan.cu).
// Returns in each lane the max for slot lane / (32 / S).
template <int S>
__device__ __forceinline__ float warp_max(float* v, int lane) {
#pragma unroll
  for (int count = S, o = 16; count > 1; count >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < count / 2; ++i) {
      const float send = upper ? v[i] : v[i + count / 2];
      const float keep = upper ? v[i + count / 2] : v[i];
      v[i] = fmaxf(keep, __shfl_xor_sync(kFull, send, o));
    }
  }
  float m = v[0];
#pragma unroll
  for (int o = 16 / S; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  return m;
}

// The tiles and cells both passes read.
struct Tiles {
  const int* work_cell;   // (T,): the tile's cell
  const int* slot_pair;   // (T, 32): pair q * nprobe + j of a slot, -1 empty
  const uint8_t* codes;   // (nlist, Lpad, M)
  const int* cell_len;    // (nlist,): docs 0 .. cell_len - 1 are real
  long long P;            // pairs: Q * nprobe
  int nprobe, nlist, Lpad, M, K;
};

// What a block of a pass works on: its tile's cell and the slice
// [l_lo, l_hi) of the cell's real docs. Returns false when the slice holds
// none (the whole block then returns; nothing has synchronised yet).
struct Slice {
  int c, l_lo, l_hi;
};

__device__ __forceinline__ bool open_slice(const Tiles& tl, Slice* sl) {
  const int c = tl.work_cell[blockIdx.x];
  const int len = c >= 0 && c < tl.nlist ? min(tl.cell_len[c], tl.Lpad) : 0;
  sl->c = c;
  sl->l_lo = blockIdx.y * kDocsPerBlock;
  sl->l_hi = min(sl->l_lo + kDocsPerBlock, len);
  return sl->l_lo < sl->l_hi;
}

// Warp 0 lists the tile's occupied slots in slot order: occ_p[i] is the
// pair of the i-th and occ_q[i] its query. Returns after a __syncthreads().
__device__ __forceinline__ int list_pairs(const Tiles& tl, int* occ_q,
                                          int* occ_p, int* n_occ) {
  if (threadIdx.x < kSlots) {
    const int lane = threadIdx.x;
    const int p = tl.slot_pair[static_cast<long long>(blockIdx.x) * kSlots + lane];
    const bool occ = p >= 0 && p < tl.P;
    const unsigned mask = __ballot_sync(kFull, occ);
    if (occ) {
      const int pos = __popc(mask & ((1u << lane) - 1u));
      occ_q[pos] = p / tl.nprobe;
      occ_p[pos] = p;
    }
    if (lane == 0) *n_occ = __popc(mask);
  }
  __syncthreads();
  return *n_occ;
}

// Pass 1. gmax: (P, R) f32, R = ceil(Lpad / 32), filled with -inf by the
// caller; a run with no real doc keeps it.
template <class Lut>
__global__ void __launch_bounds__(kThreads)
ivf_group_max_kernel(Lut lut, Tiles tl, float* __restrict__ gmax) {
  constexpr int S = Lut::kS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int occ_q[kSlots], occ_p[kSlots], n_occ_s;
  Slice sl;
  if (!open_slice(tl, &sl)) return;
  const int n_occ = list_pairs(tl, occ_q, occ_p, &n_occ_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long runs = (tl.Lpad + kRun - 1) / kRun;
  const uint8_t* cell = tl.codes + static_cast<long long>(sl.c) * tl.Lpad * tl.M;
  for (int base = 0; base < n_occ; base += S) {
    __syncthreads();  // the previous sub-tile's LUT is no longer read
    lut.stage(occ_q, base, n_occ, tl.M, tl.K, smem);
    __syncthreads();
    for (int l0 = sl.l_lo + warp * kRun; l0 < sl.l_hi; l0 += kThreads) {
      const int l = l0 + lane;
      float acc[S];
      if (l < sl.l_hi) {
        lut.score(smem, cell + static_cast<long long>(l) * tl.M, tl.M, tl.K, acc);
      } else {  // a pad
#pragma unroll
        for (int j = 0; j < S; ++j) acc[j] = -INFINITY;
      }
      const float m = warp_max<S>(acc, lane);
      const int j = lane / (kRun / S);
      if (lane % (kRun / S) == 0 && base + j < n_occ)
        gmax[occ_p[base + j] * runs + l0 / kRun] = m;
    }
  }
}

// Pass 2. cell_ids: (nlist, Lpad) int32; tau: (Q,) f32; gmax: (P, R) f32
// from pass 1, or null to scan every run; cand_s / cand_i: (Q, cap); count:
// (Q,) int32, zeroed by the caller.
template <class Lut>
__global__ void __launch_bounds__(kThreads)
ivf_filter_kernel(Lut lut, Tiles tl, const int* __restrict__ cell_ids,
                  const float* __restrict__ tau, const float* __restrict__ gmax,
                  float* __restrict__ cand_s, long long* __restrict__ cand_i,
                  int* __restrict__ count, long long cap) {
  constexpr int S = Lut::kS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int occ_q[kSlots], occ_p[kSlots], n_occ_s;
  __shared__ float occ_tau[kSlots];
  Slice sl;
  if (!open_slice(tl, &sl)) return;
  const int n_occ = list_pairs(tl, occ_q, occ_p, &n_occ_s);
  if (threadIdx.x < n_occ) occ_tau[threadIdx.x] = tau[occ_q[threadIdx.x]];
  // (seen by all after the __syncthreads that opens the sub-tile loop)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long runs = (tl.Lpad + kRun - 1) / kRun;
  const long long cell_at = static_cast<long long>(sl.c) * tl.Lpad;
  const uint8_t* cell = tl.codes + cell_at * tl.M;
  for (int base = 0; base < n_occ; base += S) {
    __syncthreads();
    lut.stage(occ_q, base, n_occ, tl.M, tl.K, smem);
    __syncthreads();
    const int n_sub = min(S, n_occ - base);
    for (int l0 = sl.l_lo + warp * kRun; l0 < sl.l_hi; l0 += kThreads) {
      // bit j: slot base + j may have a doc >= its tau in this run
      bool reach = false;
      if (lane < n_sub)
        reach = gmax == nullptr ||
                gmax[occ_p[base + lane] * runs + l0 / kRun] >= occ_tau[base + lane];
      const unsigned want = __ballot_sync(kFull, reach);
      if (want == 0) continue;
      const int l = l0 + lane;
      const bool real = l < sl.l_hi;
      float acc[S];
      if (real) {
        lut.score(smem, cell + static_cast<long long>(l) * tl.M, tl.M, tl.K, acc);
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j) acc[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (!((want >> j) & 1u)) continue;  // warp-uniform
        const bool pass = real && acc[j] >= occ_tau[base + j];
        const unsigned ballot = __ballot_sync(kFull, pass);
        if (ballot == 0) continue;
        const long long q = occ_q[base + j];
        int first = 0;
        if (lane == 0) first = atomicAdd(count + q, __popc(ballot));
        first = __shfl_sync(kFull, first, 0);
        if (pass) {
          const long long s = first + __popc(ballot & lanes_below);
          if (s < cap) {
            cand_s[q * cap + s] = acc[j];
            cand_i[q * cap + s] = cell_ids[cell_at + l];
          }
        }
      }
    }
  }
}

dim3 grid_for(long long T, int Lpad) {
  long long slices = (Lpad + kDocsPerBlock - 1) / kDocsPerBlock;
  if (slices < 1) slices = 1;
  return dim3(static_cast<unsigned int>(T), static_cast<unsigned int>(slices));
}

bool shapes_ok(long long T, long long Qz, int nlist, int Lpad, int M, int K) {
  return T <= 0x7fffffffLL && Qz >= 1 && nlist >= 1 && Lpad >= 1 && M >= 1 &&
         K >= 1 && K <= 256 &&
         static_cast<long long>(Lpad) * M * nlist > 0;
}

// The sub-tile of a pass, as K2 / K3 pick it: the largest power of two up
// to s_max whose sub-tile fits kSmemBudget; 0 if one slot does not fit.
int sub_tile(size_t per_slot, int s_max) {
  for (int s = s_max; s >= 2; s >>= 1)
    if (s * per_slot + 16 <= kSmemBudget) return s;
  return per_slot + 16 <= kSmemMax ? 1 : 0;
}

// f(std::integral_constant<int, S>) for the sub-tile S (up to kMax).
template <int kMax, class F>
cudaError_t with_sub_tile(int S, F&& f) {
  if constexpr (kMax >= 16) {
    if (S == 16) return f(std::integral_constant<int, 16>{});
  }
  if (S == 8) return f(std::integral_constant<int, 8>{});
  if (S == 4) return f(std::integral_constant<int, 4>{});
  if (S == 2) return f(std::integral_constant<int, 2>{});
  if (S == 1) return f(std::integral_constant<int, 1>{});
  return cudaErrorInvalidValue;
}

// Runs launch(lut policy) with the LUT type's largest fitting sub-tile:
// bf16 when scales is null, else int8 with its scales.
template <class Launch>
cudaError_t with_lut(const void* lut, const void* scales, int M, int K,
                     int gm, Launch&& launch) {
  if (scales == nullptr) {
    const int S = sub_tile(static_cast<size_t>(M) * K * 2, 8);
    return with_sub_tile<8>(S, [&](auto s) {
      return launch(LutBf16<decltype(s)::value>{
          static_cast<const unsigned short*>(lut)});
    });
  }
  if (gm < 1 || M % gm != 0) return cudaErrorInvalidValue;
  const int S = sub_tile(static_cast<size_t>(M) * K + static_cast<size_t>(M / gm) * 4, 16);
  return with_sub_tile<16>(S, [&](auto s) {
    return launch(LutS8<decltype(s)::value>{
        static_cast<const int8_t*>(lut), static_cast<const float*>(scales), gm});
  });
}

// One launch over the work tiles: the LUT policy's dynamic shared memory
// set, the grid of grid_for.
template <class Lut, class Kernel, class... Args>
cudaError_t launch_tiles(Kernel kernel, const Lut& lut, long long T, int Lpad,
                         int M, int K, int gm, cudaStream_t stream,
                         Args... args) {
  const size_t smem = Lut::smem(M, K, gm);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(T, Lpad), kThreads, smem, stream>>>(lut, args...);
  return cudaGetLastError();
}

// K2 (scales null) or K3.
cudaError_t launch_scan(const void* lut, const void* scales,
                        const void* work_cell, const void* qidx,
                        const void* codes, void* out, long long T,
                        long long Qz, int nlist, int Lpad, int M, int K,
                        int gm, void* stream) {
  if (T <= 0) return cudaSuccess;
  if (!shapes_ok(T, Qz, nlist, Lpad, M, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lut(lut, scales, M, K, gm, [&](auto policy) {
    using Lut = decltype(policy);
    return launch_tiles(ivf_scan_kernel<Lut>, policy, T, Lpad, M, K, gm, s,
                        static_cast<const int*>(work_cell),
                        static_cast<const int*>(qidx),
                        static_cast<const uint8_t*>(codes),
                        static_cast<float*>(out), Qz, nlist, Lpad, M, K);
  });
}

// The tiles of a pass, or false when a shape does not fit the kernels.
bool make_tiles(const void* work_cell, const void* slot_pair, const void* codes,
                const void* cell_len, long long T, long long Q, int nprobe,
                int nlist, int Lpad, int M, int K, Tiles* tl) {
  if (!shapes_ok(T, Q + 1, nlist, Lpad, M, K) || Q < 1 || nprobe < 1 ||
      Q * nprobe > 0x7fffffffLL ||
      (Lpad + kDocsPerBlock - 1) / kDocsPerBlock > 65535)
    return false;
  *tl = Tiles{static_cast<const int*>(work_cell),
              static_cast<const int*>(slot_pair),
              static_cast<const uint8_t*>(codes),
              static_cast<const int*>(cell_len), Q * nprobe, nprobe, nlist,
              Lpad, M, K};
  return true;
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
  return launch_scan(lut, nullptr, work_cell, qidx, codes, out, T, Qz, nlist,
                     Lpad, M, K, 0, stream);
}

// As repconc_ivf_scan_bf16 with lut (Qz, M, K) int8 and scales (Qz, M / gm)
// f32; gm divides M.
extern "C" int repconc_ivf_scan_i8(const void* lut, const void* scales,
                                   const void* work_cell, const void* qidx,
                                   const void* codes, void* out, long long T,
                                   long long Qz, int nlist, int Lpad, int M,
                                   int K, int gm, void* stream) {
  return launch_scan(lut, scales, work_cell, qidx, codes, out, T, Qz, nlist,
                     Lpad, M, K, gm, stream);
}

// Pass 1. lut: (Q + 1, M, K) bf16 (scales null) or int8 with scales
// (Q + 1, M / gm) f32; work_cell: (T,) int32; slot_pair: (T, 32) int32, the
// pair q * nprobe + j of each slot, -1 if empty; codes: (nlist, Lpad, M)
// uint8; cell_len: (nlist,) int32; gmax: (Q * nprobe, ceil(Lpad / 32)) f32,
// filled with -inf. All contiguous on the current device.
extern "C" int repconc_ivf_group_max(const void* lut, const void* scales,
                                     const void* work_cell,
                                     const void* slot_pair, const void* codes,
                                     const void* cell_len, void* gmax,
                                     long long T, long long Q, int nprobe,
                                     int nlist, int Lpad, int M, int K, int gm,
                                     void* stream) {
  if (T <= 0) return cudaSuccess;
  Tiles tl;
  if (!make_tiles(work_cell, slot_pair, codes, cell_len, T, Q, nprobe, nlist,
                  Lpad, M, K, &tl))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lut(lut, scales, M, K, gm, [&](auto policy) {
    using Lut = decltype(policy);
    return launch_tiles(ivf_group_max_kernel<Lut>, policy, T, Lpad, M, K, gm,
                        s, tl, static_cast<float*>(gmax));
  });
}

// Pass 2. As pass 1, and cell_ids: (nlist, Lpad) int32; tau: (Q,) f32;
// gmax: pass 1's, or null to scan every run; cand_s: (Q, cap) f32; cand_i:
// (Q, cap) int64; count: (Q,) int32, zero. Slots past count[q] are left as
// the caller filled them.
extern "C" int repconc_ivf_filter(const void* lut, const void* scales,
                                  const void* work_cell, const void* slot_pair,
                                  const void* codes, const void* cell_len,
                                  const void* cell_ids, const void* tau,
                                  const void* gmax, void* cand_s, void* cand_i,
                                  void* count, long long T, long long Q,
                                  int nprobe, int nlist, int Lpad, int M,
                                  int K, int gm, long long cap, void* stream) {
  if (T <= 0) return cudaSuccess;
  Tiles tl;
  if (cap <= 0 || !make_tiles(work_cell, slot_pair, codes, cell_len, T, Q,
                              nprobe, nlist, Lpad, M, K, &tl))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lut(lut, scales, M, K, gm, [&](auto policy) {
    using Lut = decltype(policy);
    return launch_tiles(ivf_filter_kernel<Lut>, policy, T, Lpad, M, K, gm,
                        s, tl, static_cast<const int*>(cell_ids),
                        static_cast<const float*>(tau),
                        static_cast<const float*>(gmax),
                        static_cast<float*>(cand_s),
                        static_cast<long long*>(cand_i),
                        static_cast<int*>(count), cap);
  });
}
