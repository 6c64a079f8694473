// K1 and its two-pass top-k: brute-force PQ ADC for NVIDIA Hopper (sm_90a).
//
//   scores[q, n] = sum_m lut[q, m, codes[n, m]]      (f32 sums, m in order)
//
// Replaces the TPU kernel repconc_tpu/index/pallas_adc.py::_adc_onehot_kernel
// (pallas_adc.py:89, launched by adc_scores_pallas, pallas_adc.py:189-221),
// and, with the two passes below, the TPU search loop around it
// (_search_device, pallas_adc.py:229-260: score a chunk, write it out, top-k
// it, merge). The TPU kernel built a one-hot expansion of the codes and
// contracted it on the MXU, because the TPU could not gather from a 256-row
// table (pallas_adc.py:4-11). Hopper gathers from shared memory directly, so
// the one-hot form is not carried over.
//
// One scan body serves three entry points, so that they add the same bf16
// entries in the same order and their scores are equal bit for bit:
//   * repconc_adc_scan       writes the (Q, N) f32 scores (K1 proper).
//   * repconc_adc_group_max  pass 1: the largest score of each of G groups
//                            of docs, gmax (Q, G) f32.
//   * repconc_adc_filter     pass 2: every valid doc with score >= tau[q],
//                            appended to a per-query (Q, cap) buffer of
//                            (f32 score, int64 id), with count[q].
// tau[q] is the k-th largest of gmax[q]: k distinct docs reach it, so it is a
// lower bound on the k-th best score, and the exact top-k lies among the
// docs that pass. No (Q, N) score buffer is written and no top-k runs over
// one; pass 2 leaves about k candidates per query.
//
// The scan body:
//   * A block owns QT queries (a query tile) and stages their LUT in shared
//     memory as lut_s[m][k][j] (j = query within the tile), QT*M*K*2 bytes:
//     one code byte then selects QT bf16 entries that sit next to each other,
//     read with one 16-, 8-, 4- or 2-byte load.
//   * Each thread scores one doc at a time: it reads the doc's code row (as
//     4-byte words when M % 4 == 0, else byte by byte) and accumulates
//     sum_m lut_s[m][code][j] in f32 registers for all QT queries, in m order
//     (the plain version, index/adc.py::score_codes_reference, adds in the
//     same order). Codes above K - 1 clamp to K - 1.
//   * The query tile QT is the largest of 8, 4, 2, 1 whose LUT fits
//     kSmemBudget: QT=8 at M=12, K=256 (48 KB); QT=2 at M=96 (96 KB). Above
//     48 KB the kernels run on dynamic shared memory after
//     cudaFuncSetAttribute. M*K*2 bytes must fit in 227 KB.
//
// Groups (both passes). A run is 32 consecutive docs, one per lane of a warp;
// group g holds runs g, g + G, g + 2G, ...: interleaved over the whole corpus,
// so a corpus sorted by topic cannot pile its best docs into a few groups.
// Docs at or past n_valid (padding) belong to no group. One warp owns a
// (query tile, group) pair: each lane keeps a running max over its docs, one
// __shfl_xor reduction ends the group (warp_max), and one lane per query
// writes gmax: every group's maximum has exactly one writer, no atomics.
// Work items are (query tile, range of G/64 groups), handed out by an atomic
// counter in an order that keeps all query tiles of one doc range in flight
// together, so the codes are read from HBM about once and from L2 by the
// other tiles.
// Pass 2 skips, for a whole warp at once, every group in which no query of
// the tile reaches its tau (gmax[q][g] < tau[q]): such a group holds no
// candidate. It appends with one warp-aggregated atomicAdd per query and
// ballot; past cap it stores nothing but keeps counting, and the wrapper
// reruns it with the larger cap.
//
// Bounds on this card (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32 outside the
// tensor cores):
//   * K1 reads N*M code bytes and Q*M*K*2 LUT bytes and writes Q*N*4 score
//     bytes; it does Q*N*M adds. The score write dominates: it is bound by
//     bytes.
//   * Pass 1 does the same Q*N*M adds but writes only Q*G*4 bytes: it is
//     bound by its adds. Pass 2 does the adds of the groups that reach tau
//     (about k groups per query) and writes about k candidates per query.
//   * In practice the passes run at the rate of the shared-memory gathers: a
//     quarter-warp's eight 16-byte loads land at random rows, so their bank
//     groups collide (about 2.5x the ideal wavefronts).
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise. Each C entry point returns cudaGetLastError() after its
// launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 32;                     // docs per run
constexpr int kChunks = 64;                  // group ranges per query tile
constexpr size_t kSmemBudget = 100 * 1024;   // two blocks per SM at M<=96
constexpr size_t kSmemMax = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_lo(unsigned int w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}

// acc[j] += bf16 entry j of the QT entries at p (little-endian: entry 0 is the
// low half of the first word).
template <int QT>
__device__ __forceinline__ void add_entries(const unsigned short* p, float* acc) {
  if constexpr (QT == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    acc[0] += bf16_lo(v.x); acc[1] += bf16_hi(v.x);
    acc[2] += bf16_lo(v.y); acc[3] += bf16_hi(v.y);
    acc[4] += bf16_lo(v.z); acc[5] += bf16_hi(v.z);
    acc[6] += bf16_lo(v.w); acc[7] += bf16_hi(v.w);
  } else if constexpr (QT == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    acc[0] += bf16_lo(v.x); acc[1] += bf16_hi(v.x);
    acc[2] += bf16_lo(v.y); acc[3] += bf16_hi(v.y);
  } else if constexpr (QT == 2) {
    const unsigned int v = *reinterpret_cast<const unsigned int*>(p);
    acc[0] += bf16_lo(v); acc[1] += bf16_hi(v);
  } else {
    acc[0] += __uint_as_float(static_cast<unsigned int>(*p) << 16);
  }
}

// The scan body: acc[j] = sum_m lut_s[m][min(row[m], K-1)][j], m in order.
// `words`: M % 4 == 0 and the row is 4-byte aligned.
template <int QT>
__device__ __forceinline__ void score_row(const unsigned short* lut_s,
                                          const uint8_t* row, int M, int K,
                                          bool words, float* acc) {
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] = 0.0f;
  if (words) {
    const unsigned int* row32 = reinterpret_cast<const unsigned int*>(row);
#pragma unroll 3
    for (int w = 0; w < (M >> 2); ++w) {
      const unsigned int word = __ldg(row32 + w);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = min(static_cast<int>((word >> (8 * b)) & 0xffu), K - 1);
        add_entries<QT>(lut_s + ((4 * w + b) * K + c) * QT, acc);
      }
    }
  } else {
#pragma unroll 4
    for (int m = 0; m < M; ++m) {
      const int c = min(static_cast<int>(row[m]), K - 1);
      add_entries<QT>(lut_s + (m * K + c) * QT, acc);
    }
  }
}

// The max over the warp of v[q] for every q < QT. At each of the first
// log2(QT) steps a lane keeps half of its values and trades the other half
// with its partner, so 9 shuffles reduce 8 values (not 40). Returns in each
// lane the max for query lane / (32 / QT).
template <int QT>
__device__ __forceinline__ float warp_max(float* v, int lane) {
#pragma unroll
  for (int count = QT, o = 16; count > 1; count >>= 1, o >>= 1) {
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
  for (int o = 16 / QT; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  return m;
}

// Stage the LUT of the query tile starting at q0: reads run along (m, k),
// coalesced; rows past Q are zero.
template <int QT>
__device__ __forceinline__ void stage_lut(const unsigned short* __restrict__ lut,
                                          unsigned short* lut_s, long long q0,
                                          long long Q, int MK) {
  for (int i = threadIdx.x; i < QT * MK; i += blockDim.x) {
    const int j = i / MK;
    const int mk = i - j * MK;
    const long long q = q0 + j;
    lut_s[mk * QT + j] = q < Q ? lut[q * MK + mk] : 0;
  }
}

// K1. grid: x = query tiles, y = doc slices. lut: (Q, M, K) bf16 bits; codes:
// (N, M) uint8; out: (Q, N) f32, row-major.
template <int QT>
__global__ void __launch_bounds__(kThreads)
adc_scan_kernel(const unsigned short* __restrict__ lut,
                const uint8_t* __restrict__ codes,
                float* __restrict__ out,
                long long Q, long long N, int M, int K, bool words) {
  extern __shared__ __align__(16) unsigned short lut_s[];
  const long long q0 = static_cast<long long>(blockIdx.x) * QT;
  stage_lut<QT>(lut, lut_s, q0, Q, M * K);
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    float acc[QT];
    score_row<QT>(lut_s, codes + n * M, M, K, words, acc);
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if (q0 + j < Q) out[(q0 + j) * N + n] = acc[j];
    }
  }
}

// What the two passes share: the problem, the work items and the counter
// that hands them out.
struct Pass {
  const unsigned short* lut;
  const uint8_t* codes;
  long long Q, n_valid;
  int M, K, G;
  bool words;
  int* next_item;  // zeroed by the caller
};

// The next work item for the block, or -1 when none is left. An item is a
// (query tile, group range) pair, numbered range-major so that the blocks in
// flight share their code rows. Restages the LUT when the tile changes.
template <int QT>
__device__ __forceinline__ long long next_item(const Pass& p,
                                               unsigned short* lut_s,
                                               long long* staged, int* slot) {
  const long long qtiles = (p.Q + QT - 1) / QT;
  const int chunks = min(kChunks, p.G);
  __syncthreads();  // every thread is done with the last item and its LUT
  if (threadIdx.x == 0) *slot = atomicAdd(p.next_item, 1);
  __syncthreads();
  const long long item = *slot;
  if (item >= qtiles * chunks) return -1;
  const long long qt = item % qtiles;
  if (qt != *staged) {
    stage_lut<QT>(p.lut, lut_s, qt * QT, p.Q, p.M * p.K);
    __syncthreads();
    *staged = qt;
  }
  return item;
}

// pass 1. gmax: (Q, G) f32.
template <int QT>
__global__ void __launch_bounds__(kThreads)
adc_group_max_kernel(Pass p, float* __restrict__ gmax) {
  extern __shared__ __align__(16) unsigned short lut_s[];
  __shared__ int slot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qtiles = (p.Q + QT - 1) / QT;
  const long long nruns = (p.n_valid + kRun - 1) / kRun;
  const int chunks = min(kChunks, p.G);
  const int per_chunk = (p.G + chunks - 1) / chunks;
  long long staged = -1;
  for (long long item; (item = next_item<QT>(p, lut_s, &staged, &slot)) >= 0;) {
    const long long q0 = (item % qtiles) * QT;
    const int g_lo = static_cast<int>(item / qtiles) * per_chunk;
    const int g_hi = min(p.G, g_lo + per_chunk);
    for (int g = g_lo + warp; g < g_hi; g += kWarps) {
      float best[QT];
#pragma unroll
      for (int j = 0; j < QT; ++j) best[j] = -INFINITY;
      for (long long r = g; r < nruns; r += p.G) {
        const long long n = r * kRun + lane;
        if (n < p.n_valid) {
          float acc[QT];
          score_row<QT>(lut_s, p.codes + n * p.M, p.M, p.K, p.words, acc);
#pragma unroll
          for (int j = 0; j < QT; ++j) best[j] = fmaxf(best[j], acc[j]);
        }
      }
      const float m = warp_max<QT>(best, lane);
      const int j = lane / (32 / QT);
      if (lane % (32 / QT) == 0 && q0 + j < p.Q) gmax[(q0 + j) * p.G + g] = m;
    }
  }
}

// pass 2. tau: (Q,) f32; gmax: (Q, G) f32 from pass 1, or null to scan every
// group; cand_s / cand_i: (Q, cap); count: (Q,) int32, zeroed by the caller.
template <int QT>
__global__ void __launch_bounds__(kThreads)
adc_filter_kernel(Pass p, const float* __restrict__ tau,
                  const float* __restrict__ gmax, float* __restrict__ cand_s,
                  long long* __restrict__ cand_i, int* __restrict__ count,
                  long long cap) {
  extern __shared__ __align__(16) unsigned short lut_s[];
  __shared__ int slot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qtiles = (p.Q + QT - 1) / QT;
  const long long nruns = (p.n_valid + kRun - 1) / kRun;
  const int chunks = min(kChunks, p.G);
  const int per_chunk = (p.G + chunks - 1) / chunks;
  const unsigned lanes_below = (1u << lane) - 1u;
  long long staged = -1;
  for (long long item; (item = next_item<QT>(p, lut_s, &staged, &slot)) >= 0;) {
    const long long q0 = (item % qtiles) * QT;
    const int g_lo = static_cast<int>(item / qtiles) * per_chunk;
    const int g_hi = min(p.G, g_lo + per_chunk);
    float t[QT];
    unsigned tile = 0;  // bit j: query q0 + j exists
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const bool real = q0 + j < p.Q;
      t[j] = real ? tau[q0 + j] : 0.0f;
      tile |= static_cast<unsigned>(real) << j;
    }
    for (int g = g_lo + warp; g < g_hi; g += kWarps) {
      unsigned want = tile;  // bit j: query j may have a doc >= tau here
      if (gmax != nullptr) {
        const bool reach = lane < QT && q0 + lane < p.Q &&
                           gmax[(q0 + lane) * p.G + g] >= tau[q0 + lane];
        want = __ballot_sync(kFull, reach);
      }
      if (want == 0) continue;
      for (long long r = g; r < nruns; r += p.G) {
        const long long n = r * kRun + lane;
        const bool valid = n < p.n_valid;
        float acc[QT];
        if (valid) {
          score_row<QT>(lut_s, p.codes + n * p.M, p.M, p.K, p.words, acc);
        } else {
#pragma unroll
          for (int j = 0; j < QT; ++j) acc[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          if (!((want >> j) & 1u)) continue;  // warp-uniform
          const bool pass = valid && acc[j] >= t[j];
          const unsigned ballot = __ballot_sync(kFull, pass);
          if (ballot == 0) continue;
          int base = 0;
          if (lane == 0) base = atomicAdd(count + q0 + j, __popc(ballot));
          base = __shfl_sync(kFull, base, 0);
          if (pass) {
            const long long s = base + __popc(ballot & lanes_below);
            if (s < cap) {
              cand_s[(q0 + j) * cap + s] = acc[j];
              cand_i[(q0 + j) * cap + s] = n;
            }
          }
        }
      }
    }
  }
}

size_t lut_bytes(int QT, int M, int K) {
  return static_cast<size_t>(QT) * M * K * 2;
}

// The query tile whose LUT fits the budget, 0 if none fits.
int query_tile(int M, int K) {
  const size_t per_query = lut_bytes(1, M, K);
  if (8 * per_query <= kSmemBudget) return 8;
  if (4 * per_query <= kSmemBudget) return 4;
  if (2 * per_query <= kSmemBudget) return 2;
  if (per_query <= kSmemMax) return 1;
  return 0;
}

bool word_rows(const void* codes, int M) {
  return M % 4 == 0 && (reinterpret_cast<uintptr_t>(codes) & 3u) == 0;
}

template <int QT>
cudaError_t launch_scan(const void* lut, const void* codes, void* out,
                        long long Q, long long N, int M, int K, int sms,
                        cudaStream_t stream) {
  const size_t smem = lut_bytes(QT, M, K);
  cudaError_t err = cudaFuncSetAttribute(
      adc_scan_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long qtiles = (Q + QT - 1) / QT;
  if (qtiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // Enough blocks for ~8 per SM in all; each doc slice strides over N.
  long long slices = (N + kThreads - 1) / kThreads;
  long long want = (8LL * sms + qtiles - 1) / qtiles;
  if (slices > want) slices = want;
  if (slices > 65535) slices = 65535;
  if (slices < 1) slices = 1;
  dim3 grid(static_cast<unsigned int>(qtiles), static_cast<unsigned int>(slices));
  adc_scan_kernel<QT><<<grid, kThreads, smem, stream>>>(
      static_cast<const unsigned short*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), Q, N, M, K, word_rows(codes, M));
  return cudaGetLastError();
}

// A persistent grid for a pass: as many blocks as fit on the card at once,
// no more than there are work items.
template <typename Kernel>
cudaError_t pass_grid(Kernel kernel, size_t smem, long long items, int device,
                      int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long b = static_cast<long long>(per_sm) * sms;
  if (b > items) b = items;
  *blocks = static_cast<int>(b < 1 ? 1 : b);
  return cudaSuccess;
}

long long pass_items(const Pass& p, int QT) {
  const int chunks = p.G < kChunks ? p.G : kChunks;
  return (p.Q + QT - 1) / QT * chunks;
}

template <int QT>
cudaError_t launch_group_max(const Pass& p, void* gmax, int device,
                             cudaStream_t stream) {
  const size_t smem = lut_bytes(QT, p.M, p.K);
  int blocks = 0;
  cudaError_t err = pass_grid(adc_group_max_kernel<QT>, smem,
                              pass_items(p, QT), device, &blocks);
  if (err != cudaSuccess) return err;
  adc_group_max_kernel<QT><<<blocks, kThreads, smem, stream>>>(
      p, static_cast<float*>(gmax));
  return cudaGetLastError();
}

template <int QT>
cudaError_t launch_filter(const Pass& p, const void* tau, const void* gmax,
                          void* cand_s, void* cand_i, void* count,
                          long long cap, int device, cudaStream_t stream) {
  const size_t smem = lut_bytes(QT, p.M, p.K);
  int blocks = 0;
  cudaError_t err = pass_grid(adc_filter_kernel<QT>, smem, pass_items(p, QT),
                              device, &blocks);
  if (err != cudaSuccess) return err;
  adc_filter_kernel<QT><<<blocks, kThreads, smem, stream>>>(
      p, static_cast<const float*>(tau), static_cast<const float*>(gmax),
      static_cast<float*>(cand_s), static_cast<long long*>(cand_i),
      static_cast<int*>(count), cap);
  return cudaGetLastError();
}

cudaError_t check_pass(int M, int K, int G) {
  if (M <= 0 || K <= 0 || K > 256 || G <= 0) return cudaErrorInvalidValue;
  if (query_tile(M, K) == 0) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// lut: (Q, M, K) bf16, codes: (N, M) uint8, out: (Q, N) f32, all contiguous
// on `device`, which the caller has made current. Returns a cudaError_t; 0 is
// success.
extern "C" int repconc_adc_scan(const void* lut, const void* codes, void* out,
                                long long Q, long long N, int M, int K,
                                int device, void* stream) {
  if (Q <= 0 || N <= 0) return cudaSuccess;
  if (M <= 0 || K <= 0 || K > 256) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (query_tile(M, K)) {
    case 8: return launch_scan<8>(lut, codes, out, Q, N, M, K, sms, s);
    case 4: return launch_scan<4>(lut, codes, out, Q, N, M, K, sms, s);
    case 2: return launch_scan<2>(lut, codes, out, Q, N, M, K, sms, s);
    case 1: return launch_scan<1>(lut, codes, out, Q, N, M, K, sms, s);
    default: return cudaErrorInvalidValue;
  }
}

// Pass 1. lut: (Q, M, K) bf16; codes: (>= n_valid, M) uint8; gmax: (Q, G)
// f32; next_item: one int32, zero. Groups hold runs of 32 docs (see above).
extern "C" int repconc_adc_group_max(const void* lut, const void* codes,
                                     void* gmax, void* next_item, long long Q,
                                     long long n_valid, int M, int K, int G,
                                     int device, void* stream) {
  if (Q <= 0) return cudaSuccess;
  cudaError_t err = check_pass(M, K, G);
  if (err != cudaSuccess) return err;
  const Pass p{static_cast<const unsigned short*>(lut),
               static_cast<const uint8_t*>(codes), Q, n_valid, M, K, G,
               word_rows(codes, M), static_cast<int*>(next_item)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (query_tile(M, K)) {
    case 8: return launch_group_max<8>(p, gmax, device, s);
    case 4: return launch_group_max<4>(p, gmax, device, s);
    case 2: return launch_group_max<2>(p, gmax, device, s);
    default: return launch_group_max<1>(p, gmax, device, s);
  }
}

// Pass 2. tau: (Q,) f32; gmax: (Q, G) f32 or null; cand_s: (Q, cap) f32;
// cand_i: (Q, cap) int64; count: (Q,) int32, zero; next_item: one int32,
// zero. Slots past count[q] are left as the caller filled them.
extern "C" int repconc_adc_filter(const void* lut, const void* codes,
                                  const void* tau, const void* gmax,
                                  void* cand_s, void* cand_i, void* count,
                                  void* next_item, long long Q,
                                  long long n_valid, int M, int K, int G,
                                  long long cap, int device, void* stream) {
  if (Q <= 0 || n_valid <= 0) return cudaSuccess;
  cudaError_t err = check_pass(M, K, G);
  if (err != cudaSuccess) return err;
  if (cap <= 0) return cudaErrorInvalidValue;
  const Pass p{static_cast<const unsigned short*>(lut),
               static_cast<const uint8_t*>(codes), Q, n_valid, M, K, G,
               word_rows(codes, M), static_cast<int*>(next_item)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (query_tile(M, K)) {
    case 8: return launch_filter<8>(p, tau, gmax, cand_s, cand_i, count, cap, device, s);
    case 4: return launch_filter<4>(p, tau, gmax, cand_s, cand_i, count, cap, device, s);
    case 2: return launch_filter<2>(p, tau, gmax, cand_s, cand_i, count, cap, device, s);
    default: return launch_filter<1>(p, tau, gmax, cand_s, cand_i, count, cap, device, s);
  }
}
