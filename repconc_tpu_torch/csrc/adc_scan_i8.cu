// K4: brute-force PQ ADC scan with an int8 LUT, for NVIDIA Hopper (sm_90a).
//
//   part_g[q, n]  = sum_{m in group g} lut_i8[q, m, codes[n, m]]     (int32)
//   scores[q, n]  = sum_g part_g[q, n] * scales[q, g]
//                   (f32, g in order, the product and the sum each rounded)
//
// m-group g is m in [g * gm, (g + 1) * gm); the LUT and its per-(query,
// group) scales come from index/adc.py::quantize_lut_int8.
//
// Replaces the TPU kernel repconc_tpu/index/pallas_adc.py::
// _adc_onehot_kernel_i8 (launched by adc_scores_pallas_int8,
// pallas_adc.py:149-186), the brute-force twin of K3. Like K1
// (csrc/adc_scan.cu), it gathers from a shared-memory LUT instead of
// contracting a one-hot expansion on the tensor cores: the int8 one-hot
// product is 2 * Q * N * M * K operations (0.97 T at Q=1200, N=131,072,
// M=12, K=256), 0.49 ms at the H100's 1,979 int8 TOP/s, more than twice the
// score write's bound, so wgmma does not pay here.
//
// What bounds it on this card (H100 SXM, 3.35 TB/s HBM): the (Q, N) f32
// score write, Q * N * 4 bytes (629 MB at that shape, 0.188 ms), against
// N * M code bytes, Q * M * K LUT bytes and Q * G * 4 scale bytes read.
// Inside the SM the instructions per score come close to it: a 16-byte
// shared-memory gather per (doc, m) for 16 queries, at a random k, and the
// integer adds and the group combine behind it. Timed variants
// (recipes/bench_k4.py) show that these, issued at about half the SM's
// rate, and not the write or the gathers' bank conflicts, hold the kernel
// above its bound: without conflicts it is a few percent faster, and
// without stores no faster. The design cuts instructions per score:
//
//   * Biased 16-bit lanes. The block stages its QT queries' LUT as
//     lut_s[m][k][j] = lut_i8[q0 + j, m, k] + 128 (uint8): one code byte
//     selects QT entries side by side, read with one 16-byte load at
//     QT=16. A PRMT splits each 4-query word into two words of 16-bit
//     lanes (queries 0 and 2, 1 and 3), and plain 32-bit adds then sum two
//     queries at once. A lane sums gm entries of at most 255, at most 2,040
//     at gm=8 (and below 65,536 for any gm <= 257, which the entry point
//     checks), so no carry crosses a lane and the group sums stay exact.
//     The bias, 128 * gm, comes off once per (query, group): one PRMT
//     writes the lane under the exponent of 2^23 (the float 2^23 + sum,
//     exact), and one subtraction of 2^23 + 128 * gm leaves the group sum
//     as an exact f32, with no integer-to-float conversion. The exponent
//     comes in as a kernel argument, so it stays in a register: as a
//     literal, nvcc rebuilds it or the PRMT selector for many PRMTs.
//   * The group combine is acc = __fadd_rn(acc, __fmul_rn(part, scale)), g
//     in order, so nvcc cannot contract it into an FMA, which would round
//     once where the plain version (index/adc.py::
//     score_codes_int8_reference) rounds twice. The two agree bit for bit.
//   * Code reads. A thread owns two neighbouring docs. Their codes are
//     read one group at a time with one gm-byte load per doc (one 4-byte
//     load at gm=4, M=12), the next group's while this one is summed, not
//     one byte per m. The LUT is staged with 256 rows per m whatever K,
//     rows K..255 repeating row K - 1, so a code above K - 1 reads row
//     K - 1 with no clamp in the scan.
//   * The write. Each thread stores its two docs' scores of a query as one
//     8-byte streaming store (__stcs): a warp writes 256 contiguous bytes
//     per query row, and the 629 MB, which cannot stay in the 50 MB L2,
//     does not evict what can. A full query tile with both docs in range
//     stores with no per-query checks; only the edges take the masked path.
//   * Persistent grid. As many blocks as the SMs hold at once; block b
//     takes a contiguous range of the (query tile, 512-doc chunk) work
//     items, query tile major, so it stages a query tile's LUT once or
//     twice in all, and no block is left for a second, part-empty wave.
//
// Ragged Q and N are masked; no shape has to be a tile multiple (the TPU
// kernel wanted Nc % 256 == 0 and Q % 128 == 0). Codes above K - 1 score as
// K - 1. QT is the largest of 16, 8, 4, 2, 1 whose LUT fits kSmemBudget:
// QT=16 at M=12 (48 KB), QT=8 at M=48 (96 KB). gm of 4 and 8 (the JAX
// package's group sizes at M=12 and M=48) read codes a group at a time at
// QT >= 4; another gm, or a code pointer that is not gm-aligned, reads them
// a byte at a time.
//
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDocs = 2;  // neighbouring docs per thread
constexpr int kChunk = kThreads * kDocs;
constexpr size_t kSmemBudget = 100 * 1024;
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kRows = 256;  // staged LUT rows per m: rows K.. repeat K - 1
constexpr int kMaxGm = 257;  // gm * 255 < 65536: a 16-bit lane cannot carry
constexpr unsigned int kExp23 = 0x4B000000u;  // the float 2^23

// 16-bit lane words per QT queries: two queries a word.
template <int QT>
__host__ __device__ constexpr int lane_words() { return QT >= 2 ? QT / 2 : 1; }

// The query of half h (0 = low 16 bits) of lane word L.
template <int QT>
__host__ __device__ constexpr int lane_query(int L, int h) {
  if constexpr (QT >= 4) return 4 * (L / 2) + (L % 2) + 2 * h;
  else return h;
}

// lane[L] += the QT biased entries at p, split into 16-bit lanes.
template <int QT>
__device__ __forceinline__ void add_lanes(const uint8_t* p, uint32_t* lane) {
  if constexpr (QT >= 4) {
    uint32_t w[QT / 4];
    if constexpr (QT == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (QT == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < QT / 4; ++i) {
      lane[2 * i] += __byte_perm(w[i], 0u, 0x4240);      // queries 0, 2
      lane[2 * i + 1] += __byte_perm(w[i], 0u, 0x4341);  // queries 1, 3
    }
  } else if constexpr (QT == 2) {
    lane[0] += __byte_perm(*reinterpret_cast<const unsigned short*>(p), 0u,
                           0x4140);
  } else {
    lane[0] += *p;
  }
}

// One group's gm code bytes of a doc, in one load (gm-aligned).
template <int GM>
struct CodeLoad;
template <>
struct CodeLoad<4> {
  using T = uint32_t;
  static __device__ __forceinline__ int byte(T v, int i) {
    return __byte_perm(v, 0u, 0x4440 + i);  // byte i, zero-extended
  }
};
template <>
struct CodeLoad<8> {
  using T = uint2;
  static __device__ __forceinline__ int byte(T v, int i) {
    return __byte_perm(i < 4 ? v.x : v.y, 0u, 0x4440 + (i & 3));
  }
};

__host__ __device__ __forceinline__ size_t lut_bytes(int QT, int M) {
  return (static_cast<size_t>(QT) * M * kRows + 15) & ~size_t(15);
}

// Stage query tile q0's LUT, biased to uint8, as lut_s[m][r][j] with r in
// [0, 256) holding k = min(r, K - 1), and its scales as scale_s[g][j];
// queries past Q get 0 (biased 128) and scale 0.
template <int QT>
__device__ __forceinline__ void stage(const int8_t* __restrict__ lut,
                                      const float* __restrict__ scales,
                                      uint8_t* lut_s, float* scale_s,
                                      long long q0, long long Q, int M, int K,
                                      int G) {
  constexpr int W = (QT + 3) / 4;
  const int MK = M * K;
  for (int mr = threadIdx.x; mr < M * kRows; mr += blockDim.x) {
    const int m = mr / kRows;
    const int mk = m * K + min(mr - m * kRows, K - 1);
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0;
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const uint32_t b = q0 + j < Q
          ? static_cast<uint8_t>(lut[(q0 + j) * MK + mk]) : 0u;
      w[j / 4] |= ((b ^ 0x80u) & 0xffu) << (8 * (j % 4));
    }
    uint8_t* dst = lut_s + static_cast<size_t>(mr) * QT;
    if constexpr (QT == 16) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (QT == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else if constexpr (QT == 4) {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    } else if constexpr (QT == 2) {
      *reinterpret_cast<unsigned short*>(dst) =
          static_cast<unsigned short>(w[0]);
    } else {
      *dst = static_cast<uint8_t>(w[0]);
    }
  }
  for (int i = threadIdx.x; i < G * QT; i += blockDim.x) {
    const int g = i / QT;
    const long long q = q0 + (i - g * QT);
    scale_s[i] = q < Q ? scales[q * G + g] : 0.0f;
  }
}

// The group combine: acc[q] = acc[q] + (lane sum - 128 * gm) * scale[q].
template <int QT>
__device__ __forceinline__ void combine(const uint32_t* lane,
                                        const float* scale_s, float bias,
                                        uint32_t exp23, float* acc) {
  constexpr int LW = lane_words<QT>();
#pragma unroll
  for (int L = 0; L < LW; ++L) {
#pragma unroll
    for (int h = 0; h < (QT >= 2 ? 2 : 1); ++h) {
      const int j = lane_query<QT>(L, h);
      // the float 2^23 + the lane's biased sum (< 2^16), exact
      const uint32_t bits = __byte_perm(lane[L], exp23, h ? 0x7632 : 0x7610);
      const float f = __int_as_float(static_cast<int>(bits));
      acc[j] = __fadd_rn(acc[j], __fmul_rn(__fsub_rn(f, bias), scale_s[j]));
    }
  }
}

// grid: persistent, 1-D; block b scans work items [b * items / grid,
// (b + 1) * items / grid), item = query tile * chunks + doc chunk. lut:
// (Q, M, K) int8; scales: (Q, M / gm) f32; codes: (N, M) uint8; out:
// (Q, N) f32, row-major. GM = 0: any gm, codes read a byte at a time.
template <int QT, int GM>
__global__ void __launch_bounds__(kThreads, 2)
adc_scan_i8_kernel(const int8_t* __restrict__ lut,
                   const float* __restrict__ scales,
                   const uint8_t* __restrict__ codes,
                   float* __restrict__ out,
                   long long Q, long long N, int M, int K, int gm,
                   long long chunks, long long items, uint32_t exp23) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LW = lane_words<QT>();
  const int G = M / gm;
  uint8_t* lut_s = smem;
  float* scale_s = reinterpret_cast<float*>(smem + lut_bytes(QT, M));
  const float bias = 8388608.0f + 128.0f * gm;  // 2^23 + 128 gm, exact
  // 8-byte stores stay aligned
  const bool pairs = N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;

  const long long first = blockIdx.x * items / gridDim.x;
  const long long last = (blockIdx.x + 1) * items / gridDim.x;
  long long staged = -1;
  for (long long it = first; it < last; ++it) {
    const long long qt = it / chunks;
    const long long q0 = qt * QT;
    if (qt != staged) {  // the same for the whole block
      __syncthreads();   // every warp is done with the last tile's LUT
      stage<QT>(lut, scales, lut_s, scale_s, q0, Q, M, K, G);
      __syncthreads();
      staged = qt;
    }
    const long long n0 = ((it - qt * chunks) * kThreads + threadIdx.x) * kDocs;
    if (n0 >= N) continue;
    const uint8_t* row[kDocs];
#pragma unroll
    for (int d = 0; d < kDocs; ++d)
      row[d] = codes + (n0 + d < N ? n0 + d : N - 1) * M;

    float acc[kDocs][QT];
#pragma unroll
    for (int d = 0; d < kDocs; ++d)
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[d][j] = 0.0f;

    if constexpr (GM > 0) {
      using CL = CodeLoad<GM>;
      typename CL::T cw[kDocs], next[kDocs];
#pragma unroll
      for (int d = 0; d < kDocs; ++d)
        next[d] = *reinterpret_cast<const typename CL::T*>(row[d]);
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int d = 0; d < kDocs; ++d) cw[d] = next[d];
        if (g + 1 < G) {
#pragma unroll
          for (int d = 0; d < kDocs; ++d)
            next[d] = *reinterpret_cast<const typename CL::T*>(
                row[d] + (g + 1) * GM);
        }
        uint32_t lane[kDocs][LW];
#pragma unroll
        for (int d = 0; d < kDocs; ++d)
#pragma unroll
          for (int L = 0; L < LW; ++L) lane[d][L] = 0;
#pragma unroll
        for (int i = 0; i < GM; ++i) {
          const uint8_t* base = lut_s + (g * GM + i) * kRows * QT;
#pragma unroll
          for (int d = 0; d < kDocs; ++d)
            add_lanes<QT>(base + CL::byte(cw[d], i) * QT, lane[d]);
        }
#pragma unroll
        for (int d = 0; d < kDocs; ++d)
          combine<QT>(lane[d], scale_s + g * QT, bias, exp23, acc[d]);
      }
    } else {
      for (int g = 0; g < G; ++g) {
        uint32_t lane[kDocs][LW];
#pragma unroll
        for (int d = 0; d < kDocs; ++d)
#pragma unroll
          for (int L = 0; L < LW; ++L) lane[d][L] = 0;
        for (int m = g * gm; m < (g + 1) * gm; ++m) {
          const uint8_t* base = lut_s + m * kRows * QT;
#pragma unroll
          for (int d = 0; d < kDocs; ++d)
            add_lanes<QT>(base + row[d][m] * QT, lane[d]);
        }
#pragma unroll
        for (int d = 0; d < kDocs; ++d)
          combine<QT>(lane[d], scale_s + g * QT, bias, exp23, acc[d]);
      }
    }

    const bool both = pairs && n0 + 1 < N;
    if constexpr (kDocs == 2) {
      if (both && q0 + QT <= Q) {  // the common case: no edge to mask
        float* dst = out + q0 * N + n0;
#pragma unroll
        for (int j = 0; j < QT; ++j)
          __stcs(reinterpret_cast<float2*>(dst + j * N),
                 make_float2(acc[0][j], acc[1][j]));
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if (q0 + j >= Q) break;
      float* dst = out + (q0 + j) * N + n0;
      if constexpr (kDocs == 2) {
        if (both) {
          __stcs(reinterpret_cast<float2*>(dst),
                 make_float2(acc[0][j], acc[1][j]));
          continue;
        }
      }
#pragma unroll
      for (int d = 0; d < kDocs; ++d)
        if (n0 + d < N) __stcs(dst + d, acc[d][j]);
    }
  }
}

template <int QT, int GM>
cudaError_t launch(const void* lut, const void* scales, const void* codes,
                   void* out, long long Q, long long N, int M, int K, int gm,
                   int sms, cudaStream_t stream) {
  auto kernel = adc_scan_i8_kernel<QT, GM>;
  const size_t smem = lut_bytes(QT, M) + static_cast<size_t>(QT) * (M / gm) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long qtiles = (Q + QT - 1) / QT;
  const long long chunks = (N + kChunk - 1) / kChunk;
  const long long items = qtiles * chunks;
  long long blocks = static_cast<long long>(per_sm) * sms;
  if (blocks > items) blocks = items;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<const int8_t*>(lut), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(codes), static_cast<float*>(out), Q, N, M, K,
      gm, chunks, items, kExp23);
  return cudaGetLastError();
}

template <int QT>
cudaError_t launch_gm(const void* lut, const void* scales, const void* codes,
                      void* out, long long Q, long long N, int M, int K,
                      int gm, int sms, cudaStream_t stream) {
  // a group's gm code bytes load as one word when the rows are gm-aligned
  const bool aligned = reinterpret_cast<uintptr_t>(codes) % gm == 0;
  if constexpr (QT >= 4) {
    if (aligned && gm == 4)
      return launch<QT, 4>(lut, scales, codes, out, Q, N, M, K, gm, sms, stream);
    if (aligned && gm == 8)
      return launch<QT, 8>(lut, scales, codes, out, Q, N, M, K, gm, sms, stream);
  }
  return launch<QT, 0>(lut, scales, codes, out, Q, N, M, K, gm, sms, stream);
}

}  // namespace

// lut: (Q, M, K) int8, scales: (Q, M / gm) f32, codes: (N, M) uint8, out:
// (Q, N) f32, all contiguous on `device`, which the caller has made current.
// Returns a cudaError_t; 0 is success.
extern "C" int repconc_adc_scan_i8(const void* lut, const void* scales,
                                   const void* codes, void* out, long long Q,
                                   long long N, int M, int K, int gm,
                                   int device, void* stream) {
  if (Q <= 0 || N <= 0) return cudaSuccess;
  if (M <= 0 || K <= 0 || K > 256 || gm < 1 || gm > kMaxGm || M % gm != 0)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const size_t per_query = static_cast<size_t>(M) * kRows + static_cast<size_t>(M / gm) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (16 * per_query + 16 <= kSmemBudget)
    return launch_gm<16>(lut, scales, codes, out, Q, N, M, K, gm, sms, s);
  if (8 * per_query + 16 <= kSmemBudget)
    return launch_gm<8>(lut, scales, codes, out, Q, N, M, K, gm, sms, s);
  if (4 * per_query + 16 <= kSmemBudget)
    return launch_gm<4>(lut, scales, codes, out, Q, N, M, K, gm, sms, s);
  if (2 * per_query + 16 <= kSmemBudget)
    return launch_gm<2>(lut, scales, codes, out, Q, N, M, K, gm, sms, s);
  if (per_query + 16 <= kSmemMax)
    return launch_gm<1>(lut, scales, codes, out, Q, N, M, K, gm, sms, s);
  return cudaErrorInvalidValue;
}
