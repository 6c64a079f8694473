// K1: brute-force PQ ADC scan for NVIDIA Hopper (sm_90a).
//
//   scores[q, n] = sum_m lut[q, m, codes[n, m]]      (f32 sums, m in order)
//
// Replaces the TPU kernel repconc_tpu/index/pallas_adc.py::_adc_onehot_kernel
// (launched by adc_scores_pallas, pallas_adc.py:189-221). That kernel built a
// one-hot expansion of the codes and contracted it on the MXU, because the
// TPU could not gather from a 256-row table (pallas_adc.py:4-11). Hopper
// gathers from shared memory directly, so the one-hot form is not carried
// over.
//
// Design: a shared-memory LUT gather.
//   * A block owns QT queries (a query tile) and stages their LUT in shared
//     memory as lut_s[m][k][j] (j = query within the tile), QT*M*K*2 bytes:
//     one code byte then selects QT bf16 entries that sit next to each other,
//     read with one 16-, 8-, 4- or 2-byte load.
//   * Each thread owns one doc at a time: it reads the doc's M code bytes once
//     and accumulates sum_m lut_s[m][code][j] in f32 registers for all QT
//     queries, in m order (the plain version, index/adc.py::
//     score_codes_reference, adds in the same order, so the two agree bit for
//     bit). Blocks stride over docs, so one LUT staging serves many docs.
//   * Ragged Q and N are masked in the kernel; no shape has to be a multiple
//     of a tile. Codes above K - 1 clamp to K - 1.
//   * The query tile QT is the largest of 8, 4, 2, 1 whose LUT fits
//     kSmemBudget: at M=12, K=256 that is QT=8 (48 KB); at M=96 it is QT=2
//     (96 KB). Above 48 KB the kernel runs on dynamic shared memory after
//     cudaFuncSetAttribute. M*K*2 bytes must fit in 227 KB (M <= 454 at
//     K=256).
//
// Bound on this card (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32 outside the
// tensor cores): the function reads the codes, N*M bytes, and the LUT,
// Q*M*K*2 bytes, and writes the scores, Q*N*4 bytes; it does Q*N*M shared-
// memory lookups and f32 adds. The output dominates the bytes, so at the
// main path's shapes the scan is bound by writing the scores (4 bytes per
// (query, doc) pair against M adds). A fused per-chunk top-k would remove
// that write; wgmma and TMA are later work.
//
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 100 * 1024;  // two blocks per SM at M<=96
constexpr size_t kSmemMax = 227 * 1024;

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

// grid: x = query tiles, y = doc slices. lut: (Q, M, K) bf16 bits; codes:
// (N, M) uint8; out: (Q, N) f32, row-major.
template <int QT>
__global__ void __launch_bounds__(kThreads)
adc_scan_kernel(const unsigned short* __restrict__ lut,
                const uint8_t* __restrict__ codes,
                float* __restrict__ out,
                long long Q, long long N, int M, int K) {
  extern __shared__ __align__(16) unsigned short lut_s[];
  const long long q0 = static_cast<long long>(blockIdx.x) * QT;
  const int MK = M * K;

  // Stage the tile's LUT: reads run along (m, k), coalesced; rows past Q
  // are zero (their scores are never written).
  for (int i = threadIdx.x; i < QT * MK; i += blockDim.x) {
    const int j = i / MK;
    const int mk = i - j * MK;
    const long long q = q0 + j;
    lut_s[mk * QT + j] = q < Q ? lut[q * MK + mk] : 0;
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const uint8_t* row = codes + n * M;
    float acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.0f;
#pragma unroll 4
    for (int m = 0; m < M; ++m) {
      const int c = min(static_cast<int>(row[m]), K - 1);
      add_entries<QT>(lut_s + (m * K + c) * QT, acc);
    }
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if (q0 + j < Q) out[(q0 + j) * N + n] = acc[j];
    }
  }
}

template <int QT>
cudaError_t launch(const void* lut, const void* codes, void* out, long long Q,
                   long long N, int M, int K, int sms, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(QT) * M * K * 2;
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
      static_cast<float*>(out), Q, N, M, K);
  return cudaGetLastError();
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
  const size_t per_query = static_cast<size_t>(M) * K * 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (8 * per_query <= kSmemBudget) return launch<8>(lut, codes, out, Q, N, M, K, sms, s);
  if (4 * per_query <= kSmemBudget) return launch<4>(lut, codes, out, Q, N, M, K, sms, s);
  if (2 * per_query <= kSmemBudget) return launch<2>(lut, codes, out, Q, N, M, K, sms, s);
  if (per_query <= kSmemMax) return launch<1>(lut, codes, out, Q, N, M, K, sms, s);
  return cudaErrorInvalidValue;
}

