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
// contracting a one-hot expansion on the MXU.
//
// Design: K1's, with int8 entries and K3's group combine.
//   * A block owns QT queries and stages their LUT as lut_s[m][k][j]
//     (QT * M * K bytes) and their scales as scale_s[j][g]: one code byte
//     selects QT int8 entries that sit next to each other, read with one
//     16-, 8-, 4-, 2- or 1-byte load. QT is the largest of 16, 8, 4, 2, 1
//     whose LUT fits kSmemBudget: QT=16 at M=12 (48 KB), QT=8 at M=48.
//   * Each thread owns one doc at a time and keeps QT int32 partial sums
//     per group (exact) and QT f32 sums; groups combine with __fmul_rn /
//     __fadd_rn, so nvcc cannot contract them into an FMA, which would round
//     once where the plain version (index/adc.py::
//     score_codes_int8_reference) rounds twice. The two agree bit for bit.
//   * Ragged Q and N are masked; no shape has to be a tile multiple (the
//     TPU kernel wanted Nc % 256 == 0 and Q % 128 == 0). Codes above K - 1
//     clamp to K - 1.
//
// Bound on this card (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32 outside the
// tensor cores): N * M code bytes, Q * M * K LUT bytes and Q * G * 4 scale
// bytes in, Q * N * 4 score bytes out, against Q * N * M int adds: the score
// write bounds it, as it bounds K1.
//
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 100 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ int s8_at(unsigned int w, int i) {
  return static_cast<int>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}

// part[j] += int8 entry j of the QT entries at p (entry 0 in the low byte).
template <int QT>
__device__ __forceinline__ void add_s8(const int8_t* p, int* part) {
  if constexpr (QT >= 4) {
    constexpr int W = QT / 4;
    unsigned int w[W];
    if constexpr (QT == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (QT == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned int*>(p);
    }
#pragma unroll
    for (int i = 0; i < QT; ++i) part[i] += s8_at(w[i / 4], i % 4);
  } else if constexpr (QT == 2) {
    const unsigned int v = *reinterpret_cast<const unsigned short*>(p);
    part[0] += s8_at(v, 0); part[1] += s8_at(v, 1);
  } else {
    part[0] += static_cast<int>(*p);
  }
}

__host__ __device__ __forceinline__ size_t lut_bytes(int QT, int M, int K) {
  return (static_cast<size_t>(QT) * M * K + 15) & ~size_t(15);
}

// grid: x = query tiles, y = doc slices. lut: (Q, M, K) int8; scales:
// (Q, M / gm) f32; codes: (N, M) uint8; out: (Q, N) f32, row-major.
template <int QT>
__global__ void __launch_bounds__(kThreads)
adc_scan_i8_kernel(const int8_t* __restrict__ lut,
                   const float* __restrict__ scales,
                   const uint8_t* __restrict__ codes,
                   float* __restrict__ out,
                   long long Q, long long N, int M, int K, int gm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int MK = M * K;
  const int G = M / gm;
  int8_t* lut_s = reinterpret_cast<int8_t*>(smem);
  float* scale_s = reinterpret_cast<float*>(smem + lut_bytes(QT, M, K));
  const long long q0 = static_cast<long long>(blockIdx.x) * QT;

  for (int i = threadIdx.x; i < QT * MK; i += blockDim.x) {
    const int j = i / MK;
    const int mk = i - j * MK;
    const long long q = q0 + j;
    lut_s[mk * QT + j] = q < Q ? lut[q * MK + mk] : 0;
  }
  for (int i = threadIdx.x; i < QT * G; i += blockDim.x) {
    const int j = i / G;
    const long long q = q0 + j;
    scale_s[i] = q < Q ? scales[q * G + (i - j * G)] : 0.0f;
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const uint8_t* row = codes + n * M;
    float acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.0f;
    for (int g = 0; g < G; ++g) {
      int part[QT];
#pragma unroll
      for (int j = 0; j < QT; ++j) part[j] = 0;
      for (int m = g * gm; m < (g + 1) * gm; ++m) {
        const int c = min(static_cast<int>(row[m]), K - 1);
        add_s8<QT>(lut_s + (m * K + c) * QT, part);
      }
#pragma unroll
      for (int j = 0; j < QT; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(static_cast<float>(part[j]),
                                             scale_s[j * G + g]));
    }
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if (q0 + j < Q) out[(q0 + j) * N + n] = acc[j];
    }
  }
}

template <int QT>
cudaError_t launch(const void* lut, const void* scales, const void* codes,
                   void* out, long long Q, long long N, int M, int K, int gm,
                   int sms, cudaStream_t stream) {
  const size_t smem = lut_bytes(QT, M, K) + static_cast<size_t>(QT) * (M / gm) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      adc_scan_i8_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  adc_scan_i8_kernel<QT><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(lut), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(codes), static_cast<float*>(out), Q, N, M, K,
      gm);
  return cudaGetLastError();
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
  if (M <= 0 || K <= 0 || K > 256 || gm < 1 || M % gm != 0)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const size_t per_query = static_cast<size_t>(M) * K + static_cast<size_t>(M / gm) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (16 * per_query + 16 <= kSmemBudget)
    return launch<16>(lut, scales, codes, out, Q, N, M, K, gm, sms, s);
  if (8 * per_query + 16 <= kSmemBudget)
    return launch<8>(lut, scales, codes, out, Q, N, M, K, gm, sms, s);
  if (4 * per_query + 16 <= kSmemBudget)
    return launch<4>(lut, scales, codes, out, Q, N, M, K, gm, sms, s);
  if (2 * per_query + 16 <= kSmemBudget)
    return launch<2>(lut, scales, codes, out, Q, N, M, K, gm, sms, s);
  if (per_query + 16 <= kSmemMax)
    return launch<1>(lut, scales, codes, out, Q, N, M, K, gm, sms, s);
  return cudaErrorInvalidValue;
}
