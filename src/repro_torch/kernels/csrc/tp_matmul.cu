// Multi-format (expanding-FMA) tiled matmul, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/tp_matmul.py
// ``tp_matmul_pallas`` (body ``_mm_kernel``).
//
// Contract (same as the TPU kernel): out[M, N] = a[M, K] @ b[K, N] with
// operands in f32 / bf16 / fp16 / fp8 e5m2 (one dtype for both), widened
// exactly to f32 and, when a grid is given (``Snap::m`` > 0), RNE-snapped
// onto it with FTZ (``quantize_rne_bits``: the fused CONV->ADDMUL step);
// products summed in f32 over all of K; one RNE cast to the output dtype
// (f32 / bf16 / fp16) on store.  M, K and N are arbitrary; every load and
// store outside the matrices is masked.
//
// What bounds it: at the op path's main shape, bf16 [256, 3584] @
// [3584, 14336] -> bf16, the card needs 0.0334 ms to move the 111.9 MB
// (3.35 TB/s) and 0.0266 ms for the 26.3 GFLOP at the bf16 tensor-core rate
// (989 TFLOP/s): bytes, by a little, so a fast kernel has to stream the
// weight once at full HBM rate AND run on tensor cores.  Snapped operands
// are exact in bf16 / fp16, so tensor cores could take them unchanged.
// Design of this first version: a classic shared-memory GEMM on the f32 FMA
// units.  A CTA of 256 threads owns a 128 x 128 output tile and walks K in
// steps of 16; operands are widened (and snapped) as they are staged into
// shared memory, so each element is converted once per tile visit; each
// thread accumulates an 8 x 8 micro-tile whose rows and columns are strided
// by 16, so shared-memory reads are broadcasts or consecutive (no bank
// conflicts) and the stores of a warp cover consecutive columns.  The f32
// FMA units cap it near 67 TFLOP/s (0.4 ms at the main shape), about 12x
// the bound before any inefficiency: ``mma``/``wgmma`` tiles with a
// TMA-fed pipeline are the later step.
#include <cuda_runtime.h>

#include "quant_common.cuh"

namespace {

using namespace repro;

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kTM = 8, kTN = 8;             // micro-tile of one thread
constexpr int kStrideM = kBM / kTM;         // 16 thread rows
constexpr int kStrideN = kBN / kTN;         // 16 thread columns
static_assert(kStrideM * kStrideN == kThreads, "one micro-tile per thread");

// Widen a stored operand to f32 and, with a grid, snap it onto the grid.
template <typename T>
__device__ __forceinline__ float stage(T x, const Snap& snap) {
  float v = to_f32(x);
  if (snap.m > 0) v = quantize_rne_bits(v, snap.m, snap.emax, snap.emin);
  return v;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_out(__half* p, float v) {
  *p = __float2half_rn(v);
}

template <typename T, typename OT>
__global__ void __launch_bounds__(kThreads)
    tp_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     OT* __restrict__ out, int M, int K, int N, Snap snap) {
  // A is staged transposed (As[k][m]); the +1 pad spreads a warp's
  // transposing stores over distinct banks
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ty = tid / kStrideN, tx = tid % kStrideN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < kBM * kBK / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K)
                     ? stage(a[(long long)gm * K + gk], snap) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBK * kBN / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N)
                     ? stage(b[(long long)gk * N + gn], snap) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ra[kTM], rb[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) ra[i] = As[kk][ty + i * kStrideM];
#pragma unroll
      for (int j = 0; j < kTN; ++j) rb[j] = Bs[kk][tx + j * kStrideN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * kStrideM;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * kStrideN;
      if (gn < N) store_out(out + (long long)gm * N + gn, acc[i][j]);
    }
  }
}

template <typename T, typename OT>
cudaError_t launch_typed(const void* a, const void* b, void* out, int m,
                         int k, int n, Snap snap, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  tp_matmul_kernel<T, OT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<OT*>(out), m, k, n, snap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_out(const void* a, const void* b, void* out, int m, int k,
                       int n, int out_dtype, Snap snap, cudaStream_t stream) {
  switch (out_dtype) {
    case DT_F32: return launch_typed<T, float>(a, b, out, m, k, n, snap, stream);
    case DT_BF16:
      return launch_typed<T, __nv_bfloat16>(a, b, out, m, k, n, snap, stream);
    case DT_F16: return launch_typed<T, __half>(a, b, out, m, k, n, snap, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tp_matmul_launch(const void* a, const void* b, void* out,
                                int m, int k, int n, int in_dtype,
                                int out_dtype, int q_m, int q_emax,
                                int q_emin, void* stream) {
  if (m < 0 || k < 0 || n < 0 || (m + kBM - 1) / kBM > 65535 ||
      q_m < 0 || q_m > 22)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const Snap snap{q_m, q_emax, q_emin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case DT_F32: return launch_out<float>(a, b, out, m, k, n, out_dtype, snap, s);
    case DT_BF16:
      return launch_out<__nv_bfloat16>(a, b, out, m, k, n, out_dtype, snap, s);
    case DT_F16: return launch_out<__half>(a, b, out, m, k, n, out_dtype, snap, s);
    case DT_FP8E5M2:
      return launch_out<__nv_fp8_e5m2>(a, b, out, m, k, n, out_dtype, snap, s);
  }
  return cudaErrorInvalidValue;
}
