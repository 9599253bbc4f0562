// Expanding dot product (the paper's case-study kernel, Fig 11e
// ``fmacex.s.h``), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/dotp_ex.py ``dotp_ex_pallas``
// (body ``_dotp_kernel``).
//
// Contract (same as the TPU kernel): two streams of n elements (f32, bf16
// or fp16, one dtype for both) are laid out as rows of 128 lanes (element
// e in lane e % 128, the TPU kernel's (R, 128) tiles); each element is
// widened to the src dtype in-kernel (f32 input with a narrow src is RNE
// rounded, ``round_src``), products are taken exactly in f32 (fp16 x fp16
// and bf16 x bf16 products fit in f32's 24 bits) and summed in f32 per
// lane; the result is the (1, 128) vector of lane sums, whose total is the
// dot product (the wrapper adds the lanes, as the JAX wrapper does).
//
// What bounds it: bytes.  Two operations per element pair against 4 bytes
// (fp16) of traffic: at the op path's n = 51,380,224 fp16 pairs the card
// needs 0.0614 ms to read the 205.5 MB.  Design: pass 1 runs a fixed grid
// (at most 4 CTAs per SM, a function of n only) in which each thread owns
// 16 bytes' worth of lanes (8 fp16 / 8 bf16 / 4 f32) of successive rows,
// issuing 4 rows' 16-byte loads of both streams before summing them; the
// CTA then folds its threads' lanes into one 128-lane partial in shared
// memory and stores it.  Pass 2, one CTA of 128 threads, adds the partials
// of each lane in CTA order.  No atomics: the sum order is fixed by n, so
// the result is the same from run to run.  Elements past n (the ragged last
// row) and pointers off 16-byte alignment take masked element loads.
#include <cuda_runtime.h>

#include "quant_common.cuh"

namespace {

using namespace repro;

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kBatch = 4;                    // rows loaded before summing
constexpr int kMaxBlocks = 132 * 4;          // partial rows of scratch

template <typename T>
__device__ __forceinline__ float src_val(T x, int src_kind) {
  return round_src(to_f32(x), src_kind);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dotp_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        float* __restrict__ partial, long long n,
                        int src_kind, bool vec) {
  constexpr int kVec = 16 / sizeof(T);              // elements per load
  constexpr int kPerRow = kLanes / kVec;            // threads per row
  constexpr int kRowsPerStep = kThreads / kPerRow;  // rows per CTA step
  __shared__ float red[kRowsPerStep][kLanes];
  const int lane0 = (threadIdx.x % kPerRow) * kVec;
  const int rsub = threadIdx.x / kPerRow;
  const long long rows = (n + kLanes - 1) / kLanes;
  const long long step = (long long)gridDim.x * kRowsPerStep;
  float acc[kVec];
#pragma unroll
  for (int x = 0; x < kVec; ++x) acc[x] = 0.f;

  for (long long r0 = (long long)blockIdx.x * kRowsPerStep + rsub; r0 < rows;
       r0 += kBatch * step) {
    uint4 ra[kBatch], rb[kBatch];
    bool full[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long e0 = (r0 + u * step) * kLanes + lane0;
      full[u] = vec && r0 + u * step < rows && e0 + kVec <= n;
      if (full[u]) {
        ra[u] = __ldg(reinterpret_cast<const uint4*>(a + e0));
        rb[u] = __ldg(reinterpret_cast<const uint4*>(b + e0));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long e0 = (r0 + u * step) * kLanes + lane0;
      if (full[u]) {
        const T* ea = reinterpret_cast<const T*>(&ra[u]);
        const T* eb = reinterpret_cast<const T*>(&rb[u]);
#pragma unroll
        for (int x = 0; x < kVec; ++x)
          acc[x] += src_val(ea[x], src_kind) * src_val(eb[x], src_kind);
      } else if (r0 + u * step < rows) {
#pragma unroll
        for (int x = 0; x < kVec; ++x)
          if (e0 + x < n)
            acc[x] += src_val(a[e0 + x], src_kind) *
                      src_val(b[e0 + x], src_kind);
      }
    }
  }
#pragma unroll
  for (int x = 0; x < kVec; ++x) red[rsub][lane0 + x] = acc[x];
  __syncthreads();
  if (threadIdx.x < kLanes) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerStep; ++i) s += red[i][threadIdx.x];
    partial[(long long)blockIdx.x * kLanes + threadIdx.x] = s;
  }
}

__global__ void dotp_final_kernel(const float* __restrict__ partial,
                                  int nblocks, float* __restrict__ out) {
  float s = 0.f;
  for (int i = 0; i < nblocks; ++i) s += partial[i * kLanes + threadIdx.x];
  out[threadIdx.x] = s;
}

template <typename T>
cudaError_t launch_typed(const void* a, const void* b, void* partial,
                         void* out, long long n, int src_kind,
                         cudaStream_t stream) {
  constexpr int kRowsPerStep = kThreads / (kLanes / (16 / (int)sizeof(T)));
  const long long rows = (n + kLanes - 1) / kLanes;
  long long blocks = (rows + kRowsPerStep - 1) / kRowsPerStep;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const bool vec = ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  dotp_partial_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(partial), n, src_kind, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dotp_final_kernel<<<1, kLanes, 0, stream>>>(
      static_cast<const float*>(partial), (int)blocks,
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// ``partial`` is caller scratch of at least dotp_ex_max_blocks() * 128
// floats; ``out`` receives the 128 lane sums.
extern "C" int dotp_ex_max_blocks() { return kMaxBlocks; }

extern "C" int dotp_ex_launch(const void* a, const void* b, void* partial,
                              void* out, long long n, int in_dtype,
                              int src_kind, void* stream) {
  if (n < 0 || src_kind < SRC_F32 || src_kind > SRC_F16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case DT_F32: return launch_typed<float>(a, b, partial, out, n, src_kind, s);
    case DT_BF16:
      return launch_typed<__nv_bfloat16>(a, b, partial, out, n, src_kind, s);
    case DT_F16: return launch_typed<__half>(a, b, partial, out, n, src_kind, s);
  }
  return cudaErrorInvalidValue;
}
