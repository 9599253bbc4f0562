// Fused quantize and cast-and-pack (FPnew CONV block), for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/tp_quant.py
// ``tp_quantize_pallas`` (body ``_quant_kernel``) and
// ``cast_and_pack_pallas`` (body ``_pack_kernel``): one source, two entry
// points.
//
// Contract (same as the TPU kernels): each f32 element is snapped onto an
// (e, m) grid by the shared integer stage ``quantize_bits``
// (quant_common.cuh) — RNE, or stochastic with the caller's 32 random bits
// per element as the addend source — with FTZ below min normal, then
// stored in f32 / bf16 / fp16 (an RNE cast, exact where the grid fits the
// output type).  Cast-and-pack snaps two streams, b with ``~rbits``, and
// interleaves them: out[2e] = q(a[e]), out[2e + 1] = q(b[e]) over the flat
// element index e, which is out[:, 2i] / out[:, 2i + 1] of an [R, C] pair.
//
// What bounds it: bytes.  Each element costs about a dozen integer
// operations against 8 to 16 bytes of traffic, far below the card's
// operations-per-byte ridge: quantizing an f32 [3584, 14336] weight moves
// 411 MB (617 MB with random bits), 0.123 ms (0.184 ms) at 3.35 TB/s.
// Design: a flat grid-stride loop over 4-element vectors — 16-byte loads
// of x, and of the random bits only in stochastic mode (RNE reads no
// rbits at all); 16-byte (f32) or 8-byte (bf16 / fp16) stores; pack
// writes the interleaved a/b pairs of a vector as 16-byte stores.  Up to 8
// CTAs of 256 threads per SM keep enough loads in flight to cover HBM
// latency.  A ragged tail (n not a multiple of 4) or a pointer off 16-byte
// alignment takes the element-wise loop.
#include <cuda_runtime.h>

#include "quant_common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct QParams {
  int m, emax, emin;
};

template <bool kStoch>
__device__ __forceinline__ float q1(float x, uint32_t r, const QParams& p) {
  return quantize_bits(x, r, p.m, p.emax, p.emin, kStoch, false);
}

template <typename OT>
__device__ __forceinline__ OT cvt(float v);
template <>
__device__ __forceinline__ float cvt<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half cvt<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ uint32_t bits16(__half h) {
  return __half_as_ushort(h);
}
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 h) {
  return __bfloat16_as_ushort(h);
}

// two 16-bit outputs in one 32-bit word, ``lo`` at the lower address
template <typename OT>
__device__ __forceinline__ uint32_t pair16(float lo, float hi) {
  return bits16(cvt<OT>(lo)) | (bits16(cvt<OT>(hi)) << 16);
}

// four consecutive outputs (16 bytes of f32 or 8 bytes of 16-bit values)
template <typename OT>
__device__ __forceinline__ void store4(OT* p, float a, float b, float c,
                                       float d) {
  if constexpr (sizeof(OT) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pair16<OT>(a, b),
                                              pair16<OT>(c, d));
  }
}

// eight consecutive outputs (two 16-byte stores of f32, or one of 16-bit)
template <typename OT>
__device__ __forceinline__ void store8(OT* p, const float (&v)[8]) {
  if constexpr (sizeof(OT) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pair16<OT>(v[0], v[1]), pair16<OT>(v[2], v[3]),
                   pair16<OT>(v[4], v[5]), pair16<OT>(v[6], v[7]));
  }
}

template <typename OT, bool kStoch>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x,
                    const uint32_t* __restrict__ rb, OT* __restrict__ out,
                    long long n, bool vec, QParams p) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nvec = vec ? n / 4 : 0;
  for (long long v = tid; v < nvec; v += stride) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(x) + v);
    uint4 rv = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kStoch) rv = __ldg(reinterpret_cast<const uint4*>(rb) + v);
    store4(out + 4 * v, q1<kStoch>(xv.x, rv.x, p), q1<kStoch>(xv.y, rv.y, p),
           q1<kStoch>(xv.z, rv.z, p), q1<kStoch>(xv.w, rv.w, p));
  }
  for (long long e = nvec * 4 + tid; e < n; e += stride) {
    out[e] = cvt<OT>(q1<kStoch>(x[e], kStoch ? rb[e] : 0u, p));
  }
}

template <typename OT, bool kStoch>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const uint32_t* __restrict__ rb, OT* __restrict__ out,
                long long n, bool vec, QParams p) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nvec = vec ? n / 4 : 0;
  for (long long v = tid; v < nvec; v += stride) {
    const float4 av = __ldg(reinterpret_cast<const float4*>(a) + v);
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b) + v);
    uint4 rv = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kStoch) rv = __ldg(reinterpret_cast<const uint4*>(rb) + v);
    const float q[8] = {q1<kStoch>(av.x, rv.x, p), q1<kStoch>(bv.x, ~rv.x, p),
                        q1<kStoch>(av.y, rv.y, p), q1<kStoch>(bv.y, ~rv.y, p),
                        q1<kStoch>(av.z, rv.z, p), q1<kStoch>(bv.z, ~rv.z, p),
                        q1<kStoch>(av.w, rv.w, p), q1<kStoch>(bv.w, ~rv.w, p)};
    store8(out + 8 * v, q);
  }
  for (long long e = nvec * 4 + tid; e < n; e += stride) {
    const uint32_t r = kStoch ? rb[e] : 0u;
    out[2 * e] = cvt<OT>(q1<kStoch>(a[e], r, p));
    out[2 * e + 1] = cvt<OT>(q1<kStoch>(b[e], ~r, p));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <typename OT, bool kStoch>
cudaError_t launch_quant(const void* x, const void* rb, void* out,
                         long long n, QParams p, cudaStream_t s) {
  const bool vec = aligned16(x) && aligned16(out) && (!kStoch || aligned16(rb));
  quantize_kernel<OT, kStoch><<<blocks_for(vec ? n / 4 : n), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(rb),
      static_cast<OT*>(out), n, vec, p);
  return cudaGetLastError();
}

template <typename OT, bool kStoch>
cudaError_t launch_pack(const void* a, const void* b, const void* rb,
                        void* out, long long n, QParams p, cudaStream_t s) {
  const bool vec = aligned16(a) && aligned16(b) && aligned16(out) &&
                   (!kStoch || aligned16(rb));
  pack_kernel<OT, kStoch><<<blocks_for(vec ? n / 4 : n), kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const uint32_t*>(rb), static_cast<OT*>(out), n, vec, p);
  return cudaGetLastError();
}

template <bool kStoch>
cudaError_t quant_out(const void* x, const void* rb, void* out, long long n,
                      int out_dtype, QParams p, cudaStream_t s) {
  switch (out_dtype) {
    case DT_F32: return launch_quant<float, kStoch>(x, rb, out, n, p, s);
    case DT_BF16: return launch_quant<__nv_bfloat16, kStoch>(x, rb, out, n, p, s);
    case DT_F16: return launch_quant<__half, kStoch>(x, rb, out, n, p, s);
  }
  return cudaErrorInvalidValue;
}

template <bool kStoch>
cudaError_t pack_out(const void* a, const void* b, const void* rb, void* out,
                     long long n, int out_dtype, QParams p, cudaStream_t s) {
  switch (out_dtype) {
    case DT_F32: return launch_pack<float, kStoch>(a, b, rb, out, n, p, s);
    case DT_BF16:
      return launch_pack<__nv_bfloat16, kStoch>(a, b, rb, out, n, p, s);
    case DT_F16: return launch_pack<__half, kStoch>(a, b, rb, out, n, p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tp_quantize_launch(const void* x, const void* rbits, void* out,
                                  long long n, int stochastic, int out_dtype,
                                  int m, int emax, int emin, void* stream) {
  if (n < 0 || m < 1 || m > 22 || (stochastic && rbits == nullptr))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const QParams p{m, emax, emin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stochastic ? quant_out<true>(x, rbits, out, n, out_dtype, p, s)
                    : quant_out<false>(x, rbits, out, n, out_dtype, p, s);
}

extern "C" int cast_and_pack_launch(const void* a, const void* b,
                                    const void* rbits, void* out, long long n,
                                    int stochastic, int out_dtype, int m,
                                    int emax, int emin, void* stream) {
  if (n < 0 || m < 1 || m > 22 || (stochastic && rbits == nullptr))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const QParams p{m, emax, emin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stochastic ? pack_out<true>(a, b, rbits, out, n, out_dtype, p, s)
                    : pack_out<false>(a, b, rbits, out, n, out_dtype, p, s);
}
