// CONV-stage device helpers shared by every kernel of the port (FPnew CONV
// block): storage format -> compute format at the FMA input, and the
// standalone grid snap of tp_quant.
//
// CUDA twin of src/repro_torch/kernels/quant_common.py (and of the JAX
// package's kernels/quant_common.py ``quantize_bits`` / ``widen``):
//   * to_f32:      exact widening of a stored element (f32, bf16, fp16,
//                  fp8 e5m2) to f32;
//   * quantize_bits: integer-space RNE or stochastic snap of an f32
//                  container onto an (e, m) grid — FTZ below min normal
//                  except the RNE boundary band, which rounds up to min
//                  normal; overflow to +-Inf (or saturate); Inf/NaN pass
//                  through; ``quantize_rne_bits`` is its RNE form;
//   * round_src:   the cast to the multiply ("src") dtype — f32 (none), bf16
//                  or fp16, round to nearest even.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace repro {

// src_kind codes shared with the Python wrappers
enum SrcKind { SRC_F32 = 0, SRC_BF16 = 1, SRC_F16 = 2 };

// dtype codes of stored tensors shared with the Python wrappers
enum DtypeCode { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2, DT_FP8E5M2 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}

// Integer-space rounding onto the grid of a format with m mantissa bits and
// exponent range [emin, emax] (1 <= m <= 22): RNE, or stochastic with the
// low 23 - m bits of ``rbits`` as the addend.  Below min normal the value
// flushes to zero, except (RNE only) the boundary band
// [min_normal * (1 - 2^-(m+1)), min_normal), which rounds up to min normal.
// Overflow goes to +-Inf, or +-max normal with ``saturate``.  Inf and NaN
// pass through.  The one rounding stage every kernel of the port shares.
__device__ __forceinline__ float quantize_bits(float x, uint32_t rbits, int m,
                                               int emax, int emin,
                                               bool stochastic,
                                               bool saturate) {
  const uint32_t s = 23u - (uint32_t)m;
  const uint32_t bits = __float_as_uint(x);
  const uint32_t sign = bits & 0x80000000u;
  const uint32_t mag = bits ^ sign;
  if (mag >= (0xFFu << 23)) return x;  // Inf / NaN pass through
  const uint32_t addend =
      stochastic ? (rbits & ((1u << s) - 1u))
                 : (1u << (s - 1u)) - 1u + ((mag >> s) & 1u);
  uint32_t rmag = ((mag + addend) >> s) << s;
  const uint32_t max_bits =
      ((uint32_t)(emax + 127) << 23) | ((((1u << m) - 1u)) << s);
  if (rmag > max_bits) rmag = saturate ? max_bits : (0xFFu << 23);
  const uint32_t min_bits = (uint32_t)(emin + 127) << 23;
  if (rmag < min_bits) {
    const uint32_t boundary =
        ((uint32_t)(emin - 1 + 127) << 23) | ((((1u << m) - 1u)) << s);
    rmag = (!stochastic && mag >= boundary) ? min_bits : 0u;
  }
  return __uint_as_float(sign | rmag);
}

// RNE snap (m == 0 is never passed here: callers test ``Snap::m`` first).
__device__ __forceinline__ float quantize_rne_bits(float x, int m, int emax,
                                                   int emin) {
  return quantize_bits(x, 0u, m, emax, emin, false, false);
}

__device__ __forceinline__ float round_src(float x, int src_kind) {
  if (src_kind == SRC_BF16) return __bfloat162float(__float2bfloat16_rn(x));
  if (src_kind == SRC_F16) return __half2float(__float2half_rn(x));
  return x;
}

// Grid-snap parameters of an emulated narrow storage format (m == 0: none).
struct Snap {
  int m, emax, emin;
};

// widen: the snap applies only to f32 containers (native narrow dtypes are
// already on their grid), then the cast to the src dtype.
template <typename T>
__device__ __forceinline__ float widen(T x, Snap snap, int src_kind) {
  float f = to_f32(x);
  if (sizeof(T) == 4 && snap.m > 0) f = quantize_rne_bits(f, snap.m, snap.emax, snap.emin);
  return round_src(f, src_kind);
}

// Copy ``n`` rows of ``d`` elements into shared memory as widened f32: row
// r starts at element ``off[r]`` of ``src`` and lands at ``dst + r * ld``.
// All kThreads threads of the block take part; there is no barrier inside.
// A tile is a few tens of KB and one CTA per SM must keep most of it in
// flight to hide HBM latency, so rows move as 16-byte vectors, kBatch
// loads issued per thread before any is used (element by element when a
// row is not a whole number of vectors).
template <int kThreads, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          const long long* off, int n, int d,
                                          Snap snap, int src_kind) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kBatch = 8;
  const int tid = threadIdx.x;
  if (d % kVec == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int per_row = d / kVec, total = n * per_row;
    for (int base = tid; base < total; base += kBatch * kThreads) {
      uint4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = base + u * kThreads;
        if (c < total) {
          const int r = c / per_row, cc = c - r * per_row;
          raw[u] = __ldg(reinterpret_cast<const uint4*>(
              src + off[r] + (long long)cc * kVec));
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = base + u * kThreads;
        if (c < total) {
          const int r = c / per_row, cc = c - r * per_row;
          const T* e = reinterpret_cast<const T*>(&raw[u]);
          float* o = dst + r * ld + cc * kVec;
#pragma unroll
          for (int x = 0; x < kVec; ++x) o[x] = widen(e[x], snap, src_kind);
        }
      }
    }
  } else {
    for (int i = tid; i < n * d; i += kThreads) {
      const int r = i / d, dd = i - r * d;
      dst[r * ld + dd] = widen(src[off[r] + dd], snap, src_kind);
    }
  }
}

}  // namespace repro
