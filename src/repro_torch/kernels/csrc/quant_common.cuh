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
//                  or fp16, round to nearest even;
//   * flag_bits / count_flags / flush_flags: the IEEE status flags (OF, UF,
//                  NX, NV) of that widening, per element, counted over a
//                  span and added per warp into a counter cell — the
//                  attention kernels' telemetry (``quantize_flag_masks`` /
//                  ``widen_with_flags``).
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

// ---------------------------------------------------------------------------
// IEEE status flags of the CONV stage (FPnew's fflags, FTZ flavor): the
// twin of ``quantize_flag_masks`` / ``widen_with_flags``, as a 4-bit mask.
// ---------------------------------------------------------------------------
enum FlagBit { FLAG_OF = 1, FLAG_UF = 2, FLAG_NX = 4, FLAG_NV = 8 };

// Flags of the RNE snap of an f32 onto (m, emax, emin): OF when it rounds
// beyond max normal (in both overflow modes), NX when the snapped value
// differs, UF when a nonzero value below min normal is inexact, NV for a
// NaN (Inf and NaN raise nothing else).
__device__ __forceinline__ unsigned snap_flags(float x, int m, int emax,
                                               int emin) {
  const uint32_t s = 23u - (uint32_t)m;
  const uint32_t mag = __float_as_uint(x) & 0x7FFFFFFFu;
  if (mag >= (0xFFu << 23)) return mag > (0xFFu << 23) ? FLAG_NV : 0u;
  uint32_t rmag = ((mag + (1u << (s - 1u)) - 1u + ((mag >> s) & 1u)) >> s) << s;
  const uint32_t max_bits =
      ((uint32_t)(emax + 127) << 23) | ((((1u << m) - 1u)) << s);
  unsigned f = 0u;
  if (rmag > max_bits) {
    f = FLAG_OF;
    rmag = 0xFFu << 23;  // Inf or max normal: either way not x
  }
  const uint32_t min_bits = (uint32_t)(emin + 127) << 23;
  if (rmag < min_bits) {
    const uint32_t boundary =
        ((uint32_t)(emin - 1 + 127) << 23) | ((((1u << m) - 1u)) << s);
    rmag = mag >= boundary ? min_bits : 0u;
  }
  if (rmag != mag) {
    f |= FLAG_NX;
    if (mag != 0u && mag < min_bits) f |= FLAG_UF;
  }
  return f;
}

// The flags of one stored element at the multiplier input: an f32
// container on a grid reports its snap's; native storage (or no grid)
// widens exactly, so only stored damage shows: Inf as OF, NaN as NV.
template <typename T>
__device__ __forceinline__ unsigned flag_bits(T x, Snap snap) {
  const float f = to_f32(x);
  if (sizeof(T) == 4 && snap.m > 0) return snap_flags(f, snap.m, snap.emax, snap.emin);
  const uint32_t mag = __float_as_uint(f) & 0x7FFFFFFFu;
  return mag == (0xFFu << 23) ? FLAG_OF : (mag > (0xFFu << 23) ? FLAG_NV : 0u);
}

__device__ __forceinline__ void add_flags(int (&c)[4], unsigned f) {
  c[0] += f & 1u;
  c[1] += (f >> 1) & 1u;
  c[2] += (f >> 2) & 1u;
  c[3] += (f >> 3) & 1u;
}

// Adds to ``c`` the flags of elements first, first + stride, ... < n of
// ``x`` (global memory), as 16-byte vectors where ``x`` and ``n`` allow.
template <typename T>
__device__ __forceinline__ void count_flags(const T* __restrict__ x,
                                            long long n, Snap snap, int first,
                                            int stride, int (&c)[4]) {
  constexpr int kVec = 16 / sizeof(T);
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0 && n % kVec == 0) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
#pragma unroll 4
    for (long long i = first; i < n / kVec; i += stride) {
      const uint4 raw = __ldg(xv + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kVec; ++k) add_flags(c, flag_bits(e[k], snap));
    }
  } else {
    for (long long i = first; i < n; i += stride) add_flags(c, flag_bits(x[i], snap));
  }
}

// The flags of the elements in 16 bytes of a tensor of dtype code ``dt``.
__device__ __forceinline__ void add_flags16(int (&c)[4], const uint4& raw,
                                            int dt, Snap snap) {
  switch (dt) {
#define REPRO_ADD16(T)                                      \
  {                                                         \
    const T* e = reinterpret_cast<const T*>(&raw);          \
    for (int k = 0; k < 16 / (int)sizeof(T); ++k)           \
      add_flags(c, flag_bits(e[k], snap));                  \
  } break;
    case DT_BF16: REPRO_ADD16(__nv_bfloat16)
    case DT_F16: REPRO_ADD16(__half)
    case DT_FP8E5M2: REPRO_ADD16(__nv_fp8_e5m2)
    default: REPRO_ADD16(float)
#undef REPRO_ADD16
  }
}

__device__ __forceinline__ int dtype_bytes(int dt) {
  return dt == DT_F32 ? 4 : (dt == DT_FP8E5M2 ? 1 : 2);
}

// ``count_flags`` of elements [off, off + n) of a tensor of dtype code
// ``dt`` (f32, bf16, fp16 or fp8 e5m2): 16-byte loads decoded by dtype
// where the span allows, else element by element.
__device__ __forceinline__ void count_flags_any(const void* x, int dt,
                                                long long off, long long n,
                                                Snap snap, int first,
                                                int stride, int (&c)[4]) {
  const int esz = dtype_bytes(dt), per = 16 / esz;
  const unsigned char* b = static_cast<const unsigned char*>(x) + off * esz;
  if ((reinterpret_cast<uintptr_t>(b) & 15) == 0 && n % per == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(b);
    for (long long i = first; i < n / per; i += stride)
      add_flags16(c, __ldg(v + i), dt, snap);
    return;
  }
  for (long long i = first; i < n; i += stride) {
    switch (dt) {
      case DT_BF16:
        add_flags(c, flag_bits(reinterpret_cast<const __nv_bfloat16*>(b)[i], snap));
        break;
      case DT_F16:
        add_flags(c, flag_bits(reinterpret_cast<const __half*>(b)[i], snap));
        break;
      case DT_FP8E5M2:
        add_flags(c, flag_bits(reinterpret_cast<const __nv_fp8_e5m2*>(b)[i], snap));
        break;
      default:
        add_flags(c, flag_bits(reinterpret_cast<const float*>(b)[i], snap));
    }
  }
}

// The warp's sum of four counters, on every lane.
__device__ __forceinline__ void warp_total(int (&c)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      c[k] += __shfl_xor_sync(0xffffffffu, c[k], off);
  }
}

// Adds the warp's four counters into ``cell`` (global, zeroed by the
// caller): shuffled into lane 0, one atomic per nonzero channel; nothing
// at all when the warp counted no flag.  Every lane of the warp calls it.
__device__ __forceinline__ void flush_flags(int* cell, int (&c)[4]) {
  if (!__any_sync(0xffffffffu, (c[0] | c[1] | c[2] | c[3]) != 0)) return;
  warp_total(c);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c[k]) atomicAdd(cell + k, c[k]);
  }
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
