// Multi-format (expanding-FMA) matmul, for sm_90a: two variants.
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
// weight once at full HBM rate AND run on tensor cores.
//
// ``tp_matmul_tc`` (tensor cores): taken whenever the operands as
// multiplied are exact in a 16-bit type (``tc_operand_dtype`` in
// kernels/tp_matmul.py): bf16 and fp16 operands as they are, e5m2 widened
// to fp16, snapped f32 operands whose grid fits fp16 or bf16.  A 16-bit
// wgmma with an f32 accumulator then computes the contract's function.
// A CTA of three warpgroups owns a BM x 128 output tile (BM = 128, or 256
// when M > 128 so that at the op path's M <= 256 every weight element is
// read from HBM once) and walks its share of K in 64-deep steps through a
// 4-stage ring in shared memory (128-byte swizzle): one thread of
// warpgroup 0 keeps the TMA loads in flight (out-of-bounds rows and columns
// zero-filled, which also pads M = 4 up to the tile), warpgroups 1 and 2
// each run m64n128k16 wgmmas on half the rows, keeping one wgmma group in
// flight while the next stage is awaited.  Operands that are not 16-bit
// tile-type values with 16-byte aligned rows (f32 with a grid, e5m2, ragged
// K or N) first pass through a staging kernel that widens / snaps them
// exactly into 16-bit copies with rows padded to 8 elements; TMA reads
// those.  (Converting inside the GEMM would make every CTA re-convert its
// share of the activation, and a producer converting through registers
// keeps too few bytes in flight to stream the weight.)
// Where the output tiles leave SMs idle (N = 3584), K is split: each split
// writes f32 partials to a workspace and a second pass adds them in split
// order (no atomics, so results repeat from run to run) and does the output
// cast.  The tile and split plan is made on the host (``plan_tc`` in
// kernels/tp_matmul.py).
//
// ``tp_matmul_split`` (the split route: f32 operands that no 16-bit type
// holds — f32 without a grid, tf32 and other grids of up to 22 mantissa
// bits): the staging pass cuts each operand into P bf16 pieces
// (``tc::split_bf16``; P = 2 holds <= 17 significant bits exactly, the
// tf32 grid among them, P = 3 every normal f32), once, into [P][rows][ld]
// copies, and the tensor-core GEMM above, on 128-row tiles (P pieces of A
// and B for a 64-deep step take 96 KB, so two stages at P = 3, three at
// P = 2), runs the kept piece pairs (``tc::for_each_pair``: i + j <= 2,
// six at P = 3, all four at P = 2) into one f32 accumulator, smallest
// weight first.  What it drops (mid x lo, lo x mid, lo x lo) is at most
// 2^-23 |a||b| a product by the loose bound (each piece is at most 2^-8
// of what it splits), 2^-26 by the tight one: below the sum-order term of
// ``agreement_tol``, 2 K 2^-24 (|A| @ |B|), from K = 1 up.  At P = 2 every
// kept pair is exact.  Bound at the op path's main shape: six passes of
// 26.3 GFLOP at the bf16 rate, 0.160 ms, plus the staging pass's 205 MB
// of f32 weight read and 308 MB of pieces written.  K splits as
// ``tp_matmul_tc``'s does (``plan_split``), the partials added in order.
// Non-finite operands keep IEEE's results: an Inf is its last piece,
// zeros before it, and where it still meets a partner's zero piece the
// NaN that gives is recomputed from the pieces' values
// (``split_dot_repair``; the sum over the split's K range).
//
// ``tp_matmul_fma`` (the first version; no product routes to it since the
// split route, kept and timed beside it): a shared-memory GEMM on the
// f32 FMA units.  A CTA of 256 threads owns a 128 x 128 output tile and
// walks K in steps of 16; operands are widened (and snapped) as they are
// staged into shared memory; each thread accumulates an 8 x 8 micro-tile
// whose rows and columns are strided by 16, so shared-memory reads are
// broadcasts or consecutive.  The f32 FMA units cap it near 67 TFLOP/s.
#include <cuda_runtime.h>

#include "quant_common.cuh"
#include "tc_common.cuh"

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

extern "C" int tp_matmul_fma_launch(const void* a, const void* b, void* out,
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

// ===========================================================================
// tp_matmul_tc: a staging pass where the operands need one, then wgmma tiles
// fed by TMA
// ===========================================================================
namespace {

using namespace repro;

constexpr int kTcBN = 128, kTcBK = 64, kTcStages = 4, kTcThreads = 384;
constexpr int kTcProducerRegs = 40, kTcConsumerRegs = 232;
constexpr uint32_t kTcBBytes = kTcBK * kTcBN * 2;  // two 64-column chunks
constexpr uint32_t kTcBChunk = kTcBK * 128;        // one chunk: 64 rows

struct TcParams {
  void* out;
  float* ws;  // [splits, M, N] f32 partials (splits > 1)
  int M, K, N;
  int out_dtype;
  int nkb, kb_per_split, splits;
};

template <int WM>
__host__ __device__ constexpr uint32_t tc_a_bytes() {
  return 128u * WM * 128u;  // BM rows of 64 16-bit values
}
template <int WM>
__host__ __device__ constexpr uint32_t tc_smem_bytes() {
  return kTcStages * (tc_a_bytes<WM>() + kTcBBytes) + 2 * kTcStages * 8 +
         1024;  // + barriers + alignment slack
}

// Eight elements of one row, ``col`` .. ``col + 7``, widened to f32; zeros
// past the row's end.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ row, int col,
                                      int ncols, float (&v)[8]) {
  const T* p = row + col;
  constexpr uintptr_t kAlign = sizeof(T) == 1 ? 7 : 15;  // one or two loads
  if (col + 8 <= ncols && (reinterpret_cast<uintptr_t>(p) & kAlign) == 0) {
    if constexpr (sizeof(T) == 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p));
      const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
    } else if constexpr (sizeof(T) == 2) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = to_f32(e[i]);
    } else {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = to_f32(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = col + i < ncols ? to_f32(p[i]) : 0.f;
  }
}

// The staging pass: src [rows, cols] (any operand dtype) widened exactly,
// snapped onto the grid when one is given, and written as the 16-bit tile
// type into dst [rows, ld] (ld = cols rounded up to 8, the padding zero),
// whose rows TMA can read.
template <typename T, typename TT>
__global__ void stage_kernel(const T* __restrict__ src, uint4* __restrict__ dst,
                             int rows, int cols, int ld, Snap snap) {
  const long long per_row = ld / 8, total = (long long)rows * per_row;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < total; g += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(g / per_row), c = (int)(g % per_row) * 8;
    float v[8];
    load8(src + (long long)r * cols, c, cols, v);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float lo = v[2 * i], hi = v[2 * i + 1];
      if (snap.m > 0) {
        lo = quantize_rne_bits(lo, snap.m, snap.emax, snap.emin);
        hi = quantize_rne_bits(hi, snap.m, snap.emax, snap.emin);
      }
      w[i] = tc::pack2<TT>(lo, hi);
    }
    dst[g] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void store_pair(void* out, int out_dtype,
                                           long long idx, float x, float y,
                                           bool two) {
  if (out_dtype == DT_F32) {
    float* o = static_cast<float*>(out) + idx;
    if (two) *reinterpret_cast<float2*>(o) = make_float2(x, y);
    else *o = x;
  } else if (out_dtype == DT_BF16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + idx;
    if (two) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
    else *o = __float2bfloat16_rn(x);
  } else {
    __half* o = static_cast<__half*>(out) + idx;
    if (two) *reinterpret_cast<__half2*>(o) = __floats2half2_rn(x, y);
    else *o = __float2half_rn(x);
  }
}

// The epilogue of a consumer warpgroup: its WM m64n128 accumulators (rows
// m0 + (cw * WM + mi) * 64 ..) to the output, or to this split's f32
// partials when K is split.
template <int WM>
__device__ __forceinline__ void store_tile(const TcParams& p,
                                           const float (&acc)[WM][64], int m0,
                                           int n0, int cw, int t) {
  const int warp = t / 32, lane = t % 32;
  const bool split = p.splits > 1;
  void* dst = split ? static_cast<void*>(p.ws + (long long)blockIdx.z * p.M * p.N)
                    : p.out;
  const int dt = split ? DT_F32 : p.out_dtype;
  const bool even = (p.N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < WM; ++mi) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (cw * WM + mi) * 64 + 16 * warp + lane / 4 + 8 * h;
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (row < p.M && col < p.N) {
          const float x = acc[mi][4 * j + 2 * h], y = acc[mi][4 * j + 2 * h + 1];
          const long long idx = (long long)row * p.N + col;
          if (col + 1 < p.N && even) {
            store_pair(dst, dt, idx, x, y, true);
          } else {
            store_pair(dst, dt, idx, x, 0.f, false);
            if (col + 1 < p.N) store_pair(dst, dt, idx + 1, y, 0.f, false);
          }
        }
      }
    }
  }
}

template <typename TT, int WM>
__global__ void __launch_bounds__(kTcThreads, 1)
    tp_matmul_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        TcParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  constexpr uint32_t kABytes = tc_a_bytes<WM>();
  uint8_t* As = smem;
  uint8_t* Bs = smem + kTcStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kTcStages * kTcBBytes);
  uint64_t* empty = full + kTcStages;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int n0 = blockIdx.x * kTcBN, m0 = blockIdx.y * 128 * WM;
  const int kb0 = blockIdx.z * p.kb_per_split;
  const int nk = min(p.nkb, kb0 + p.kb_per_split) - kb0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 256);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warpgroup: one thread keeps the TMA ring full ----
    tc::regs_dec<kTcProducerRegs>();
    if (t == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kTcStages, k0 = (kb0 + it) * kTcBK;
        tc::mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        tc::mbar_arrive_expect_tx(&full[s], kABytes + kTcBBytes);
        tc::tma_load_2d(As + s * kABytes, &map_a, &full[s], k0, m0);
        tc::tma_load_2d(Bs + s * kTcBBytes, &map_b, &full[s], n0, k0);
        tc::tma_load_2d(Bs + s * kTcBBytes + kTcBChunk, &map_b, &full[s],
                        n0 + 64, k0);
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows (wg - 1) * 64 * WM .. + 64 * WM ----
  tc::regs_inc<kTcConsumerRegs>();
  const int cw = wg - 1;
  float acc[WM][64];
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mi][i] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int s = it % kTcStages;
    tc::mbar_wait(&full[s], (it / kTcStages) & 1);
    const uint32_t a_base = tc::smem_u32(As + s * kABytes);
    const uint32_t b_base = tc::smem_u32(Bs + s * kTcBBytes);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint64_t db = tc::desc_sw128(b_base + kk * 2048, kTcBChunk, 1024);
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        const uint64_t da = tc::desc_sw128(
            a_base + (cw * WM + mi) * 64 * 128 + kk * 32, 16, 1024);
        tc::wgmma_ss<TT, 128, 1>(acc[mi], da, db, 1);
      }
    }
    tc::wgmma_commit();
    // the previous stage's wgmmas are done once at most one group is left
    tc::wgmma_wait<1>();
#pragma unroll
    for (int mi = 0; mi < WM; ++mi) tc::fence_regs(acc[mi]);
    if (it > 0) tc::mbar_arrive(&empty[(it - 1) % kTcStages]);
  }
  tc::wgmma_wait<0>();
#pragma unroll
  for (int mi = 0; mi < WM; ++mi) tc::fence_regs(acc[mi]);

  store_tile<WM>(p, acc, m0, n0, cw, t);
}

// Second pass of a split K: out = cast(sum over splits, in split order).
__global__ void tp_matmul_reduce_kernel(const float* __restrict__ ws,
                                        void* out, long long n, int splits,
                                        int out_dtype) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[(long long)z * n + i];
    store_pair(out, out_dtype, i, s, 0.f, false);
  }
}

int grid_blocks(long long work, int per_block) {
  const long long b = (work + per_block - 1) / per_block;
  return b < 4096 ? (int)b : 4096;
}

template <typename T, typename TT>
cudaError_t stage_typed(const void* src, void* dst, int rows, int cols,
                        Snap snap, cudaStream_t stream) {
  const int ld = (cols + 7) / 8 * 8;
  const long long groups = (long long)rows * (ld / 8);
  if (groups == 0) return cudaSuccess;
  stage_kernel<T, TT><<<grid_blocks(groups, 256), 256, 0, stream>>>(
      static_cast<const T*>(src), static_cast<uint4*>(dst), rows, cols, ld,
      snap);
  return cudaGetLastError();
}

template <typename TT>
cudaError_t stage(const void* src, void* dst, int rows, int cols,
                  int in_dtype, Snap snap, cudaStream_t stream) {
  switch (in_dtype) {
    case DT_F32: return stage_typed<float, TT>(src, dst, rows, cols, snap, stream);
    case DT_BF16:
      return stage_typed<__nv_bfloat16, TT>(src, dst, rows, cols, snap, stream);
    case DT_F16: return stage_typed<__half, TT>(src, dst, rows, cols, snap, stream);
    case DT_FP8E5M2:
      return stage_typed<__nv_fp8_e5m2, TT>(src, dst, rows, cols, snap, stream);
  }
  return cudaErrorInvalidValue;
}

// a16 / b16: staged copies [M, K8] / [K, N8] (rows padded to 8 elements),
// or null when the operands go to TMA as they are.
template <typename TT, int WM>
cudaError_t launch_tc(const void* a, const void* b, void* a16, void* b16,
                      int in_dtype, Snap snap, const TcParams& p, int m_tiles,
                      int n_tiles, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<TT, __nv_bfloat16>::value;
  const bool staged = a16 != nullptr;
  cudaError_t err;
  if (staged) {
    err = stage<TT>(a, a16, p.M, p.K, in_dtype, snap, stream);
    if (err == cudaSuccess)
      err = stage<TT>(b, b16, p.K, p.N, in_dtype, snap, stream);
    if (err != cudaSuccess) return err;
  }
  const uint64_t lda = staged ? (p.K + 7) / 8 * 8 : p.K;
  const uint64_t ldb = staged ? (p.N + 7) / 8 * 8 : p.N;
  const uint64_t da[2] = {lda, (uint64_t)p.M}, db[2] = {ldb, (uint64_t)p.K};
  const uint32_t ba[2] = {64u, 128u * WM}, bb[2] = {64u, 64u};
  CUtensorMap ma, mb;
  if (!tc_host::make_map(&ma, staged ? a16 : a, kBf16, 2, da, ba) ||
      !tc_host::make_map(&mb, staged ? b16 : b, kBf16, 2, db, bb))
    return cudaErrorInvalidValue;
  auto kern = tp_matmul_tc_kernel<TT, WM>;
  constexpr int smem = (int)tc_smem_bytes<WM>();
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  // setmaxnreg only moves registers inside the CTA's allocation: refuse a
  // build whose allocation cannot serve what the consumers ask for
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kTcThreads < 128 * (kTcProducerRegs + 2 * kTcConsumerRegs))
    return cudaErrorInvalidConfiguration;
  kern<<<dim3(n_tiles, m_tiles, p.splits), kTcThreads, smem, stream>>>(ma, mb,
                                                                       p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long n = (long long)p.M * p.N;
  tp_matmul_reduce_kernel<<<grid_blocks(n, 256), 256, 0, stream>>>(
      p.ws, p.out, n, p.splits, p.out_dtype);
  return cudaGetLastError();
}

}  // namespace

// tile_bf16: 1 -> bf16 tiles, 0 -> fp16 tiles; a16 / b16: staging buffers
// ([M, K8] and [K, N8] of the tile type) when the operands are not 16-bit
// tile-type values with 16-byte aligned rows or need a snap, else null;
// wm: 1 (BM 128) or 2 (BM 256); splits / kb_per_split: the K split planned
// on the host (``plan_tc``), ws its [splits, M, N] f32 workspace.
extern "C" int tp_matmul_tc_launch(const void* a, const void* b, void* out,
                                   void* ws, void* a16, void* b16, int m,
                                   int k, int n, int in_dtype, int out_dtype,
                                   int tile_bf16, int q_m, int q_emax,
                                   int q_emin, int wm, int splits,
                                   int kb_per_split, void* stream) {
  if (m < 0 || k < 1 || n < 0 || q_m < 0 || q_m > 22 || (wm != 1 && wm != 2) ||
      splits < 1 || kb_per_split < 1 || (!a16) != (!b16))
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  TcParams p;
  p.out = out; p.ws = static_cast<float*>(ws);
  p.M = m; p.K = k; p.N = n;
  p.out_dtype = out_dtype;
  p.nkb = (k + kTcBK - 1) / kTcBK;
  p.kb_per_split = kb_per_split;
  p.splits = splits;
  if ((long long)(splits - 1) * kb_per_split >= p.nkb ||
      (long long)splits * kb_per_split < p.nkb || (splits > 1 && !ws))
    return cudaErrorInvalidValue;
  // operands read by TMA as they are must already be the tile's values
  const int native = tile_bf16 ? DT_BF16 : DT_F16;
  if (!a16 && (in_dtype != native || q_m != 0 || k % 8 || n % 8 ||
               (reinterpret_cast<uintptr_t>(a) & 15) ||
               (reinterpret_cast<uintptr_t>(b) & 15)))
    return cudaErrorInvalidValue;
  const Snap snap{q_m, q_emax, q_emin};
  const int m_tiles = (m + 128 * wm - 1) / (128 * wm);
  const int n_tiles = (n + kTcBN - 1) / kTcBN;
  if (m_tiles > 65535 || splits > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_bf16)
    return wm == 1 ? launch_tc<__nv_bfloat16, 1>(a, b, a16, b16, in_dtype, snap,
                                                 p, m_tiles, n_tiles, s)
                   : launch_tc<__nv_bfloat16, 2>(a, b, a16, b16, in_dtype, snap,
                                                 p, m_tiles, n_tiles, s);
  return wm == 1 ? launch_tc<__half, 1>(a, b, a16, b16, in_dtype, snap, p,
                                        m_tiles, n_tiles, s)
                 : launch_tc<__half, 2>(a, b, a16, b16, in_dtype, snap, p,
                                        m_tiles, n_tiles, s);
}

// ===========================================================================
// tp_matmul_split: f32 products on the tensor cores as sums of bf16 piece
// products (the split route), on tp_matmul_tc's staging pass, TMA ring,
// split K and in-order second pass
// ===========================================================================
namespace {

using namespace repro;

// One A piece: 128 rows of 64 values; one B piece: two 64-column chunks.
constexpr uint32_t kSpAPiece = 128 * 128, kSpBPiece = kTcBBytes;

template <int P>
__host__ __device__ constexpr int sp_stages() {
  return P == 3 ? 2 : 3;  // 96 KB or 64 KB a stage
}
template <int P>
__host__ __device__ constexpr uint32_t sp_smem_bytes() {
  return sp_stages<P>() * P * (kSpAPiece + kSpBPiece) + 2 * sp_stages<P>() * 8 +
         1024;
}

// The split route's staging pass: src [rows, cols] widened (and snapped
// onto the grid when one is given), each value cut into P bf16 pieces
// (``tc::split_bf16``), piece i written to dst [i][rows][ld] (ld = cols
// rounded up to 8, the padding zero).  The pieces are formed here, once,
// and never per MMA.
template <typename T, int P>
__global__ void stage_split_kernel(const T* __restrict__ src,
                                   uint4* __restrict__ dst, int rows,
                                   int cols, int ld, Snap snap) {
  const long long per_row = ld / 8, total = (long long)rows * per_row;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < total; g += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(g / per_row), c = (int)(g % per_row) * 8;
    float v[8], pc[8][P];
    load8(src + (long long)r * cols, c, cols, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (snap.m > 0) v[e] = quantize_rne_bits(v[e], snap.m, snap.emax, snap.emin);
      tc::split_bf16<P>(v[e], pc[e]);
    }
#pragma unroll
    for (int i = 0; i < P; ++i)
      dst[i * total + g] = make_uint4(
          tc::pack2<__nv_bfloat16>(pc[0][i], pc[1][i]),
          tc::pack2<__nv_bfloat16>(pc[2][i], pc[3][i]),
          tc::pack2<__nv_bfloat16>(pc[4][i], pc[5][i]),
          tc::pack2<__nv_bfloat16>(pc[6][i], pc[7][i]));
  }
}

// One output of a split's K range [k0, k1) as the f32 dot of the values
// the staged pieces hold (``tc::piece_sum``): the repair of a NaN sum,
// which a non-finite operand makes when it meets its partner's zero piece
// (IEEE's product gives +-Inf there), and which NaN operands, Inf x 0 and
// Inf - Inf make again.  Run only on a NaN sum.  (Inlined, at one call
// site: a call would make ptxas serialize the kernel's wgmmas.)
template <int P>
__device__ __forceinline__ float split_dot_repair(
    const __nv_bfloat16* __restrict__ a16,
    const __nv_bfloat16* __restrict__ b16, int M, int K, int lda, int ldb,
    int row, int col, int k0, int k1) {
  const long long sa = (long long)M * lda, sb = (long long)K * ldb;
  float s = 0.f;
  for (int k = k0; k < k1; ++k)
    s = fmaf(tc::piece_sum<P>(a16 + (long long)row * lda + k, sa),
             tc::piece_sum<P>(b16 + (long long)k * ldb + col, sb), s);
  return s;
}

// A CTA of three warpgroups owns a 128 x 128 output tile (blockIdx.x the
// row tile, so the CTAs that share a weight tile run side by side and the
// second reads it from L2); warpgroup 0's first thread loads the P pieces
// of A and of B for each 64-deep K step by TMA (3-D maps, the piece the
// third coordinate), warpgroups 1 and 2 each run, for their 64 rows, the
// kept piece pairs (``tc::for_each_pair``) as m64n128k16 wgmmas into one
// f32 accumulator; a NaN sum is repaired from a16 / b16, the staged
// pieces ([P][rows][ld]), before the store.
template <int P>
__global__ void __launch_bounds__(kTcThreads, 1)
    tp_matmul_split_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           TcParams p, const __nv_bfloat16* a16,
                           const __nv_bfloat16* b16) {
  constexpr int kStages = sp_stages<P>();
  constexpr uint32_t kABytes = P * kSpAPiece, kBBytes = P * kSpBPiece;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* As = smem;
  uint8_t* Bs = smem + kStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kStages * kBBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * kTcBN;
  const int kb0 = blockIdx.z * p.kb_per_split;
  const int nk = min(p.nkb, kb0 + p.kb_per_split) - kb0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 256);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    tc::regs_dec<kTcProducerRegs>();
    if (t == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages, k0 = (kb0 + it) * kTcBK;
        tc::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        tc::mbar_arrive_expect_tx(&full[s], kABytes + kBBytes);
#pragma unroll
        for (int i = 0; i < P; ++i) {
          uint8_t* a = As + s * kABytes + i * kSpAPiece;
          uint8_t* b = Bs + s * kBBytes + i * kSpBPiece;
          tc::tma_load_3d(a, &map_a, &full[s], k0, m0, i);
          tc::tma_load_3d(b, &map_b, &full[s], n0, k0, i);
          tc::tma_load_3d(b + kTcBChunk, &map_b, &full[s], n0 + 64, k0, i);
        }
      }
    }
    return;
  }

  tc::regs_inc<kTcConsumerRegs>();
  const int cw = wg - 1;
  float acc[1][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    tc::mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t a_base = tc::smem_u32(As + s * kABytes) + cw * 64 * 128;
    const uint32_t b_base = tc::smem_u32(Bs + s * kBBytes);
    tc::wgmma_fence();
    tc::for_each_pair<P, P>([&](int i, int j, bool) {
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        const uint64_t da =
            tc::desc_sw128(a_base + i * kSpAPiece + kk * 32, 16, 1024);
        const uint64_t db = tc::desc_sw128(
            b_base + j * kSpBPiece + kk * 2048, kTcBChunk, 1024);
        tc::wgmma_ss<__nv_bfloat16, 128, 1>(acc[0], da, db, 1);
      }
    });
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
    tc::fence_regs(acc[0]);
    if (it > 0) tc::mbar_arrive(&empty[(it - 1) % kStages]);
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc[0]);
  uint64_t nan_acc = 0;
#pragma unroll
  for (int e = 0; e < 64; ++e)
    nan_acc |= (acc[0][e] != acc[0][e]) ? 1ull << e : 0ull;
  store_tile<1>(p, acc, m0, n0, cw, t);
  // NaN sums: the stored NaN overwritten by the repair (one copy of it)
  const int warp = t / 32, lane = t % 32;
  const int lda = (p.K + 7) / 8 * 8, ldb = (p.N + 7) / 8 * 8;
  while (nan_acc) {
    const int e = __ffsll((long long)nan_acc) - 1;
    nan_acc &= nan_acc - 1;
    const int row = m0 + cw * 64 + 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
    const int col = n0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
    if (row >= p.M || col >= p.N) continue;
    const float r = split_dot_repair<P>(a16, b16, p.M, p.K, lda, ldb, row,
                                        col, kb0 * kTcBK,
                                        min(p.K, (kb0 + nk) * kTcBK));
    const bool split = p.splits > 1;
    store_pair(split ? static_cast<void*>(p.ws + (long long)blockIdx.z * p.M * p.N)
                     : p.out,
               split ? DT_F32 : p.out_dtype, (long long)row * p.N + col, r,
               0.f, false);
  }
}

template <typename T, int P>
cudaError_t stage_split_typed(const void* src, void* dst, int rows, int cols,
                              Snap snap, cudaStream_t stream) {
  const int ld = (cols + 7) / 8 * 8;
  const long long groups = (long long)rows * (ld / 8);
  if (groups == 0) return cudaSuccess;
  stage_split_kernel<T, P><<<grid_blocks(groups, 256), 256, 0, stream>>>(
      static_cast<const T*>(src), static_cast<uint4*>(dst), rows, cols, ld,
      snap);
  return cudaGetLastError();
}

template <int P>
cudaError_t stage_split(const void* src, void* dst, int rows, int cols,
                        int in_dtype, Snap snap, cudaStream_t stream) {
  switch (in_dtype) {
    case DT_F32: return stage_split_typed<float, P>(src, dst, rows, cols, snap, stream);
    case DT_BF16:
      return stage_split_typed<__nv_bfloat16, P>(src, dst, rows, cols, snap, stream);
    case DT_F16: return stage_split_typed<__half, P>(src, dst, rows, cols, snap, stream);
    case DT_FP8E5M2:
      return stage_split_typed<__nv_fp8_e5m2, P>(src, dst, rows, cols, snap, stream);
  }
  return cudaErrorInvalidValue;
}

template <int P>
cudaError_t launch_split(const void* a, const void* b, void* a16, void* b16,
                         int in_dtype, Snap snap, const TcParams& p,
                         int m_tiles, int n_tiles, cudaStream_t stream) {
  cudaError_t err = stage_split<P>(a, a16, p.M, p.K, in_dtype, snap, stream);
  if (err == cudaSuccess)
    err = stage_split<P>(b, b16, p.K, p.N, in_dtype, snap, stream);
  if (err != cudaSuccess) return err;
  const uint64_t lda = (p.K + 7) / 8 * 8, ldb = (p.N + 7) / 8 * 8;
  const uint64_t da[3] = {lda, (uint64_t)p.M, (uint64_t)P},
                 db[3] = {ldb, (uint64_t)p.K, (uint64_t)P};
  const uint32_t ba[3] = {64u, 128u, 1u}, bb[3] = {64u, 64u, 1u};
  CUtensorMap ma, mb;
  if (!tc_host::make_map(&ma, a16, true, 3, da, ba) ||
      !tc_host::make_map(&mb, b16, true, 3, db, bb))
    return cudaErrorInvalidValue;
  auto kern = tp_matmul_split_kernel<P>;
  constexpr int smem = (int)sp_smem_bytes<P>();
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kTcThreads < 128 * (kTcProducerRegs + 2 * kTcConsumerRegs))
    return cudaErrorInvalidConfiguration;
  kern<<<dim3(m_tiles, n_tiles, p.splits), kTcThreads, smem, stream>>>(
      ma, mb, p, static_cast<const __nv_bfloat16*>(a16),
      static_cast<const __nv_bfloat16*>(b16));
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long n = (long long)p.M * p.N;
  tp_matmul_reduce_kernel<<<grid_blocks(n, 256), 256, 0, stream>>>(
      p.ws, p.out, n, p.splits, p.out_dtype);
  return cudaGetLastError();
}

}  // namespace

// pieces: 2 (operands of <= 17 significant bits: the tf32 grid) or 3 (f32
// without a grid); a16 / b16: the staging buffers of the pieces, [pieces,
// M, K8] and [pieces, K, N8] bf16; splits / kb_per_split: the K split
// planned on the host (``plan_split``: 128-row tiles), ws its [splits, M,
// N] f32 workspace.
extern "C" int tp_matmul_split_launch(const void* a, const void* b, void* out,
                                      void* ws, void* a16, void* b16, int m,
                                      int k, int n, int in_dtype,
                                      int out_dtype, int pieces, int q_m,
                                      int q_emax, int q_emin, int splits,
                                      int kb_per_split, void* stream) {
  if (m < 0 || k < 1 || n < 0 || q_m < 0 || q_m > 22 ||
      (pieces != 2 && pieces != 3) || splits < 1 || kb_per_split < 1 ||
      !a16 || !b16)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  TcParams p;
  p.out = out; p.ws = static_cast<float*>(ws);
  p.M = m; p.K = k; p.N = n;
  p.out_dtype = out_dtype;
  p.nkb = (k + kTcBK - 1) / kTcBK;
  p.kb_per_split = kb_per_split;
  p.splits = splits;
  if ((long long)(splits - 1) * kb_per_split >= p.nkb ||
      (long long)splits * kb_per_split < p.nkb || (splits > 1 && !ws))
    return cudaErrorInvalidValue;
  const Snap snap{q_m, q_emax, q_emin};
  const int m_tiles = (m + 127) / 128, n_tiles = (n + kTcBN - 1) / kTcBN;
  if (n_tiles > 65535 || splits > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pieces == 3
             ? launch_split<3>(a, b, a16, b16, in_dtype, snap, p, m_tiles,
                               n_tiles, s)
             : launch_split<2>(a, b, a16, b16, in_dtype, snap, p, m_tiles,
                               n_tiles, s);
}
