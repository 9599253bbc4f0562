// Single-query GQA decode attention over a paged (or contiguous) KV cache,
// for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// ``decode_attention_pallas`` (body ``_decode_kernel``).
//
// Contract (same as the TPU kernel): q [BHkv, G, D] against the row's keys
// j < kv_len[row] (and j > kv_len - 1 - window); scores are src-dtype
// products summed in f32, scaled, exp-form soft-capped; an EXACT max first,
// then exp(s - max) and p.V summed in f32 tile by tile, with p rounded to
// the src dtype before the product; rows with kv_len == 0 store zeros.
// K/V are widened in-kernel from their storage dtype (bf16 / fp16 / fp8 e5m2
// exactly, or an f32 container RNE-snapped onto the kv format's grid).
//
// What bounds it: bytes.  One decode step reads each live K and V element
// once and does 4 flops per element pair (G = 2), far below the card's
// ~295 flops/byte ridge.  Design: one CTA per (batch, kv-head) row walks the
// row's own pages through the block table and stops at kv_len, so work and
// traffic follow each row's live length.  Keys move in tiles of kTile: the
// tile's page offsets are looked up once, then all 256 threads copy the
// tile into shared memory together with 16-byte loads, eight in flight per
// thread (``load_rows``): with one CTA per SM, bytes in flight are what
// set the rate — 2-byte loads a key at a time left it latency-bound.  The
// TPU streams K twice to get the exact max; here the first pass stores the
// G scores of each key (8 bytes per key instead of 2 * D) in a global
// scratch strip and the second pass reads them back with V, so K and V
// each cross HBM once.  Known limit: with slots x 8 CTAs (32 at 4 slots)
// the grid cannot fill 132 SMs, and the longest row sets the time — a
// split-KV variant is the next step.
#include <cuda_runtime.h>

#include "quant_common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kTile = 64;  // keys per shared-memory tile (<= kThreads)
constexpr float kNegInf = -1e30f;

struct DecodeParams {
  const int* kv_len;       // [BH]
  const int* block_table;  // [BH, nk] flat page ids, or null (contiguous)
  float* out;              // [BH, G, D]
  float* scores;           // [BH, G, smax] scratch
  int g, d, nk, page, pool_rows, smax;
  int src_kind;
  Snap kv_snap, q_snap;
  float scale;
  int window;              // < 0: none
  float softcap;           // <= 0: none
  float two_over_cap;
};

// Element offset of key j of this row in the (flat) pool.
__device__ __forceinline__ long long key_offset(const DecodeParams& p,
                                                int row, int j) {
  const int blk = j / p.page;
  const long long phys = p.block_table
                             ? (long long)p.block_table[(long long)row * p.nk + blk]
                             : (long long)row * p.nk + blk;
  if (phys < 0 || phys >= p.pool_rows) __trap();  // page id outside the pool
  return (phys * p.page + (j % p.page)) * (long long)p.d;
}

// Copy keys [t0, t0 + n) of this row from ``pool`` into ``tile`` [n][D],
// widened to f32.  Ends with a barrier; the caller barriers before reuse.
template <typename KT>
__device__ __forceinline__ void load_tile(float* tile, long long* koff,
                                          const KT* __restrict__ pool,
                                          const DecodeParams& p, int row,
                                          int t0, int n) {
  if ((int)threadIdx.x < n) koff[threadIdx.x] = key_offset(p, row, t0 + threadIdx.x);
  __syncthreads();
  load_rows<kThreads>(tile, p.d, pool, koff, n, p.d, p.kv_snap, p.src_kind);
  __syncthreads();
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
              const KT* __restrict__ v, DecodeParams p) {
  extern __shared__ float smem[];
  long long* koff = reinterpret_cast<long long*>(smem);  // [kTile]
  float* qs = smem + 2 * kTile;           // [G][D]
  float* tile = qs + p.g * p.d;           // [kTile][D] widened K, then V
  float* pr = tile + kTile * p.d;         // [G][kTile] p, src-rounded
  float* pf = pr + p.g * kTile;           // [G][kTile] p, f32
  float* wmax = pf + p.g * kTile;         // [kWarps][kMaxG]
  float* mrow = wmax + kWarps * kMaxG;    // [kMaxG]
  float* lrow = mrow + kMaxG;             // [kMaxG]

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.g, D = p.d;
  const int kvl = min(p.kv_len[row], p.nk * p.page);
  const int lo = p.window >= 0 ? max(0, kvl - p.window) : 0;
  float* srow = p.scores + (long long)row * G * p.smax;

  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = widen(q[(long long)row * G * D + i], p.q_snap, p.src_kind);
  __syncthreads();

  // pass 1: every live key's G scores (stored) and the exact row max;
  // warp w scores keys w, w + kWarps, ... of each tile
  float lmax[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) lmax[g] = kNegInf;
  for (int t0 = lo; t0 < kvl; t0 += kTile) {
    const int n = min(kTile, kvl - t0);
    load_tile(tile, koff, k, p, row, t0, n);
    for (int jj = warp; jj < n; jj += kWarps) {
      float acc[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
      for (int dd = lane; dd < D; dd += 32) {
        const float kv = tile[jj * D + dd];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] += qs[g * D + dd] * kv;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float a = acc[g];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            a += __shfl_xor_sync(0xffffffffu, a, off);
          float s = a * p.scale;
          if (p.softcap > 0.f) {
            const float e = expf(s * p.two_over_cap);
            s = p.softcap * (1.f - 2.f / (e + 1.f));
          }
          if (lane == 0) srow[(long long)g * p.smax + t0 + jj] = s;
          lmax[g] = fmaxf(lmax[g], s);
        }
      }
    }
    __syncthreads();
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) wmax[warp * kMaxG + g] = lmax[g];
  }
  __syncthreads();
  if (tid < G) {
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wmax[w * kMaxG + tid]);
    mrow[tid] = (m <= kNegInf / 2) ? 0.f : m;
    lrow[tid] = 0.f;
  }
  __syncthreads();

  // pass 2: tilewise exp sums and p.V; thread tid owns output column tid
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  for (int t0 = lo; t0 < kvl; t0 += kTile) {
    const int n = min(kTile, kvl - t0);
    load_tile(tile, koff, v, p, row, t0, n);
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, jj = i % kTile;
      float e = 0.f;
      if (jj < n) e = expf(srow[(long long)g * p.smax + t0 + jj] - mrow[g]);
      pf[i] = e;
      pr[i] = round_src(e, p.src_kind);
    }
    __syncthreads();
    if (tid < G) {
      float s = 0.f;
      for (int jj = 0; jj < n; ++jj) s += pf[tid * kTile + jj];
      lrow[tid] += s;
    }
    if (tid < D) {
      for (int jj = 0; jj < n; ++jj) {
        const float vv = tile[jj * D + tid];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] += pr[g * kTile + jj] * vv;
      }
    }
    __syncthreads();
  }
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float l = lrow[g];
        p.out[((long long)row * G + g) * D + tid] = acc[g] / (l == 0.f ? 1.f : l);
      }
    }
  }
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v, int bh,
                         const DecodeParams& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kTile + p.g * p.d + kTile * p.d + 2 * p.g * kTile +
                       kWarps * kMaxG + 2 * kMaxG);
  auto kern = decode_kernel<QT, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, smem, stream>>>(static_cast<const QT*>(q),
                                       static_cast<const KT*>(k),
                                       static_cast<const KT*>(v), p);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(const void* q, const void* k, const void* v, int bh,
                      int kv_dtype, const DecodeParams& p,
                      cudaStream_t stream) {
  switch (kv_dtype) {
    case DT_F32: return launch_typed<QT, float>(q, k, v, bh, p, stream);
    case DT_BF16: return launch_typed<QT, __nv_bfloat16>(q, k, v, bh, p, stream);
    case DT_F16: return launch_typed<QT, __half>(q, k, v, bh, p, stream);
    case DT_FP8E5M2: return launch_typed<QT, __nv_fp8_e5m2>(q, k, v, bh, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* block_table, void* out, void* scores, int bh, int g, int d,
    int nk, int page, int pool_rows, int smax, int q_dtype, int kv_dtype,
    int src_kind,
    int kv_m, int kv_emax, int kv_emin, int q_m, int q_emax, int q_emin,
    float scale, int window, float softcap, void* stream) {
  if (g < 1 || g > kMaxG || d < 1 || d > kThreads) return cudaErrorInvalidValue;
  DecodeParams p;
  p.kv_len = static_cast<const int*>(kv_len);
  p.block_table = static_cast<const int*>(block_table);
  p.out = static_cast<float*>(out);
  p.scores = static_cast<float*>(scores);
  p.g = g; p.d = d; p.nk = nk; p.page = page; p.pool_rows = pool_rows;
  p.smax = smax;
  p.src_kind = src_kind;
  p.kv_snap = Snap{kv_m, kv_emax, kv_emin};
  p.q_snap = Snap{q_m, q_emax, q_emin};
  p.scale = scale;
  p.window = window;
  p.softcap = softcap;
  p.two_over_cap = softcap > 0.f ? 2.f / softcap : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case DT_F32: return launch_kv<float>(q, k, v, bh, kv_dtype, p, s);
    case DT_BF16: return launch_kv<__nv_bfloat16>(q, k, v, bh, kv_dtype, p, s);
    case DT_F16: return launch_kv<__half>(q, k, v, bh, kv_dtype, p, s);
  }
  return cudaErrorInvalidValue;
}
