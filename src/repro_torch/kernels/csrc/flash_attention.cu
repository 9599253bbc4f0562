// Online-softmax prefill attention over a paged (or contiguous) KV cache,
// for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// ``flash_attention_pallas`` (body ``_attn_kernel``, schedule
// ``block_schedule``).
//
// Contract (same as the TPU kernel): q [BH, Sq, D] at positions
// q_offset + i attends keys of KV row bh / group that are < kv_len[bh],
// causal (key <= query) and inside the window (query - key < window);
// scores are src-dtype products summed in f32, scaled and exp-form
// soft-capped; the online softmax keeps the running max, denominator and
// output in f32 with the NEG_INF/2 guards of the TPU kernel, and p is
// widened to the src dtype before p.V; fully masked rows store zeros.
// Operands are widened in-kernel from their storage dtype (bf16 / fp16 /
// fp8 e5m2 exactly, or f32 RNE-snapped onto src_fmt's grid).
//
// What bounds it: at the serving path's shapes, operations in the
// multiplies and the softmax between them, and the card's least time is far
// below what a CTA's serial walk over its key tiles takes; the bytes of K/V
// are read once per group of heads.  Two variants, chosen on the host by
// ``tc_tile_dtype`` (kernels/flash_attention.py) alone:
//
// ``flash_tc`` (tensor cores; src bf16 / fp16, or f32 on a grid exact in a
// 16-bit type; D in {64, 128, 256}).  One CTA per (KV row, query tile)
// carries the tile's queries of every head of the GQA group (rows = heads x
// queries, 64 or 128 of them, one consumer warpgroup per 64), so each K/V
// tile is read once per group.  A producer warpgroup fills two rings of
// 64-key K and V tiles (128-byte swizzle): by TMA, one 3-D load per page
// segment and 64-column chunk, its warp reading the block table itself, or,
// for fp8 pools, f32 containers and a src other than the storage type,
// by loading, widening / snapping (``widen``) and writing the tiles itself.
// The consumers run S = Q K^T as an SS wgmma from the swizzled Q tile (loaded
// once), the online softmax in the accumulator layout (row max and sum by
// quad shuffles), and O += P V as an RS wgmma with P in registers; S of tile
// j and P V of tile j - 1 are issued together.  Key tiles start at multiples
// of 64 (``floor(k_start / 64) * 64``), so the plain version walks the same
// blocks and rounds p against the same running max.
//
// ``flash_fma`` (the first version, kept for policy fp32, wider grids and
// other D <= 256): one CTA per (head row, 32-query tile); K/V tiles of 32
// keys (also starting at multiples of 32) are read through the block table
// into shared memory as f32 with 16-byte loads (``load_rows``), and all
// products are f32 FMAs.
#include <cuda_runtime.h>

#include <cstring>

#include "quant_common.cuh"
#include "tc_common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr float kNegInf = -1e30f;

struct FlashParams {
  const int* kv_len;       // [BH]
  const int* block_table;  // [BKV, nk] flat page ids, or null (contiguous)
  float* out;              // [BH, Sq, D]
  int group, sq, d, nk, page, pool_rows, q_offset;
  int causal, window;      // window < 0: none
  int src_kind;
  Snap snap;
  float scale, softcap, two_over_cap;
};

// Element offset of key j of KV row ``kvrow`` in the (flat) pool.
__device__ __forceinline__ long long key_offset(const FlashParams& p,
                                                int kvrow, int j) {
  const int blk = j / p.page;
  const long long phys =
      p.block_table ? (long long)p.block_table[(long long)kvrow * p.nk + blk]
                    : (long long)kvrow * p.nk + blk;
  if (phys < 0 || phys >= p.pool_rows) __trap();  // page id outside the pool
  return (phys * p.page + (j % p.page)) * (long long)p.d;
}

// Zero rows [n, rows) of a [rows][ld] shared tile (the ragged edge).
__device__ __forceinline__ void zero_rows(float* t, int ld, int n, int rows) {
  for (int i = threadIdx.x; i < (rows - n) * ld; i += kThreads)
    t[n * ld + i] = 0.f;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
             const KT* __restrict__ v, FlashParams p) {
  extern __shared__ float smem[];
  const int D = p.d, DP = p.d + 1;
  long long* roff = reinterpret_cast<long long*>(smem);  // [kBK] row offsets
  float* Qs = smem + 2 * kBK;       // [kBQ][D+1]
  float* Ks = Qs + kBQ * DP;        // [kBK][D+1]
  float* Vs = Ks + kBK * DP;        // [kBK][D]
  float* S = Vs + kBK * D;          // [kBQ][kBK+1] scores, then src-rounded p
  float* m_s = S + kBQ * (kBK + 1);  // [kBQ] running max
  float* l_s = m_s + kBQ;           // [kBQ] running denominator
  float* a_s = l_s + kBQ;           // [kBQ] this tile's rescale factor

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int kvrow = bh / p.group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nrows = min(kBQ, p.sq - q0);
  const int kvl = min(p.kv_len[bh], p.nk * p.page);
  const int qlo = p.q_offset + q0;  // position of the tile's first query

  // this tile's key range: the pruning block_schedule does on the host
  int k_end = kvl;
  if (p.causal) k_end = min(k_end, qlo + nrows);
  const int k_start = p.window >= 0 ? max(0, qlo - p.window + 1) : 0;

  if (tid < nrows) roff[tid] = ((long long)bh * p.sq + q0 + tid) * D;
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  load_rows<kThreads>(Qs, DP, q, roff, nrows, D, p.snap, p.src_kind);
  zero_rows(Qs, DP, nrows, kBQ);
  __syncthreads();
  float acc[kBQ];
#pragma unroll
  for (int r = 0; r < kBQ; ++r) acc[r] = 0.f;
  const int ty = tid / 16, tx = tid % 16;

  // key tiles start at multiples of kBK, so the plain version can walk the
  // same blocks (keys left of the window are masked)
  for (int k0 = k_start / kBK * kBK; k0 < k_end; k0 += kBK) {
    const int n = min(kBK, k_end - k0);
    if (tid < n) roff[tid] = key_offset(p, kvrow, k0 + tid);
    __syncthreads();
    load_rows<kThreads>(Ks, DP, k, roff, n, D, p.snap, p.src_kind);
    load_rows<kThreads>(Vs, D, v, roff, n, D, p.snap, p.src_kind);
    zero_rows(Ks, DP, n, kBK);
    zero_rows(Vs, D, n, kBK);
    __syncthreads();

    // S = Q K^T for rows {ty, ty+16} x keys {tx, tx+16}
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float qa = Qs[ty * DP + dd], qb = Qs[(ty + 16) * DP + dd];
      const float ka = Ks[tx * DP + dd], kb = Ks[(tx + 16) * DP + dd];
      s00 += qa * ka; s01 += qa * kb; s10 += qb * ka; s11 += qb * kb;
    }
    const float sv[4] = {s00, s01, s10, s11};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = ty + (c >> 1) * 16, j = tx + (c & 1) * 16;
      const int qpos = qlo + r, key = k0 + j;
      float s = sv[c] * p.scale;
      if (p.softcap > 0.f) {
        const float e = expf(s * p.two_over_cap);
        s = p.softcap * (1.f - 2.f / (e + 1.f));
      }
      bool live = j < n && key < kvl;
      if (p.causal) live = live && qpos >= key;
      if (p.window >= 0) live = live && (qpos - key) < p.window;
      S[r * (kBK + 1) + j] = live ? s : kNegInf;
    }
    __syncthreads();

    // online-softmax update: warp w owns rows 4w..4w+3, lane = key
    for (int r = warp * 4; r < warp * 4 + 4; ++r) {
      const float s = S[r * (kBK + 1) + lane];
      float mc = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mc);
      const bool dead = m_new <= kNegInf / 2;
      const float e = s <= kNegInf / 2 ? 0.f : expf(s - (dead ? 0.f : m_new));
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      S[r * (kBK + 1) + lane] = widen(e, p.snap, p.src_kind);
      if (lane == 0) {
        const float alpha = expf(dead ? 0.f : m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V; thread tid owns output column tid
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < kBQ; ++r) acc[r] *= a_s[r];
      for (int j = 0; j < n; ++j) {
        const float vv = Vs[j * D + tid];
#pragma unroll
        for (int r = 0; r < kBQ; ++r) acc[r] += S[r * (kBK + 1) + j] * vv;
      }
    }
    __syncthreads();
  }
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < kBQ; ++r) {
      if (r < nrows) {
        const float l = l_s[r];
        p.out[((long)bh * p.sq + q0 + r) * D + tid] =
            acc[r] / (l == 0.f ? 1.f : l);
      }
    }
  }
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v, int bh,
                         const FlashParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBK + kBQ * (p.d + 1) +
                                       kBK * (p.d + 1) + kBK * p.d +
                                       kBQ * (kBK + 1) + 3 * kBQ);
  auto kern = flash_kernel<QT, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kBQ - 1) / kBQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const QT*>(q),
                                         static_cast<const KT*>(k),
                                         static_cast<const KT*>(v), p);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(const void* q, const void* k, const void* v, int bh,
                      int kv_dtype, const FlashParams& p,
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

extern "C" int flash_attention_fma_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* block_table, void* out, int bh, int group, int sq, int d,
    int nk, int page, int pool_rows, int q_offset, int causal, int window,
    int q_dtype,
    int kv_dtype, int src_kind, int snap_m, int snap_emax, int snap_emin,
    float scale, float softcap, void* stream) {
  if (d < 1 || d > kThreads || group < 1 || sq < 1) return cudaErrorInvalidValue;
  FlashParams p;
  p.kv_len = static_cast<const int*>(kv_len);
  p.block_table = static_cast<const int*>(block_table);
  p.out = static_cast<float*>(out);
  p.group = group; p.sq = sq; p.d = d; p.nk = nk; p.page = page;
  p.pool_rows = pool_rows;
  p.q_offset = q_offset; p.causal = causal; p.window = window;
  p.src_kind = src_kind;
  p.snap = Snap{snap_m, snap_emax, snap_emin};
  p.scale = scale;
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

// ===========================================================================
// flash_tc: wgmma tiles, one CTA per (KV row, query tile) for all heads of
// the group
// ===========================================================================
namespace {

using namespace repro;

constexpr int kTcBK = 64, kTcStages = 2, kTcProducerRegs = 40;
constexpr float kTcNegInf = -1e30f;

template <int NC>
__host__ __device__ constexpr int tc_consumer_regs() {
  return NC == 1 ? 240 : 232;
}

struct TcFlashParams {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;       // [BH]
  const int* block_table;  // [BKV, nk] flat page ids, or null (contiguous)
  float* out;              // [BH, Sq, D]
  int group, bq, sq, nk, page, pool_rows, q_offset;
  int causal, window;      // window < 0: none
  int q_dtype, kv_dtype, src_kind;
  Snap snap;
  float scale, softcap, two_over_cap;
  int kv_tma, seg_rows;    // K/V by TMA, rows per TMA load
};

// Eight consecutive elements at ``p`` widened (snap of f32 containers, then
// the cast to the src dtype); zeros when ``ok`` is false.
template <typename T>
__device__ __forceinline__ void widen8(const T* __restrict__ p, bool ok,
                                       const Snap& snap, int src_kind,
                                       float (&v)[8]) {
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
    return;
  }
  constexpr uintptr_t kAlign = sizeof(T) == 1 ? 7 : 15;
  if ((reinterpret_cast<uintptr_t>(p) & kAlign) == 0) {
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
    for (int i = 0; i < 8; ++i) v[i] = to_f32(p[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (sizeof(T) == 4 && snap.m > 0)
      v[i] = quantize_rne_bits(v[i], snap.m, snap.emax, snap.emin);
    v[i] = round_src(v[i], src_kind);
  }
}

// Eight widened values (exact in TT) as one 16-byte unit of a tile.
template <typename TT>
__device__ __forceinline__ void put8(uint8_t* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(tc::pack2<TT>(v[0], v[1]), tc::pack2<TT>(v[2], v[3]),
                 tc::pack2<TT>(v[4], v[5]), tc::pack2<TT>(v[6], v[7]));
}

// Flat pool row of key ``key`` of KV row ``kvrow`` (-1: past the table),
// trapping on a page id outside the pool.
__device__ __forceinline__ long long tc_phys(const TcFlashParams& p,
                                             int kvrow, int key) {
  const int blk = key / p.page;
  if (blk >= p.nk) return -1;
  const long long phys =
      p.block_table ? (long long)p.block_table[(long long)kvrow * p.nk + blk]
                    : (long long)kvrow * p.nk + blk;
  if (phys < 0 || phys >= p.pool_rows) __trap();  // page id outside the pool
  return phys;
}

// The producer warpgroup's convert step for one K or V tile: rows of keys
// kt .. kt + 63 (zeros from k_end on) widened into the swizzled tile.
template <typename KT, typename TT, int D>
__device__ __forceinline__ void convert_tile(const TcFlashParams& p,
                                             const void* src, uint8_t* dst,
                                             int kvrow, int kt, int k_end,
                                             int t) {
  const KT* x = static_cast<const KT*>(src);
  constexpr int kGroups = kTcBK * D / 8;
  constexpr int kBatch = 2;
  for (int g0 = t; g0 < kGroups; g0 += kBatch * 128) {
    float v[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int g = g0 + u * 128, r = g / (D / 8), c = (g % (D / 8)) * 8;
      const int key = kt + r;
      long long off = 0;
      bool ok = g < kGroups && key < k_end;
      if (ok) {
        const long long phys = tc_phys(p, kvrow, key);
        ok = phys >= 0;
        off = (phys * p.page + key % p.page) * D + c;
      }
      widen8(x + off, ok, p.snap, p.src_kind, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int g = g0 + u * 128, r = g / (D / 8), c = (g % (D / 8)) * 8;
      if (g < kGroups)
        put8<TT>(dst + (c >> 6) * (kTcBK * 128) + tc::sw128(r, c & 63), v[u]);
    }
  }
}

template <typename TT, int D>
__device__ __forceinline__ void convert_any(const TcFlashParams& p,
                                            const void* src, uint8_t* dst,
                                            int kvrow, int kt, int k_end,
                                            int t) {
  switch (p.kv_dtype) {
    case DT_F32: convert_tile<float, TT, D>(p, src, dst, kvrow, kt, k_end, t); break;
    case DT_BF16: convert_tile<__nv_bfloat16, TT, D>(p, src, dst, kvrow, kt, k_end, t); break;
    case DT_F16: convert_tile<__half, TT, D>(p, src, dst, kvrow, kt, k_end, t); break;
    default: convert_tile<__nv_fp8_e5m2, TT, D>(p, src, dst, kvrow, kt, k_end, t);
  }
}

// One K or V tile by TMA, issued by lane 0 of the producer warp: a load per
// page segment of seg_rows keys and 64-column chunk; a segment from k_end
// on is read at a pool row past the end (zero fill).  The lanes look up the
// segments' pages together, so the page-table reads overlap.
template <int D>
__device__ __forceinline__ void tma_tile(const TcFlashParams& p,
                                         const CUtensorMap* map, uint8_t* dst,
                                         uint64_t* bar, int kvrow, int kt,
                                         int k_end, int lane) {
  for (int seg0 = 0; seg0 < kTcBK; seg0 += 32 * p.seg_rows) {
    const int key_l = kt + seg0 + lane * p.seg_rows;
    const long long phys_l =
        (seg0 + lane * p.seg_rows < kTcBK && key_l < k_end)
            ? tc_phys(p, kvrow, key_l) : -1;
    const int nseg = min(32, (kTcBK - seg0) / p.seg_rows);
    for (int i = 0; i < nseg; ++i) {
      const long long phys = __shfl_sync(0xffffffffu, phys_l, i);
      const int seg = seg0 + i * p.seg_rows, key = kt + seg;
      const int y = phys >= 0 ? key % p.page : 0;
      const int z = phys >= 0 ? (int)phys : p.pool_rows;
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tc::tma_load_3d(dst + c * (kTcBK * 128) + seg * 128, map, bar,
                          c * 64, y, z);
      }
    }
  }
}

template <typename QT, typename TT, int D, int NC>
__device__ __forceinline__ void load_q(const TcFlashParams& p, uint8_t* qs,
                                       int kvrow, int q0, int cw, int t) {
  const QT* q = static_cast<const QT*>(p.q);
  constexpr int MT = 64 * NC;
  constexpr int kGroups = 64 * D / 8;  // this warpgroup's 64 rows
  constexpr int kBatch = 4;            // loads in flight per thread
  static_assert(kGroups % (kBatch * 128) == 0, "whole batches");
  for (int g0 = t; g0 < kGroups; g0 += kBatch * 128) {
    float x[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int g = g0 + u * 128, rr = g / (D / 8), c = (g % (D / 8)) * 8;
      const int row = cw * 64 + rr, h = row / p.bq, i = row % p.bq;
      const bool ok = h < p.group && q0 + i < p.sq;
      const long long off =
          ok ? (((long long)kvrow * p.group + h) * p.sq + q0 + i) * D + c : 0;
      widen8(q + off, ok, p.snap, p.src_kind, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int g = g0 + u * 128, rr = g / (D / 8), c = (g % (D / 8)) * 8;
      put8<TT>(qs + (c >> 6) * (MT * 128) + tc::sw128(cw * 64 + rr, c & 63),
               x[u]);
    }
  }
}

// S = Q K^T (m64 n64; K-major A = the warpgroup's Q rows, B = the K tile),
// committed as one asynchronous wgmma group.
template <typename TT, int D, int MT>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_base,
                                         uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // k16 step inside the chunk
    const uint64_t da =
        tc::desc_sw128(q_base + (kk / 4) * (MT * 128) + off, 16, 1024);
    const uint64_t db =
        tc::desc_sw128(k_base + (kk / 4) * (kTcBK * 128) + off, 16, 1024);
    tc::wgmma_ss<TT, 64, 0>(sc, da, db, kk > 0);
  }
  tc::wgmma_commit();
}

// O += P V (A = P from registers, B = the V tile, N-major), committed as
// one asynchronous wgmma group.
template <typename TT, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pr)[16],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk) {
    const uint64_t db =
        tc::desc_sw128(v_base + kk * 2048, kTcBK * 128, 1024);
    tc::wgmma_rs<TT, D, 1>(o, pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2],
                           pr[4 * kk + 3], db, 1);
  }
  tc::wgmma_commit();
}

// Scale (and softcap) of one S tile.  The uniform choices (softcap or
// not, masks or not, snap or not) are made once per tile, outside the
// unrolled loops over the 32 scores, so no loop issues predicated-off code.
template <bool kCap>
__device__ __forceinline__ void scale_scores(const TcFlashParams& p,
                                             float (&sc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = sc[i] * p.scale;
    if constexpr (kCap) {
      const float e = expf(x * p.two_over_cap);
      x = p.softcap * (1.f - 2.f / (e + 1.f));
    }
    sc[i] = x;
  }
}

// kv_len, causal and window masks of one S tile (keys kt ..).
__device__ __forceinline__ void mask_scores(const TcFlashParams& p,
                                            float (&sc)[32], int kt,
                                            int lane, const int (&qpos)[2],
                                            const int (&kvl)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    const int key = kt + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
    bool live = key < kvl[r];
    if (p.causal) live = live && qpos[r] >= key;
    if (p.window >= 0) live = live && (qpos[r] - key) < p.window;
    sc[i] = live ? sc[i] : kTcNegInf;
  }
}

// The online-softmax update of one S tile for the thread's two rows: p on
// the src grid, against the running max, packed into pr as the A fragments
// of P V; O's rescale in alpha.  Rows whose whole tile is live skip the
// masks.  Scores, the softcap and the running max stay in natural units,
// as in the plain version; only exp(x - m) goes to the SFU as
// 2^((x - m) log2 e), whose error is relative to p.  (Scores held in the
// log2 domain would carry an absolute error of their own size, ~1e-5 at
// softcapped scores near 50, into every p, and flip its src-grid rounding
// often enough to double the distance to the plain version there.)
template <typename TT>
__device__ __forceinline__ void softmax_tile(
    const TcFlashParams& p, float (&sc)[32], int kt, int lane,
    const int (&qpos)[2], const int (&kvl)[2], float (&m_run)[2],
    float (&l_run)[2], uint32_t (&pr)[16], float (&alpha)[2]) {
  constexpr float kLog2e = 1.4426950408889634f;
  if (p.softcap > 0.f) scale_scores<true>(p, sc);
  else scale_scores<false>(p, sc);
  bool whole = true;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int last = kt + kTcBK - 1;
    whole = whole && last < kvl[r] && (!p.causal || last <= qpos[r]) &&
            (p.window < 0 || qpos[r] - kt < p.window);
  }
  if (!whole) mask_scores(p, sc, kt, lane, qpos, kvl);
  float mt[2] = {kTcNegInf, kTcNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) mt[(i / 2) % 2] = fmaxf(mt[(i / 2) % 2], sc[i]);
  float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m_run[r], mt[r]);
    const bool dead = m_new <= kTcNegInf / 2;  // no live key yet
    base[r] = dead ? 0.f : m_new;
    alpha[r] = tc::ex2((dead ? 0.f : m_run[r] - m_new) * kLog2e);
    m_run[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    // a masked score (-1e30) gives 2^-huge = 0
    sc[i] = tc::ex2((sc[i] - base[r]) * kLog2e);
    sum[r] += sc[i];
  }
  // p on the src grid: the RNE cast to the tile type is the cast to the
  // src dtype (bf16 / fp16), or exact after the snap of an f32 src
  if (p.snap.m > 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = quantize_rne_bits(sc[i], p.snap.m, p.snap.emax, p.snap.emin);
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) pr[i / 2] = tc::pack2<TT>(sc[i], sc[i + 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l_run[r] = l_run[r] * alpha[r] + sum[r];
  }
}

// Shared memory: Q [D/64 chunks][MT rows], then K slots 0, 1 and V slots
// 0, 1 (each [D/64 chunks][64 keys]), then the barriers fullK[2],
// fullV[2], emptyK[2], emptyV[2].  K and V have rings of their own: K(j) is
// free once S(j) = Q K(j)^T is done, V(j) only after P(j) V(j), which runs
// one tile later.
template <typename TT, int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    TcFlashParams p) {
  constexpr int MT = 64 * NC;
  constexpr uint32_t kQBytes = MT * D * 2, kTile = kTcBK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + kQBytes;          // slot s at Ks + s * kTile
  uint8_t* Vs = Ks + kTcStages * kTile;  // slot s at Vs + s * kTile
  uint64_t* full_k = reinterpret_cast<uint64_t*>(Vs + kTcStages * kTile);
  uint64_t* full_v = full_k + kTcStages;
  uint64_t* empty_k = full_v + kTcStages;
  uint64_t* empty_v = empty_k + kTcStages;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int kvrow = blockIdx.y;
  // the last query tiles see the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.bq;
  const int nrows = min(p.bq, p.sq - q0);
  const int qlo = p.q_offset + q0;
  // this tile's key range (what block_schedule prunes on the host), the
  // union over the group's heads; key tiles start at multiples of kTcBK
  int k_end = 0;
  for (int h = 0; h < p.group; ++h) {
    int e = min(p.kv_len[kvrow * p.group + h], p.nk * p.page);
    if (p.causal) e = min(e, qlo + nrows);
    k_end = max(k_end, e);
  }
  const int k_start = p.window >= 0 ? max(0, qlo - p.window + 1) : 0;
  const int t0 = k_start / kTcBK * kTcBK;
  const int ntiles = k_end > t0 ? (k_end - t0 + kTcBK - 1) / kTcBK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      tc::mbar_init(&full_k[s], p.kv_tma ? 1 : 128);
      tc::mbar_init(&full_v[s], p.kv_tma ? 1 : 128);
      tc::mbar_init(&empty_k[s], 128 * NC);
      tc::mbar_init(&empty_v[s], 128 * NC);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warpgroup: K(j), V(j), K(j + 1), ... into the rings ----
    tc::regs_dec<kTcProducerRegs>();
    if (p.kv_tma && t >= 32) return;  // one warp issues the TMA loads
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kTcStages, kt = t0 + j * kTcBK;
      const uint32_t parity = ((j / kTcStages) & 1) ^ 1;
      for (int which = 0; which < 2; ++which) {
        uint64_t* full = which ? &full_v[s] : &full_k[s];
        uint8_t* dst = (which ? Vs : Ks) + s * kTile;
        tc::mbar_wait(which ? &empty_v[s] : &empty_k[s], parity);
        if (p.kv_tma) {
          if (t == 0) tc::mbar_arrive_expect_tx(full, kTile);
          tma_tile<D>(p, which ? &map_v : &map_k, dst, full, kvrow, kt,
                      k_end, t);
        } else {
          convert_any<TT, D>(p, which ? p.v : p.k, dst, kvrow, kt, k_end, t);
          tc::fence_proxy_async();
          tc::mbar_arrive(full);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup cw: tile rows cw * 64 .. cw * 64 + 63 ----
  tc::regs_inc<tc_consumer_regs<NC>()>();
  const int cw = wg - 1, warp = t / 32, lane = t % 32;
  switch (p.q_dtype) {
    case DT_F32: load_q<float, TT, D, NC>(p, Qs, kvrow, q0, cw, t); break;
    case DT_BF16: load_q<__nv_bfloat16, TT, D, NC>(p, Qs, kvrow, q0, cw, t); break;
    default: load_q<__half, TT, D, NC>(p, Qs, kvrow, q0, cw, t);
  }
  tc::fence_proxy_async();
  tc::named_sync(1 + cw, 128);

  // this thread's two rows: tile rows r0 and r0 + 8
  int qpos[2], kvl[2], orow[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = cw * 64 + 16 * warp + lane / 4 + 8 * r;
    const int h = row / p.bq, i = row % p.bq;
    valid[r] = h < p.group && i < nrows;
    qpos[r] = qlo + i;
    kvl[r] = valid[r] ? min(p.kv_len[kvrow * p.group + h], p.nk * p.page) : 0;
    orow[r] = valid[r] ? (kvrow * p.group + h) * p.sq + q0 + i : 0;
  }
  float m_run[2] = {kTcNegInf, kTcNegInf}, l_run[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[32];
  uint32_t pa[16];
  const uint32_t q_base = tc::smem_u32(Qs) + cw * 64 * 128;

  // S(j) = Q K(j)^T and O += P(j-1) V(j-1) are issued together and run
  // on the tensor cores at once; the softmax of S(j) follows when both have
  // retired.  (Running the softmax while P V is in flight makes ptxas
  // serialize the wgmmas, C7513, and was slower on the card.)
  float alpha[2];
  const uint32_t k_base = tc::smem_u32(Ks), v_base = tc::smem_u32(Vs);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kTcStages, sp = (j - 1 + kTcStages) % kTcStages;
    tc::mbar_wait(&full_k[s], (j / kTcStages) & 1);
    if (j > 0) tc::mbar_wait(&full_v[sp], ((j - 1) / kTcStages) & 1);
    tc::wgmma_fence();
    issue_qk<TT, D, MT>(sc, q_base, k_base + s * kTile);
    if (j > 0) issue_pv<TT, D>(o, pa, v_base + sp * kTile);
    tc::wgmma_wait<0>();
    tc::fence_regs(sc);
    tc::fence_regs(o);
    tc::mbar_arrive(&empty_k[s]);
    if (j > 0) tc::mbar_arrive(&empty_v[sp]);
    softmax_tile<TT>(p, sc, t0 + j * kTcBK, lane, qpos, kvl, m_run, l_run, pa,
                     alpha);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // the running max moved
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    }
  }
  if (ntiles > 0) {
    const int sp = (ntiles - 1) % kTcStages;
    tc::mbar_wait(&full_v[sp], ((ntiles - 1) / kTcStages) & 1);
    tc::wgmma_fence();
    issue_pv<TT, D>(o, pa, v_base + sp * kTile);
    tc::wgmma_wait<0>();
    tc::fence_regs(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!valid[r]) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    float* dst = p.out + (long long)orow[r] * D + 2 * (lane % 4);
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<float2*>(dst + 8 * jb) =
          make_float2(o[4 * jb + 2 * r] / l, o[4 * jb + 2 * r + 1] / l);
  }
}

template <typename TT, int D, int NC>
cudaError_t launch_tc_typed(const TcFlashParams& p, int bkv,
                            cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<TT, __nv_bfloat16>::value;
  CUtensorMap mk, mv;
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  if (p.kv_tma) {
    const uint64_t dims[3] = {(uint64_t)D, (uint64_t)p.page,
                              (uint64_t)p.pool_rows};
    const uint32_t box[3] = {64u, (uint32_t)p.seg_rows, 1u};
    if (!tc_host::make_map(&mk, p.k, kBf16, 3, dims, box) ||
        !tc_host::make_map(&mv, p.v, kBf16, 3, dims, box))
      return cudaErrorInvalidValue;
  }
  constexpr int MT = 64 * NC, threads = 128 * (NC + 1);
  constexpr int smem = MT * D * 2 + 2 * kTcStages * kTcBK * D * 2 +
                       4 * kTcStages * 8 + 1024;
  auto kern = flash_tc_kernel<TT, D, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // setmaxnreg only moves registers inside the CTA's allocation: refuse a
  // build whose allocation cannot serve what the consumers ask for
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * threads <
      128 * (kTcProducerRegs + NC * tc_consumer_regs<NC>()))
    return cudaErrorInvalidConfiguration;
  dim3 grid((p.sq + p.bq - 1) / p.bq, bkv);
  kern<<<grid, threads, smem, stream>>>(mk, mv, p);
  return cudaGetLastError();
}

template <typename TT, int D>
cudaError_t launch_tc_nc(const TcFlashParams& p, int bkv, int nc,
                         cudaStream_t stream) {
  return nc == 1 ? launch_tc_typed<TT, D, 1>(p, bkv, stream)
                 : launch_tc_typed<TT, D, 2>(p, bkv, stream);
}

int gcd_int(int a, int b) { return b ? gcd_int(b, a % b) : a; }

}  // namespace

// q_rows: rows of a CTA's query tile over all heads of the group (64 or
// 128; the tile holds q_rows / group queries of each head); tile_bf16: 1 ->
// bf16 tiles, 0 -> fp16.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* block_table, void* out, int bh, int group, int sq, int d,
    int nk, int page, int pool_rows, int q_offset, int causal, int window,
    int q_dtype, int kv_dtype, int src_kind, int snap_m, int snap_emax,
    int snap_emin, int tile_bf16, int q_rows, float scale, float softcap,
    void* stream) {
  if ((d != 64 && d != 128 && d != 256) || (q_rows != 64 && q_rows != 128) ||
      group < 1 || group > q_rows || sq < 1 || bh % group || page < 1 ||
      nk < 1 || (q_dtype != DT_F32 && q_dtype != DT_BF16 && q_dtype != DT_F16))
    return cudaErrorInvalidValue;
  TcFlashParams p;
  p.q = q; p.k = k; p.v = v;
  p.kv_len = static_cast<const int*>(kv_len);
  p.block_table = static_cast<const int*>(block_table);
  p.out = static_cast<float*>(out);
  p.group = group; p.bq = q_rows / group; p.sq = sq; p.nk = nk;
  p.page = page; p.pool_rows = pool_rows; p.q_offset = q_offset;
  p.causal = causal; p.window = window;
  p.q_dtype = q_dtype; p.kv_dtype = kv_dtype; p.src_kind = src_kind;
  p.snap = Snap{snap_m, snap_emax, snap_emin};
  p.scale = scale; p.softcap = softcap;
  p.two_over_cap = softcap > 0.f ? 2.f / softcap : 0.f;
  // K/V go by TMA when stored in the tile type and the src dtype
  const int native = tile_bf16 ? DT_BF16 : DT_F16;
  p.kv_tma = kv_dtype == native && src_kind == (tile_bf16 ? SRC_BF16 : SRC_F16) &&
             (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
             (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  p.seg_rows = block_table ? gcd_int(page, kTcBK) : kTcBK;
  const int bkv = bh / group, nc = q_rows / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_bf16) {
    switch (d) {
      case 64: return launch_tc_nc<__nv_bfloat16, 64>(p, bkv, nc, s);
      case 128: return launch_tc_nc<__nv_bfloat16, 128>(p, bkv, nc, s);
      default: return launch_tc_nc<__nv_bfloat16, 256>(p, bkv, nc, s);
    }
  }
  switch (d) {
    case 64: return launch_tc_nc<__half, 64>(p, bkv, nc, s);
    case 128: return launch_tc_nc<__half, 128>(p, bkv, nc, s);
    default: return launch_tc_nc<__half, 256>(p, bkv, nc, s);
  }
}
