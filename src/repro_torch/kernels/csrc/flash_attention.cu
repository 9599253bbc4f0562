// Online-softmax prefill attention over a paged (or contiguous) KV cache,
// for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// ``flash_attention_pallas`` (body ``_attn_kernel``, schedule
// ``block_schedule``).
//
// Contract (same as the TPU kernel): q [BH, Sq, D] at positions
// q_offset + i attends keys of KV row bh / group that are < kv_len[bh]
// (k [.., D], v [.., Dv]: V's head dim may differ, as MLA's expanded
// prefill has it, D 96 and Dv 64 (minicpm3) or D 192 and Dv 128
// (deepseek-v2-lite); the output is [BH, Sq, Dv]),
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
// are read once per group of heads.  Three variants, chosen on the host by
// ``flash_route`` (kernels/flash_attention.py) alone:
//
// ``flash_tc`` (tensor cores; src bf16 / fp16, or f32 on a grid exact in a
// 16-bit type; (D, Dv) in {(64, 64), (128, 128), (256, 256), (96, 64),
// (192, 128)}).
// One CTA per (KV row, query tile) carries the tile's queries of every head
// of the GQA group (rows = heads x queries, 64 or 128 of them, one consumer
// warpgroup per 64), so each K/V tile is read once per group.  A producer
// warpgroup fills two rings of 64-key K and V tiles (128-byte swizzle): by
// TMA, one 3-D load per page segment and 64-column chunk, its warp reading
// the block table itself, or, for fp8 pools, f32 containers and a src other
// than the storage type, by loading, widening / snapping (``widen``) and
// writing the tiles itself.
// The consumers run S = Q K^T as an SS wgmma from the swizzled Q tile (loaded
// once), the online softmax in the accumulator layout (row max and sum by
// quad shuffles), and O += P V as an RS wgmma with P in registers; S of tile
// j and P V of tile j - 1 are issued together.  Key tiles start at multiples
// of 64 (``floor(k_start / 64) * 64``), so the plain version walks the same
// blocks and rounds p against the same running max.  A D that is not a
// multiple of 64 (96) rounds Q's and K's tiles up to whole chunks (two; D
// 192 is three whole chunks):
// TMA zero-fills the columns past D (the tensor map's inner extent is D),
// and Q K^T issues only the D / 16 k-steps that hold data, so no step
// reads them.  V's tile is Dv / 64 chunks and P V has N = Dv.
//
// ``flash_split`` (the split route: f32 src that no 16-bit type holds —
// policy fp32, tf32 and wider grids — at the same (D, Dv) pairs), on
// flash_tc's code (its tile range, softmax, masks, telemetry, output
// store, swizzled tiles and wgmma calls): operands go to the tensor cores
// as bf16 pieces
// (``tc::split_bf16``), never formed per MMA: K and V once a launch, by a
// staging pass over the live keys of every KV row
// (``stage_kv_pieces_kernel``, into [pieces][KV row][key][D] copies that
// TMA then reads, as flash_tc reads a bf16 pool); Q once per CTA by the
// consumer; p once per tile after the softmax.  (Forming K's and V's
// pieces in the producers as they convert f32 pools made a CTA split every
// tile it reads, so each tile was split once for every query tile of its
// row and the conversion, not the tensor cores, set the kernel's time.)
// QK^T keeps PQK pieces of Q and K (three without a grid, two for <= 17
// significant bits) and the six (four) pairs of weight 2^-16 and up
// (``tc::for_each_pair``), because the scores feed the softcap's exp:
// each product's error is at most 2^-23 |q||k| (loose), about one f32
// rounding.  P V keeps two pieces of p and of V and the three pairs of
// weight 2^-8 and up (pm vh, ph vl, ph vh): p in [0, 1] and V each lose at
// most 2^-16 of themselves to their pieces and the dropped pm vl is at
// most 2^-18 p |v|, so an output is off by at most about 2^-15 max|v| by
// the loose bound, inside the 2^-12 gate of f32 pools.  Non-finite
// operands keep IEEE's results (``tc::split_bf16``): a non-finite v is
// its last piece, which meets ph alone; a NaN score (a non-finite q or k
// met a zero piece) is recomputed from the pieces' values
// (``split_score_repair``).  Shared memory
// sets the tiles: Q in three pieces at D 256 is 96 KB for 64 rows, so the
// route runs 64-row query tiles (one consumer warpgroup), 64-key tiles up
// to D 128 and 32-key tiles above (three pieces of a 64-key K tile at D
// 256 would be 96 KB a stage), two K stages, and two V stages where they
// fit (one at D 256: 224 KB in all).  ``kernel_block_k`` / ``kernel_tiles``
// report those tiles, so the plain version walks the same keys.
//
// ``flash_fma`` (the first version, kept for every other D, Dv <= 256):
// one CTA per (head row, 32-query tile); K/V tiles of 32
// keys (also starting at multiples of 32) are read through the block table
// into shared memory as f32 with 16-byte loads (``load_rows``), and all
// products are f32 FMAs.
//
// Telemetry (the TPU kernel's ``debug_visits`` / ``debug_flags``, per
// scheduled step of ``block_schedule`` at the variant's own tiles) is a
// compile-time instantiation (``kFlags``) of each variant; the attention
// code is the same in both, so the output is bitwise the flags-off output.
// A visited tile's cell counts OF / UF / NX / NV of every key of the tile
// below the head row's kv_len, K and V, and the q tile at the query block's
// first step, as the TPU kernel does.  The counts come from a count-only
// read of those keys: the attention walk loads only keys below the tile's
// causal reach, while the TPU kernel counts every live key of a visited
// tile.  ``flash_fma``'s CTA counts after its walk; in ``flash_tc`` the
// producer warpgroup's warps that do not issue TMA loads (all four when
// they convert) count beside the consumers, one warp per tile and head
// row, and store each cell once.
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
  float* out;              // [BH, Sq, Dv]
  int* visits;             // [BH, n_steps] telemetry (zeroed), or null
  int* flags;              // [BH, n_steps, 4] telemetry (zeroed), or null
  int n_steps;             // steps of block_schedule at this variant's tiles
  int group, sq, d, dv, nk, page, pool_rows, q_offset;
  int causal, window;      // window < 0: none
  int src_kind;
  Snap snap;
  float scale, softcap, two_over_cap;
};

// Row of key j of KV row ``kvrow`` in the (flat) pool: its K elements start
// at row * D, its V elements at row * Dv.
__device__ __forceinline__ long long key_row(const FlashParams& p, int kvrow,
                                             int j) {
  const int blk = j / p.page;
  const long long phys =
      p.block_table ? (long long)p.block_table[(long long)kvrow * p.nk + blk]
                    : (long long)kvrow * p.nk + blk;
  if (phys < 0 || phys >= p.pool_rows) __trap();  // page id outside the pool
  return phys * p.page + (j % p.page);
}

// The query block ``iq``'s first step in ``block_schedule``'s flat order
// (query blocks of ``bq``, key blocks of ``bk``, ``nkb`` key blocks): the
// runs of the blocks before it, summed.
__device__ __forceinline__ int schedule_base(int iq, int bq, int bk, int nkb,
                                             int q_offset, int causal,
                                             int window) {
  int base = 0;
  for (int i = 0; i < iq; ++i) {
    int hi = nkb - 1;
    if (causal) hi = min(hi, (q_offset + (i + 1) * bq - 1) / bk);
    int lo = 0;
    if (window >= 0) {
      const int first = q_offset + i * bq - window + 1;
      lo = first > 0 ? first / bk : 0;
    }
    base += hi - min(lo, hi) + 1;
  }
  return base;
}

// Zero rows [n, rows) of a [rows][ld] shared tile (the ragged edge).
__device__ __forceinline__ void zero_rows(float* t, int ld, int n, int rows) {
  for (int i = threadIdx.x; i < (rows - n) * ld; i += kThreads)
    t[n * ld + i] = 0.f;
}

template <typename QT, typename KT, bool kFlags>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
             const KT* __restrict__ v, FlashParams p) {
  extern __shared__ float smem[];
  const int D = p.d, DP = p.d + 1, DV = p.dv;
  long long* roff = reinterpret_cast<long long*>(smem);  // [kBK] q / K offsets
  long long* voff = roff + kBK;     // [kBK] V offsets
  float* Qs = smem + 4 * kBK;       // [kBQ][D+1]
  float* Ks = Qs + kBQ * DP;        // [kBK][D+1]
  float* Vs = Ks + kBK * DP;        // [kBK][Dv]
  float* S = Vs + kBK * DV;         // [kBQ][kBK+1] scores, then src-rounded p
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
    if (tid < n) {
      const long long row = key_row(p, kvrow, k0 + tid);
      roff[tid] = row * D;
      voff[tid] = row * DV;
    }
    __syncthreads();
    load_rows<kThreads>(Ks, DP, k, roff, n, D, p.snap, p.src_kind);
    load_rows<kThreads>(Vs, DV, v, voff, n, DV, p.snap, p.src_kind);
    zero_rows(Ks, DP, n, kBK);
    zero_rows(Vs, DV, n, kBK);
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
    if (tid < DV) {
#pragma unroll
      for (int r = 0; r < kBQ; ++r) acc[r] *= a_s[r];
      for (int j = 0; j < n; ++j) {
        const float vv = Vs[j * DV + tid];
#pragma unroll
        for (int r = 0; r < kBQ; ++r) acc[r] += S[r * (kBK + 1) + j] * vv;
      }
    }
    __syncthreads();
  }
  if (tid < DV) {
#pragma unroll
    for (int r = 0; r < kBQ; ++r) {
      if (r < nrows) {
        const float l = l_s[r];
        p.out[((long)bh * p.sq + q0 + r) * DV + tid] =
            acc[r] / (l == 0.f ? 1.f : l);
      }
    }
  }

  if constexpr (kFlags) {
    // ---- telemetry: one cell per visited key tile of the walk above ------
    const int nkb = (p.nk * p.page + kBK - 1) / kBK;
    const int klo = k_start / kBK;
    const int step0 = schedule_base(blockIdx.x, kBQ, kBK, nkb, p.q_offset,
                                    p.causal, p.window);
    for (int k0 = klo * kBK; k0 < k_end; k0 += kBK) {
      const long long cell = (long long)bh * p.n_steps + step0 + k0 / kBK - klo;
      if (tid == 0) p.visits[cell] = 1;
      int c[4] = {0, 0, 0, 0};
      for (int key = k0 + warp; key < min(k0 + kBK, kvl); key += kThreads / 32) {
        const long long row = key_row(p, kvrow, key);
        count_flags(k + row * D, D, p.snap, lane, 32, c);
        count_flags(v + row * DV, DV, p.snap, lane, 32, c);
      }
      if (k0 == klo * kBK)  // the q tile, at the query block's first step
        count_flags(q + ((long long)bh * p.sq + q0) * D, (long long)nrows * D,
                    p.snap, tid, kThreads, c);
      flush_flags(p.flags + cell * 4, c);
    }
  }
}

template <typename QT, typename KT, bool kFlags>
cudaError_t launch_typed(const void* q, const void* k, const void* v, int bh,
                         const FlashParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kBK + kBQ * (p.d + 1) +
                                       kBK * (p.d + 1) + kBK * p.dv +
                                       kBQ * (kBK + 1) + 3 * kBQ);
  auto kern = flash_kernel<QT, KT, kFlags>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kBQ - 1) / kBQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const QT*>(q),
                                         static_cast<const KT*>(k),
                                         static_cast<const KT*>(v), p);
  return cudaGetLastError();
}

template <typename QT, bool kFlags>
cudaError_t launch_kv(const void* q, const void* k, const void* v, int bh,
                      int kv_dtype, const FlashParams& p,
                      cudaStream_t stream) {
  switch (kv_dtype) {
    case DT_F32: return launch_typed<QT, float, kFlags>(q, k, v, bh, p, stream);
    case DT_BF16: return launch_typed<QT, __nv_bfloat16, kFlags>(q, k, v, bh, p, stream);
    case DT_F16: return launch_typed<QT, __half, kFlags>(q, k, v, bh, p, stream);
    case DT_FP8E5M2: return launch_typed<QT, __nv_fp8_e5m2, kFlags>(q, k, v, bh, p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t launch_flags(const void* q, const void* k, const void* v, int bh,
                         int kv_dtype, const FlashParams& p,
                         cudaStream_t stream) {
  return p.flags ? launch_kv<QT, true>(q, k, v, bh, kv_dtype, p, stream)
                 : launch_kv<QT, false>(q, k, v, bh, kv_dtype, p, stream);
}

}  // namespace

// ``visits`` / ``flags``: the zeroed telemetry outputs [bh, n_steps] /
// [bh, n_steps, 4] (both or neither; null launches the flags-off kernel).
extern "C" int flash_attention_fma_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* block_table, void* out, void* visits, void* flags,
    int n_steps, int bh, int group, int sq, int d, int dv,
    int nk, int page, int pool_rows, int q_offset, int causal, int window,
    int q_dtype,
    int kv_dtype, int src_kind, int snap_m, int snap_emax, int snap_emin,
    float scale, float softcap, void* stream) {
  if (d < 1 || d > kThreads || dv < 1 || dv > kThreads || group < 1 || sq < 1)
    return cudaErrorInvalidValue;
  if ((visits == nullptr) != (flags == nullptr)) return cudaErrorInvalidValue;
  FlashParams p;
  p.kv_len = static_cast<const int*>(kv_len);
  p.block_table = static_cast<const int*>(block_table);
  p.out = static_cast<float*>(out);
  p.visits = static_cast<int*>(visits);
  p.flags = static_cast<int*>(flags);
  p.n_steps = n_steps;
  p.group = group; p.sq = sq; p.d = d; p.dv = dv; p.nk = nk; p.page = page;
  p.pool_rows = pool_rows;
  p.q_offset = q_offset; p.causal = causal; p.window = window;
  p.src_kind = src_kind;
  p.snap = Snap{snap_m, snap_emax, snap_emin};
  p.scale = scale;
  p.softcap = softcap;
  p.two_over_cap = softcap > 0.f ? 2.f / softcap : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case DT_F32: return launch_flags<float>(q, k, v, bh, kv_dtype, p, s);
    case DT_BF16: return launch_flags<__nv_bfloat16>(q, k, v, bh, kv_dtype, p, s);
    case DT_F16: return launch_flags<__half>(q, k, v, bh, kv_dtype, p, s);
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
  float* out;              // [BH, Sq, Dv]
  int* visits;             // [BH, n_steps] telemetry (zeroed), or null
  int* flags;              // [BH, n_steps, 4] telemetry (zeroed), or null
  int n_steps;             // steps of block_schedule at (bq, 64)
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

// The producer warpgroup's convert step for one K or V tile of row width
// D: rows of keys kt .. kt + 63 (zeros from k_end on) widened into the
// swizzled tile (columns past D of a last, partial chunk are left as they
// are: no k-step reads them).
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

// One K or V tile of ``NCH`` 64-column chunks by TMA, issued by lane 0 of
// the producer warp: a load per page segment of seg_rows keys and chunk; a
// segment from k_end on is read at a pool row past the end (zero fill), as
// are the columns of a last chunk past the tensor's width.  The lanes look
// up the segments' pages together, so the page-table reads overlap.
template <int NCH>
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
        for (int c = 0; c < NCH; ++c)
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
  // loads in flight per thread (2 at D 96: 768 groups)
  constexpr int kBatch = kGroups % (4 * 128) == 0 ? 4 : 2;
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

// O += P V (A = P from registers, B = the V tile, N-major; N = Dv),
// committed as one asynchronous wgmma group.
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
template <bool kCap, int N>
__device__ __forceinline__ void scale_scores(const TcFlashParams& p,
                                             float (&sc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = sc[i] * p.scale;
    if constexpr (kCap) {
      const float e = expf(x * p.two_over_cap);
      x = p.softcap * (1.f - 2.f / (e + 1.f));
    }
    sc[i] = x;
  }
}

// kv_len, causal and window masks of one S tile (keys kt ..).
template <int N>
__device__ __forceinline__ void mask_scores(const TcFlashParams& p,
                                            float (&sc)[N], int kt,
                                            int lane, const int (&qpos)[2],
                                            const int (&kvl)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i / 2) % 2;
    const int key = kt + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
    bool live = key < kvl[r];
    if (p.causal) live = live && qpos[r] >= key;
    if (p.window >= 0) live = live && (qpos[r] - key) < p.window;
    sc[i] = live ? sc[i] : kTcNegInf;
  }
}

// The online-softmax update of one S tile of BK keys for the thread's two
// rows: p on the src grid (f32 without a grid: as it is), against the
// running max, left in ``sc``; O's rescale in alpha.  Rows whose whole tile
// is live skip the masks.  Scores, the softcap and the running max stay in
// natural units, as in the plain version; only exp(x - m) goes to the SFU
// as 2^((x - m) log2 e), whose error is relative to p.  (Scores held in the
// log2 domain would carry an absolute error of their own size, ~1e-5 at
// softcapped scores near 50, into every p, and flip its src-grid rounding
// often enough to double the distance to the plain version there.)
template <int BK>
__device__ __forceinline__ void softmax_core(
    const TcFlashParams& p, float (&sc)[BK / 2], int kt, int lane,
    const int (&qpos)[2], const int (&kvl)[2], float (&m_run)[2],
    float (&l_run)[2], float (&alpha)[2]) {
  constexpr int N = BK / 2;
  constexpr float kLog2e = 1.4426950408889634f;
  if (p.softcap > 0.f) scale_scores<true>(p, sc);
  else scale_scores<false>(p, sc);
  bool whole = true;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int last = kt + BK - 1;
    whole = whole && last < kvl[r] && (!p.causal || last <= qpos[r]) &&
            (p.window < 0 || qpos[r] - kt < p.window);
  }
  if (!whole) mask_scores(p, sc, kt, lane, qpos, kvl);
  float mt[2] = {kTcNegInf, kTcNegInf};
#pragma unroll
  for (int i = 0; i < N; ++i) mt[(i / 2) % 2] = fmaxf(mt[(i / 2) % 2], sc[i]);
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
  for (int i = 0; i < N; ++i) {
    const int r = (i / 2) % 2;
    // a masked score (-1e30) gives 2^-huge = 0
    sc[i] = tc::ex2((sc[i] - base[r]) * kLog2e);
    sum[r] += sc[i];
  }
  // p on the src grid: the snap of an f32 src with a grid (a 16-bit src's
  // rounding is the cast to the tile type that follows)
  if (p.snap.m > 0) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      sc[i] = quantize_rne_bits(sc[i], p.snap.m, p.snap.emax, p.snap.emin);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l_run[r] = l_run[r] * alpha[r] + sum[r];
  }
}

// ``softmax_core`` of a 64-key tile, p packed into pr as the A fragments
// of P V (the RNE cast to the tile type is the cast to the src dtype, or
// exact after the snap of an f32 src).
template <typename TT>
__device__ __forceinline__ void softmax_tile(
    const TcFlashParams& p, float (&sc)[32], int kt, int lane,
    const int (&qpos)[2], const int (&kvl)[2], float (&m_run)[2],
    float (&l_run)[2], uint32_t (&pr)[16], float (&alpha)[2]) {
  softmax_core<kTcBK>(p, sc, kt, lane, qpos, kvl, m_run, l_run, alpha);
#pragma unroll
  for (int i = 0; i < 32; i += 2) pr[i / 2] = tc::pack2<TT>(sc[i], sc[i + 1]);
}

// Telemetry of one CTA (query tile q0 of KV row kvrow, key tiles t0 .. of
// its walk), by warp ``w`` of ``nw`` producer warps: tile j goes to warp
// j mod nw, which counts, for each head row of the group that the tile is
// visited for (a key below its kv_len and the tile's causal reach), the
// flags of the tile's keys below that kv_len (K and V; counted once per
// distinct kv_len) plus, at the first step, the head's q rows, and stores
// the cell and its visit.
// Adds the flags of keys [kt, e) of KV row ``kvrow``, K and V (D and Dv
// elements each, through the block table): the warp's lanes take 16-byte
// vectors across the rows, decoded by the pool's dtype code.
template <int D, int DV>
__device__ __forceinline__ void tc_count_kv(const TcFlashParams& p, int kvrow,
                                           int kt, int e, int lane,
                                           int (&c)[4]) {
  const int esz = dtype_bytes(p.kv_dtype);
  for (int which = 0; which < 2; ++which) {
    const void* src = which ? p.v : p.k;
    const int w = which ? DV : D, per_row = w * esz / 16;
    if (reinterpret_cast<uintptr_t>(src) & 15) {  // a pool not 16-byte aligned
      for (int key = kt; key < e; ++key)
        count_flags_any(src, p.kv_dtype,
                        (tc_phys(p, kvrow, key) * p.page + key % p.page) * w,
                        w, p.snap, lane, 32, c);
      continue;
    }
    const unsigned char* base = static_cast<const unsigned char*>(src);
    for (int i = lane; i < (e - kt) * per_row; i += 32) {
      const int key = kt + i / per_row;
      const long long row = tc_phys(p, kvrow, key) * p.page + key % p.page;
      add_flags16(c, __ldg(reinterpret_cast<const uint4*>(base + row * w * esz) +
                           i % per_row),
                  p.kv_dtype, p.snap);
    }
  }
}

template <int D, int DV, int BK = kTcBK>
__device__ __forceinline__ void tc_telemetry(const TcFlashParams& p, int kvrow,
                                          int q0, int nrows, int qlo, int t0,
                                          int ntiles, int w, int nw) {
  const int lane = threadIdx.x & 31;
  const int nkb = (p.nk * p.page + BK - 1) / BK;
  const int step0 = schedule_base(q0 / p.bq, p.bq, BK, nkb, p.q_offset,
                                  p.causal, p.window);
  for (int j = w; j < ntiles; j += nw) {
    const int kt = t0 + j * BK;
    int kv[4] = {0, 0, 0, 0}, counted_to = -1;
    for (int h = 0; h < p.group; ++h) {
      const int hrow = kvrow * p.group + h;
      const int kvl = min(p.kv_len[hrow], p.nk * p.page);
      if (kt >= (p.causal ? min(kvl, qlo + nrows) : kvl)) continue;
      const int e = min(kt + BK, kvl);
      if (e != counted_to) {
        kv[0] = kv[1] = kv[2] = kv[3] = 0;
        tc_count_kv<D, DV>(p, kvrow, kt, e, lane, kv);
        warp_total(kv);
        counted_to = e;
      }
      int c[4] = {0, 0, 0, 0};
      if (j == 0) {  // the q tile, at the query block's first step
        count_flags_any(p.q, p.q_dtype, ((long long)hrow * p.sq + q0) * D,
                        (long long)nrows * D, p.snap, lane, 32, c);
        warp_total(c);
      }
      if (lane == 0) {
        const long long cell = (long long)hrow * p.n_steps + step0 + j;
        p.visits[cell] = 1;
#pragma unroll
        for (int k = 0; k < 4; ++k) p.flags[cell * 4 + k] = kv[k] + c[k];
      }
    }
  }
}

// 64-column chunks of a tile of row width D (a partial last chunk counts).
template <int D>
__host__ __device__ constexpr int tc_chunks() {
  return (D + 63) / 64;
}

// The key range of one CTA (query tile q0 of KV row kvrow, the last tiles,
// which see the most keys, first): what block_schedule prunes on the
// host, the union over the group's heads, in BK-key tiles from a multiple
// of BK.
template <int BK>
__device__ __forceinline__ void tile_range(const TcFlashParams& p, int kvrow,
                                           int& q0, int& nrows, int& qlo,
                                           int& k_end, int& t0, int& ntiles) {
  q0 = (gridDim.x - 1 - blockIdx.x) * p.bq;
  nrows = min(p.bq, p.sq - q0);
  qlo = p.q_offset + q0;
  k_end = 0;
  for (int h = 0; h < p.group; ++h) {
    int e = min(p.kv_len[kvrow * p.group + h], p.nk * p.page);
    if (p.causal) e = min(e, qlo + nrows);
    k_end = max(k_end, e);
  }
  const int k_start = p.window >= 0 ? max(0, qlo - p.window + 1) : 0;
  t0 = k_start / BK * BK;
  ntiles = k_end > t0 ? (k_end - t0 + BK - 1) / BK : 0;
}

// A consumer thread's two rows, tile rows row0 + lane / 4 and 8 below:
// query position, kv_len, output row, and whether the row is live.
__device__ __forceinline__ void consumer_rows(const TcFlashParams& p,
                                              int kvrow, int q0, int qlo,
                                              int nrows, int row0, int lane,
                                              int (&qpos)[2], int (&kvl)[2],
                                              int (&orow)[2],
                                              bool (&valid)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    const int h = row / p.bq, i = row % p.bq;
    valid[r] = h < p.group && i < nrows;
    qpos[r] = qlo + i;
    kvl[r] = valid[r] ? min(p.kv_len[kvrow * p.group + h], p.nk * p.page) : 0;
    orow[r] = valid[r] ? (kvrow * p.group + h) * p.sq + q0 + i : 0;
  }
}

// The live rows of O (the accumulator layout of an m64nDv wgmma) over
// their denominators; a fully masked row stores zeros.
template <int DV>
__device__ __forceinline__ void store_rows(const TcFlashParams& p,
                                           const float (&o)[DV / 2],
                                           const float (&l_run)[2],
                                           const bool (&valid)[2],
                                           const int (&orow)[2], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!valid[r]) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    float* dst = p.out + (long long)orow[r] * DV + 2 * (lane % 4);
#pragma unroll
    for (int jb = 0; jb < DV / 8; ++jb)
      *reinterpret_cast<float2*>(dst + 8 * jb) =
          make_float2(o[4 * jb + 2 * r] / l, o[4 * jb + 2 * r + 1] / l);
  }
}

// Shared memory: Q [D/64 chunks, rounded up][MT rows], then K slots 0, 1
// (each [D/64 chunks, rounded up][64 keys]) and V slots 0, 1 (each [Dv/64
// chunks][64 keys]), then the barriers fullK[2], fullV[2], emptyK[2],
// emptyV[2].  K and V have rings of their own: K(j) is free once S(j) = Q
// K(j)^T is done, V(j) only after P(j) V(j), which runs one tile later.
template <typename TT, int D, int DV, int NC, bool kFlags>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    TcFlashParams p) {
  constexpr int MT = 64 * NC;
  constexpr uint32_t kQBytes = MT * tc_chunks<D>() * 128,
                     kKTile = kTcBK * tc_chunks<D>() * 128,
                     kVTile = kTcBK * DV * 2;
  static_assert(DV % 64 == 0, "V tiles are whole chunks");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + kQBytes;           // slot s at Ks + s * kKTile
  uint8_t* Vs = Ks + kTcStages * kKTile;  // slot s at Vs + s * kVTile
  uint64_t* full_k = reinterpret_cast<uint64_t*>(Vs + kTcStages * kVTile);
  uint64_t* full_v = full_k + kTcStages;
  uint64_t* empty_k = full_v + kTcStages;
  uint64_t* empty_v = empty_k + kTcStages;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int kvrow = blockIdx.y;
  int q0, nrows, qlo, k_end, t0, ntiles;
  tile_range<kTcBK>(p, kvrow, q0, nrows, qlo, k_end, t0, ntiles);

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
    if (p.kv_tma && t >= 32) {  // one warp issues the TMA loads
      if constexpr (kFlags)
        tc_telemetry<D, DV>(p, kvrow, q0, nrows, qlo, t0, ntiles, t / 32 - 1,
                            3);
      return;
    }
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kTcStages, kt = t0 + j * kTcBK;
      const uint32_t parity = ((j / kTcStages) & 1) ^ 1;
      for (int which = 0; which < 2; ++which) {
        uint64_t* full = which ? &full_v[s] : &full_k[s];
        uint8_t* dst = which ? Vs + s * kVTile : Ks + s * kKTile;
        tc::mbar_wait(which ? &empty_v[s] : &empty_k[s], parity);
        if (p.kv_tma) {
          if (t == 0) tc::mbar_arrive_expect_tx(full, which ? kVTile : kKTile);
          if (which)
            tma_tile<DV / 64>(p, &map_v, dst, full, kvrow, kt, k_end, t);
          else
            tma_tile<tc_chunks<D>()>(p, &map_k, dst, full, kvrow, kt, k_end,
                                     t);
        } else {
          if (which)
            convert_any<TT, DV>(p, p.v, dst, kvrow, kt, k_end, t);
          else
            convert_any<TT, D>(p, p.k, dst, kvrow, kt, k_end, t);
          tc::fence_proxy_async();
          tc::mbar_arrive(full);
        }
      }
    }
    if constexpr (kFlags) {
      if (!p.kv_tma)
        tc_telemetry<D, DV>(p, kvrow, q0, nrows, qlo, t0, ntiles, t / 32, 4);
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

  int qpos[2], kvl[2], orow[2];
  bool valid[2];
  consumer_rows(p, kvrow, q0, qlo, nrows, cw * 64 + 16 * warp, lane, qpos,
                kvl, orow, valid);
  float m_run[2] = {kTcNegInf, kTcNegInf}, l_run[2] = {0.f, 0.f};
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
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
    issue_qk<TT, D, MT>(sc, q_base, k_base + s * kKTile);
    if (j > 0) issue_pv<TT, DV>(o, pa, v_base + sp * kVTile);
    tc::wgmma_wait<0>();
    tc::fence_regs(sc);
    tc::fence_regs(o);
    tc::mbar_arrive(&empty_k[s]);
    if (j > 0) tc::mbar_arrive(&empty_v[sp]);
    softmax_tile<TT>(p, sc, t0 + j * kTcBK, lane, qpos, kvl, m_run, l_run, pa,
                     alpha);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // the running max moved
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    }
  }
  if (ntiles > 0) {
    const int sp = (ntiles - 1) % kTcStages;
    tc::mbar_wait(&full_v[sp], ((ntiles - 1) / kTcStages) & 1);
    tc::wgmma_fence();
    issue_pv<TT, DV>(o, pa, v_base + sp * kVTile);
    tc::wgmma_wait<0>();
    tc::fence_regs(o);
  }

  store_rows<DV>(p, o, l_run, valid, orow, lane);
}

template <typename TT, int D, int DV, int NC, bool kFlags>
cudaError_t launch_tc_typed(const TcFlashParams& p, int bkv,
                            cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<TT, __nv_bfloat16>::value;
  CUtensorMap mk, mv;
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  if (p.kv_tma) {
    // inner extents D and Dv: a box column past D reads as zero
    const uint64_t dk[3] = {(uint64_t)D, (uint64_t)p.page,
                            (uint64_t)p.pool_rows};
    const uint64_t dv[3] = {(uint64_t)DV, (uint64_t)p.page,
                            (uint64_t)p.pool_rows};
    const uint32_t box[3] = {64u, (uint32_t)p.seg_rows, 1u};
    if (!tc_host::make_map(&mk, p.k, kBf16, 3, dk, box) ||
        !tc_host::make_map(&mv, p.v, kBf16, 3, dv, box))
      return cudaErrorInvalidValue;
  }
  constexpr int MT = 64 * NC, threads = 128 * (NC + 1);
  constexpr int smem = MT * tc_chunks<D>() * 128 +
                       kTcStages * kTcBK * (tc_chunks<D>() * 128 + DV * 2) +
                       4 * kTcStages * 8 + 1024;
  auto kern = flash_tc_kernel<TT, D, DV, NC, kFlags>;
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

template <typename TT, int D, int DV, bool kFlags>
cudaError_t launch_tc_nc(const TcFlashParams& p, int bkv, int nc,
                         cudaStream_t stream) {
  return nc == 1 ? launch_tc_typed<TT, D, DV, 1, kFlags>(p, bkv, stream)
                 : launch_tc_typed<TT, D, DV, 2, kFlags>(p, bkv, stream);
}

// The telemetry instantiation when the caller asked for it.
template <typename TT, int D, int DV>
cudaError_t launch_tc_flags(const TcFlashParams& p, int bkv, int nc,
                            cudaStream_t stream) {
  return p.flags ? launch_tc_nc<TT, D, DV, true>(p, bkv, nc, stream)
                 : launch_tc_nc<TT, D, DV, false>(p, bkv, nc, stream);
}

// The (D, Dv) instantiation of a pair the entry point admitted (the
// head-dim pairs of TC_HEAD_PAIRS, kernels/flash_attention.py): Dv follows
// from D.
template <typename TT>
cudaError_t launch_tc_dims(const TcFlashParams& p, int bkv, int nc, int d,
                           cudaStream_t stream) {
  if (d == 96) return launch_tc_flags<TT, 96, 64>(p, bkv, nc, stream);
  if (d == 192) return launch_tc_flags<TT, 192, 128>(p, bkv, nc, stream);
  switch (d) {
    case 64: return launch_tc_flags<TT, 64, 64>(p, bkv, nc, stream);
    case 128: return launch_tc_flags<TT, 128, 128>(p, bkv, nc, stream);
    default: return launch_tc_flags<TT, 256, 256>(p, bkv, nc, stream);
  }
}

int gcd_int(int a, int b) { return b ? gcd_int(b, a % b) : a; }

}  // namespace

// q_rows: rows of a CTA's query tile over all heads of the group (64 or
// 128; the tile holds q_rows / group queries of each head); tile_bf16: 1 ->
// bf16 tiles, 0 -> fp16; ``visits`` / ``flags`` as for flash_fma; (d, dv)
// one of (64, 64), (128, 128), (256, 256), (96, 64), (192, 128).
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* block_table, void* out, void* visits, void* flags,
    int n_steps, int bh, int group, int sq, int d, int dv,
    int nk, int page, int pool_rows, int q_offset, int causal, int window,
    int q_dtype, int kv_dtype, int src_kind, int snap_m, int snap_emax,
    int snap_emin, int tile_bf16, int q_rows, float scale, float softcap,
    void* stream) {
  const bool pair = (d == dv && (d == 64 || d == 128 || d == 256)) ||
                    (d == 96 && dv == 64) || (d == 192 && dv == 128);
  if (!pair || (q_rows != 64 && q_rows != 128) ||
      group < 1 || group > q_rows || sq < 1 || bh % group || page < 1 ||
      nk < 1 || (q_dtype != DT_F32 && q_dtype != DT_BF16 && q_dtype != DT_F16) ||
      (visits == nullptr) != (flags == nullptr))
    return cudaErrorInvalidValue;
  TcFlashParams p;
  p.q = q; p.k = k; p.v = v;
  p.kv_len = static_cast<const int*>(kv_len);
  p.block_table = static_cast<const int*>(block_table);
  p.out = static_cast<float*>(out);
  p.visits = static_cast<int*>(visits);
  p.flags = static_cast<int*>(flags);
  p.n_steps = n_steps;
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
  return tile_bf16 ? launch_tc_dims<__nv_bfloat16>(p, bkv, nc, d, s)
                   : launch_tc_dims<__half>(p, bkv, nc, d, s);
}

// ===========================================================================
// flash_split: f32 attention on the tensor cores as sums of bf16 piece
// products (the split route), on flash_tc's code
// ===========================================================================
namespace {

using namespace repro;

// The tile plan of one (D, Dv) instantiation with PQK pieces of Q and K
// (P and V always take two): 64 query rows, BK-key tiles (64, or 32 above
// D 128 so that three pieces of Q and two K stages fit), two K stages, and
// two V stages where they fit (one at D 256).
template <int D, int DV, int PQK>
struct SplitPlan {
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr uint32_t QPiece = 64 * tc_chunks<D>() * 128,
                            KPiece = BK * tc_chunks<D>() * 128,
                            VPiece = BK * DV * 2;
  static constexpr uint32_t QBytes = PQK * QPiece, KStage = PQK * KPiece,
                            VStage = 2 * VPiece;
  static constexpr int kRoom = 232448 - 1024 - 64;
  static constexpr int SK = 2;
  static constexpr int SV =
      QBytes + 2 * (KStage + VStage) <= (uint32_t)kRoom ? 2 : 1;
  static constexpr int Smem =
      QBytes + SK * KStage + SV * VStage + 2 * (SK + SV) * 8 + 1024;
  static_assert(QBytes + SK * KStage + SV * VStage <= (uint32_t)kRoom,
                "the split tiles fit shared memory");
};

// One split step of eight values: piece ``i`` of each (``r`` holds what
// the pieces before it left), written as one 16-byte unit of a tile.
__device__ __forceinline__ void put8_piece(uint8_t* dst, float (&r)[8],
                                           bool first, bool last) {
  float h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = tc::split_step(r[e], first, last);
  put8<__nv_bfloat16>(dst, h);
}

// The split route's staging pass: the K (or V) rows of every KV row
// (blockIdx.y), through the block table, widened / snapped and cut into P
// bf16 pieces, piece i written to dst [i][bkv][skv_pad][W].  Only the keys
// a tile reads are written: the row's live keys (to the largest kv_len of
// its heads) and zeros to the end of its last ``bk``-key tile; the keys
// past that are never read, so the cost follows the live keys, not the
// block table's width.  Each key is split once a launch, however many
// query tiles of its row read it; the flash kernel then reads the pieces
// by TMA as flash_tc reads a bf16 pool.
template <typename KT, int P>
__global__ void stage_kv_pieces_kernel(const TcFlashParams p,
                                       const KT* __restrict__ src,
                                       uint4* __restrict__ dst, int w,
                                       int bkv, int skv_pad, int bk) {
  const int kvrow = blockIdx.y;
  const long long per_key = w / 8, per_row = (long long)skv_pad * per_key,
                  total = bkv * per_row;
  int kend = 0;
  for (int h = 0; h < p.group; ++h)
    kend = max(kend, min(p.kv_len[kvrow * p.group + h], p.nk * p.page));
  const long long n =
      min((long long)skv_pad, (long long)(kend + bk - 1) / bk * bk) * per_key;
  uint4* row = dst + kvrow * per_row;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < n;
       g += (long long)gridDim.x * blockDim.x) {
    const int key = (int)(g / per_key);
    const int c = (int)(g % per_key) * 8;
    long long phys = key < kend ? tc_phys(p, kvrow, key) : -1;
    float v[8];
    widen8(src + (phys >= 0 ? (phys * p.page + key % p.page) * w + c : 0),
           phys >= 0, p.snap, p.src_kind, v);
    float pc[8][P];
#pragma unroll
    for (int e = 0; e < 8; ++e) tc::split_bf16<P>(v[e], pc[e]);
#pragma unroll
    for (int i = 0; i < P; ++i)
      row[i * total + g] = make_uint4(
          tc::pack2<__nv_bfloat16>(pc[0][i], pc[1][i]),
          tc::pack2<__nv_bfloat16>(pc[2][i], pc[3][i]),
          tc::pack2<__nv_bfloat16>(pc[4][i], pc[5][i]),
          tc::pack2<__nv_bfloat16>(pc[6][i], pc[7][i]));
  }
}

// The consumer's Q tile (64 rows over the group's heads) in P pieces.
template <typename QT, int D, int P>
__device__ __forceinline__ void load_q_split(const TcFlashParams& p,
                                             uint8_t* qs, uint32_t piece,
                                             int kvrow, int q0, int t) {
  const QT* q = static_cast<const QT*>(p.q);
  constexpr int kGroups = 64 * D / 8;
  constexpr int kBatch = kGroups % (4 * 128) == 0 ? 4 : 2;
  static_assert(kGroups % (kBatch * 128) == 0, "whole batches");
  for (int g0 = t; g0 < kGroups; g0 += kBatch * 128) {
    float x[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int g = g0 + u * 128, rr = g / (D / 8), c = (g % (D / 8)) * 8;
      const int h = rr / p.bq, i = rr % p.bq;
      const bool ok = h < p.group && q0 + i < p.sq;
      const long long off =
          ok ? (((long long)kvrow * p.group + h) * p.sq + q0 + i) * D + c : 0;
      widen8(q + off, ok, p.snap, p.src_kind, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int g = g0 + u * 128, rr = g / (D / 8), c = (g % (D / 8)) * 8;
      uint8_t* at = qs + (c >> 6) * (64 * 128) + tc::sw128(rr, c & 63);
#pragma unroll
      for (int i = 0; i < P; ++i)
        put8_piece(at + i * piece, x[u], i == 0, i == P - 1);
    }
  }
}

// S = Q K^T over the kept pairs of Q's and K's pieces (m64 nBK, K-major A
// and B), committed as one asynchronous wgmma group; S starts at zero.
template <int D, int DV, int PQK>
__device__ __forceinline__ void issue_qk_split(
    float (&sc)[SplitPlan<D, DV, PQK>::BK / 2], uint32_t q_base,
    uint32_t k_base) {
  using L = SplitPlan<D, DV, PQK>;
  tc::for_each_pair<PQK, PQK>([&](int i, int j, bool first) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // k16 step inside the chunk
      const uint64_t da = tc::desc_sw128(
          q_base + i * L::QPiece + (kk / 4) * (64 * 128) + off, 16, 1024);
      const uint64_t db = tc::desc_sw128(
          k_base + j * L::KPiece + (kk / 4) * (L::BK * 128) + off, 16, 1024);
      tc::wgmma_ss<__nv_bfloat16, L::BK, 0>(sc, da, db, !(first && kk == 0));
    }
  });
  tc::wgmma_commit();
}

// O += P V over one piece pair: A = a piece of P from registers, B = a
// piece of the V tile (N-major, N = Dv).
template <int DV, int BK>
__device__ __forceinline__ void pv_pass(float (&o)[DV / 2],
                                        const uint32_t (&pr)[BK / 4],
                                        uint32_t v_piece) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = tc::desc_sw128(v_piece + kk * 2048, BK * 128, 1024);
    tc::wgmma_rs<__nv_bfloat16, DV, 1>(o, pr[4 * kk], pr[4 * kk + 1],
                                       pr[4 * kk + 2], pr[4 * kk + 3], db, 1);
  }
}

// O += P V with two pieces of P (ph, pm) and of V (vh, vl): the three
// pairs of weight 2^-8 and up, pm vh, ph vl, ph vh, one group.  (pm vl is
// at most 2^-18 p |v|.)  A non-finite v is its last piece, vl, which
// meets ph alone: ph is 0 only where p is, so the pair gives p v's IEEE
// value (+-Inf, or NaN at p = 0 as the plain version's 0 x Inf).
template <int DV, int BK>
__device__ __forceinline__ void issue_pv_split(float (&o)[DV / 2],
                                               const uint32_t (&ph)[BK / 4],
                                               const uint32_t (&pm)[BK / 4],
                                               uint32_t v_base,
                                               uint32_t v_piece) {
  pv_pass<DV, BK>(o, pm, v_base);
  pv_pass<DV, BK>(o, ph, v_base + v_piece);
  pv_pass<DV, BK>(o, ph, v_base);
  tc::wgmma_commit();
}

// The score of one (tile row, key) pair as the f32 dot of the values Q's
// and K's pieces in shared memory hold (``tc::piece_sum``'s order): the
// repair of a NaN that a non-finite q or k made by meeting its partner's
// zero piece, which gives IEEE's +-Inf or NaN.  Run only on a NaN score.
// (Inlined, at one call site: a call would make ptxas serialize the
// kernel's wgmmas.)
template <int D, int PQK, int BK>
__device__ __forceinline__ float split_score_repair(const uint8_t* qs,
                                                 uint32_t q_piece,
                                                 const uint8_t* ks,
                                                 uint32_t k_piece, int row,
                                                 int key) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) {
    const uint32_t qo = (d >> 6) * (64 * 128) + tc::sw128(row, d & 63),
                   ko = (d >> 6) * (BK * 128) + tc::sw128(key, d & 63);
    float qv = 0.f, kv = 0.f;
#pragma unroll
    for (int i = 0; i < PQK; ++i) {
      qv += __bfloat162float(
          *reinterpret_cast<const __nv_bfloat16*>(qs + i * q_piece + qo));
      kv += __bfloat162float(
          *reinterpret_cast<const __nv_bfloat16*>(ks + i * k_piece + ko));
    }
    s = fmaf(qv, kv, s);
  }
  return s;
}

// Shared memory: Q [PQK pieces][D/64 chunks][64 rows], K stages [PQK
// pieces][chunks][BK keys], V stages [2 pieces][Dv/64 chunks][BK keys],
// then the barriers fullK, fullV, emptyK, emptyV.  The staged pieces
// (``stage_kv_pieces_kernel``) arrive by TMA: warp 0 of the producer
// warpgroup issues the K loads, warp 1 the V loads, each at its own pace
// (a V stage frees only after P V), warps 2 and 3 count the telemetry.
template <int D, int DV, int PQK, bool kFlags>
__global__ void __launch_bounds__(256, 1)
    flash_split_kernel(const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       TcFlashParams p) {
  using L = SplitPlan<D, DV, PQK>;
  constexpr int BK = L::BK, SK = L::SK, SV = L::SV;
  static_assert(DV % 64 == 0, "V tiles are whole chunks");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + L::QBytes;   // stage s at Ks + s * KStage
  uint8_t* Vs = Ks + SK * L::KStage;  // stage s at Vs + s * VStage
  uint64_t* full_k = reinterpret_cast<uint64_t*>(Vs + SV * L::VStage);
  uint64_t* full_v = full_k + SK;
  uint64_t* empty_k = full_v + SV;
  uint64_t* empty_v = empty_k + SK;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int kvrow = blockIdx.y, bkv = gridDim.y;
  int q0, nrows, qlo, k_end, t0, ntiles;
  tile_range<BK>(p, kvrow, q0, nrows, qlo, k_end, t0, ntiles);

  if (threadIdx.x == 0) {
    for (int s = 0; s < SK; ++s) {
      tc::mbar_init(&full_k[s], 1);
      tc::mbar_init(&empty_k[s], 128);
    }
    for (int s = 0; s < SV; ++s) {
      tc::mbar_init(&full_v[s], 1);
      tc::mbar_init(&empty_v[s], 128);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    tc::regs_dec<kTcProducerRegs>();
    const int warp = t / 32;
    if (warp >= 2) {
      if constexpr (kFlags)
        tc_telemetry<D, DV, BK>(p, kvrow, q0, nrows, qlo, t0, ntiles,
                                warp - 2, 2);
      return;
    }
    if (t % 32 == 0) {
      for (int j = 0; j < ntiles; ++j) {
        const int kt = t0 + j * BK;
        if (warp == 0) {
          const int sk = j % SK;
          tc::mbar_wait(&empty_k[sk], ((j / SK) & 1) ^ 1);
          tc::mbar_arrive_expect_tx(&full_k[sk], L::KStage);
          uint8_t* dst = Ks + sk * L::KStage;
#pragma unroll
          for (int i = 0; i < PQK; ++i)
#pragma unroll
            for (int c = 0; c < tc_chunks<D>(); ++c)
              tc::tma_load_3d(dst + i * L::KPiece + c * (BK * 128), &map_k,
                              &full_k[sk], c * 64, kt, i * bkv + kvrow);
        } else {
          const int sv = j % SV;
          tc::mbar_wait(&empty_v[sv], ((j / SV) & 1) ^ 1);
          tc::mbar_arrive_expect_tx(&full_v[sv], L::VStage);
          uint8_t* dst = Vs + sv * L::VStage;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < DV / 64; ++c)
              tc::tma_load_3d(dst + i * L::VPiece + c * (BK * 128), &map_v,
                              &full_v[sv], c * 64, kt, i * bkv + kvrow);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: the tile's 64 rows ----
  tc::regs_inc<tc_consumer_regs<1>()>();
  const int warp = t / 32, lane = t % 32;
  if (p.q_dtype == DT_F32) load_q_split<float, D, PQK>(p, Qs, L::QPiece, kvrow, q0, t);
  else if (p.q_dtype == DT_BF16)
    load_q_split<__nv_bfloat16, D, PQK>(p, Qs, L::QPiece, kvrow, q0, t);
  else load_q_split<__half, D, PQK>(p, Qs, L::QPiece, kvrow, q0, t);
  tc::fence_proxy_async();
  tc::named_sync(1, 128);

  int qpos[2], kvl[2], orow[2];
  bool valid[2];
  consumer_rows(p, kvrow, q0, qlo, nrows, 16 * warp, lane, qpos, kvl, orow,
                valid);
  float m_run[2] = {kTcNegInf, kTcNegInf}, l_run[2] = {0.f, 0.f};
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float sc[BK / 2];
  uint32_t ph[BK / 4], pm[BK / 4];
  float alpha[2];
  const uint32_t q_base = tc::smem_u32(Qs), k_base = tc::smem_u32(Ks),
                 v_base = tc::smem_u32(Vs);
  // S(j) and P(j-1) V(j-1) issued together, as in flash_tc
  for (int j = 0; j < ntiles; ++j) {
    const int sk = j % SK, svp = (j - 1 + SV) % SV;
    tc::mbar_wait(&full_k[sk], (j / SK) & 1);
    if (j > 0) tc::mbar_wait(&full_v[svp], ((j - 1) / SV) & 1);
    tc::wgmma_fence();
    issue_qk_split<D, DV, PQK>(sc, q_base, k_base + sk * L::KStage);
    if (j > 0)
      issue_pv_split<DV, BK>(o, ph, pm, v_base + svp * L::VStage, L::VPiece);
    tc::wgmma_wait<0>();
    tc::fence_regs(sc);
    tc::fence_regs(o);
    // NaN scores, repaired while K's stage is still here (one copy of
    // the repair, the register array written through selects)
    uint32_t nan_sc = 0;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) nan_sc |= (sc[i] != sc[i]) ? 1u << i : 0u;
    while (nan_sc) {
      const int e = __ffs(nan_sc) - 1;
      nan_sc &= nan_sc - 1;
      const float r = split_score_repair<D, PQK, BK>(
          Qs, L::QPiece, Ks + sk * L::KStage, L::KPiece,
          16 * warp + lane / 4 + 8 * ((e / 2) % 2),
          8 * (e / 4) + 2 * (lane % 4) + (e % 2));
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = i == e ? r : sc[i];
    }
    tc::mbar_arrive(&empty_k[sk]);
    if (j > 0) tc::mbar_arrive(&empty_v[svp]);
    softmax_core<BK>(p, sc, t0 + j * BK, lane, qpos, kvl, m_run, l_run, alpha);
    // p in two pieces, as the A fragments of P V
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      float a[2], b[2];
      tc::split_bf16<2>(sc[i], a);
      tc::split_bf16<2>(sc[i + 1], b);
      ph[i / 2] = tc::pack2<__nv_bfloat16>(a[0], b[0]);
      pm[i / 2] = tc::pack2<__nv_bfloat16>(a[1], b[1]);
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // the running max moved
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    }
  }
  if (ntiles > 0) {
    const int svp = (ntiles - 1) % SV;
    tc::mbar_wait(&full_v[svp], ((ntiles - 1) / SV) & 1);
    tc::wgmma_fence();
    issue_pv_split<DV, BK>(o, ph, pm, v_base + svp * L::VStage, L::VPiece);
    tc::wgmma_wait<0>();
    tc::fence_regs(o);
  }

  store_rows<DV>(p, o, l_run, valid, orow, lane);
}

template <typename KT, int P>
cudaError_t stage_kv_typed(const TcFlashParams& p, const void* src,
                           void* dst, int w, int bkv, int skv_pad, int bk,
                           cudaStream_t stream) {
  // a row's blocks cover its whole staged width; the blocks past its live
  // keys return at once
  const long long per_row = (long long)skv_pad * (w / 8);
  const long long want = (per_row + 255) / 256,
                  cap = bkv < 4096 ? 4096 / bkv : 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)bkv);
  stage_kv_pieces_kernel<KT, P><<<grid, 256, 0, stream>>>(
      p, static_cast<const KT*>(src), static_cast<uint4*>(dst), w, bkv,
      skv_pad, bk);
  return cudaGetLastError();
}

template <int P>
cudaError_t stage_kv_any(const TcFlashParams& p, const void* src, void* dst,
                         int w, int bkv, int skv_pad, int bk,
                         cudaStream_t stream) {
  switch (p.kv_dtype) {
    case DT_F32: return stage_kv_typed<float, P>(p, src, dst, w, bkv, skv_pad, bk, stream);
    case DT_BF16: return stage_kv_typed<__nv_bfloat16, P>(p, src, dst, w, bkv, skv_pad, bk, stream);
    case DT_F16: return stage_kv_typed<__half, P>(p, src, dst, w, bkv, skv_pad, bk, stream);
    case DT_FP8E5M2: return stage_kv_typed<__nv_fp8_e5m2, P>(p, src, dst, w, bkv, skv_pad, bk, stream);
  }
  return cudaErrorInvalidValue;
}

template <int D, int DV, int PQK, bool kFlags>
cudaError_t launch_split_typed(const TcFlashParams& p, void* kp, void* vp,
                               int bkv, int skv_pad, cudaStream_t stream) {
  using L = SplitPlan<D, DV, PQK>;
  cudaError_t err =
      stage_kv_any<PQK>(p, p.k, kp, D, bkv, skv_pad, L::BK, stream);
  if (err == cudaSuccess)
    err = stage_kv_any<2>(p, p.v, vp, DV, bkv, skv_pad, L::BK, stream);
  if (err != cudaSuccess) return err;
  // the staged pieces [P][bkv][skv_pad][W]: piece i of KV row r is the
  // third coordinate i * bkv + r; a box column past D reads as zero
  const uint64_t dk[3] = {(uint64_t)D, (uint64_t)skv_pad,
                          (uint64_t)PQK * bkv};
  const uint64_t dv[3] = {(uint64_t)DV, (uint64_t)skv_pad, 2ull * bkv};
  const uint32_t box[3] = {64u, (uint32_t)L::BK, 1u};
  CUtensorMap mk, mv;
  if (!tc_host::make_map(&mk, kp, true, 3, dk, box) ||
      !tc_host::make_map(&mv, vp, true, 3, dv, box))
    return cudaErrorInvalidValue;
  constexpr int smem = L::Smem;
  auto kern = flash_split_kernel<D, DV, PQK, kFlags>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  // setmaxnreg only moves registers inside the CTA's allocation
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * 256 < 128 * (kTcProducerRegs + tc_consumer_regs<1>()))
    return cudaErrorInvalidConfiguration;
  dim3 grid((p.sq + p.bq - 1) / p.bq, bkv);
  kern<<<grid, 256, smem, stream>>>(mk, mv, p);
  return cudaGetLastError();
}

template <int D, int DV, int PQK>
cudaError_t launch_split_flags(const TcFlashParams& p, void* kp, void* vp,
                               int bkv, int skv_pad, cudaStream_t stream) {
  return p.flags
             ? launch_split_typed<D, DV, PQK, true>(p, kp, vp, bkv, skv_pad, stream)
             : launch_split_typed<D, DV, PQK, false>(p, kp, vp, bkv, skv_pad, stream);
}

template <int PQK>
cudaError_t launch_split_dims(const TcFlashParams& p, void* kp, void* vp,
                              int bkv, int skv_pad, int d,
                              cudaStream_t stream) {
  if (d == 96) return launch_split_flags<96, 64, PQK>(p, kp, vp, bkv, skv_pad, stream);
  if (d == 192) return launch_split_flags<192, 128, PQK>(p, kp, vp, bkv, skv_pad, stream);
  switch (d) {
    case 64: return launch_split_flags<64, 64, PQK>(p, kp, vp, bkv, skv_pad, stream);
    case 128: return launch_split_flags<128, 128, PQK>(p, kp, vp, bkv, skv_pad, stream);
    default: return launch_split_flags<256, 256, PQK>(p, kp, vp, bkv, skv_pad, stream);
  }
}

}  // namespace

// The split route (f32 src, no grid or one wider than 16 bits): pieces of
// Q and K 3 (no grid) or 2 (a grid of <= 17 significant bits); the query
// tile is 64 rows over the group's heads; (d, dv) one of the tensor-core
// pairs; ``visits`` / ``flags`` as for flash_fma; kp / vp: the staging
// buffers of K's and V's pieces, [pieces, bkv, skv_pad, d] and [2, bkv,
// skv_pad, dv] bf16, skv_pad the keys a query can see rounded up to 64
// (``split_staged_keys``: the table's nk * page, and no more than
// q_offset + sq under the causal mask).
extern "C" int flash_attention_split_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* block_table, void* out, void* visits, void* flags,
    void* kp, void* vp, int n_steps, int bh, int group, int sq, int d,
    int dv, int nk, int page, int pool_rows, int q_offset, int causal,
    int window, int q_dtype, int kv_dtype, int src_kind, int snap_m,
    int snap_emax, int snap_emin, int pieces, int skv_pad, float scale,
    float softcap, void* stream) {
  const bool pair = (d == dv && (d == 64 || d == 128 || d == 256)) ||
                    (d == 96 && dv == 64) || (d == 192 && dv == 128);
  // the keys a query can see: the table, and under the causal mask no
  // more than q_offset + sq
  const long long table_keys = (long long)nk * page,
                  horizon = (long long)q_offset + sq;
  const long long seen =
      causal && horizon < table_keys ? (horizon > 0 ? horizon : 0)
                                     : table_keys;
  if (!pair || (pieces != 2 && pieces != 3) || group < 1 || group > 64 ||
      sq < 1 || bh % group || page < 1 || nk < 1 || !kp || !vp ||
      skv_pad % 64 || skv_pad < 64 || skv_pad < seen ||
      (q_dtype != DT_F32 && q_dtype != DT_BF16 && q_dtype != DT_F16) ||
      (visits == nullptr) != (flags == nullptr))
    return cudaErrorInvalidValue;
  TcFlashParams p{};  // kv_tma, seg_rows: none, the pieces go by TMA whole
  p.q = q; p.k = k; p.v = v;
  p.kv_len = static_cast<const int*>(kv_len);
  p.block_table = static_cast<const int*>(block_table);
  p.out = static_cast<float*>(out);
  p.visits = static_cast<int*>(visits);
  p.flags = static_cast<int*>(flags);
  p.n_steps = n_steps;
  p.group = group; p.bq = 64 / group; p.sq = sq; p.nk = nk;
  p.page = page; p.pool_rows = pool_rows; p.q_offset = q_offset;
  p.causal = causal; p.window = window;
  p.q_dtype = q_dtype; p.kv_dtype = kv_dtype; p.src_kind = src_kind;
  p.snap = Snap{snap_m, snap_emax, snap_emin};
  p.scale = scale; p.softcap = softcap;
  p.two_over_cap = softcap > 0.f ? 2.f / softcap : 0.f;
  const int bkv = bh / group;
  if (bkv > 65535 || (long long)pieces * bkv > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pieces == 3 ? launch_split_dims<3>(p, kp, vp, bkv, skv_pad, d, s)
                     : launch_split_dims<2>(p, kp, vp, bkv, skv_pad, d, s);
}
