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
// What bounds it: operations.  A 32-row query tile against a key tile does
// 2 * 32 * 32 * D flops per 2 * 32 * D * 2 bytes of K/V — at a 4096-token
// prompt the kernel is far above the card's ridge.  Design: one CTA per
// (head row, 32-query tile); it computes its own key range from causal /
// window / q_offset (the pruning ``block_schedule`` does on the host) and
// stops at kv_len; K/V tiles are read through the block table into shared
// memory as f32 with 16-byte loads, eight in flight per thread
// (``load_rows``), and all products are f32 FMAs.  This first version does
// not use the tensor cores (wgmma): that, and a larger query tile, are the
// next steps.
#include <cuda_runtime.h>

#include "quant_common.cuh"

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

  for (int k0 = k_start; k0 < k_end; k0 += kBK) {
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

extern "C" int flash_attention_launch(
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
