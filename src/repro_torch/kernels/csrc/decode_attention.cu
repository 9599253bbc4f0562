// Single-query GQA decode attention over a paged (or contiguous) KV cache,
// split over the CTAs of a thread-block cluster, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// ``decode_attention_pallas`` (body ``_decode_kernel``).
//
// Contract (same as the TPU kernel): q [BHkv, G, D] against the row's keys
// j < kv_len[row] (and j > kv_len - 1 - window); scores are src-dtype
// products summed in f32, scaled, exp-form soft-capped; an EXACT max over
// all live keys first, then exp(s - max) and p.V summed in f32, with p
// rounded to the src dtype before the product and l summed from the
// unrounded p; rows with kv_len == 0 store zeros.  K/V are widened
// in-kernel from their storage dtype (bf16 / fp16 / fp8 e5m2 exactly, or an
// f32 container RNE-snapped onto the kv format's grid); q is f32, bf16 or
// fp16; D <= 256 and any G with ceil(G / 8) D <= 1024 (G <= 64 at D 128,
// G <= 32 at D 256: the 32 f32 accumulators a thread hold the output's
// head tiles), in the shared memory a block can use.  A page id outside
// the pool traps.
//
// What bounds it: bytes.  A decode step reads each live K and V element
// once and does 4 G flops per element pair, far below the card's ~295
// flops/byte ridge, so the design is about keeping all SMs streaming:
//
//   * Split-KV over a cluster.  Each (slot, KV head) row is one cluster of
//     C CTAs (C from ``decode_attention.cluster_size``: up to 16, the
//     non-portable size, so that a small grid still fills the card).  The
//     row's live range [lo, kv_len) is cut into C parts on page boundaries
//     (``split_of``; ``decode_attention.plan_splits`` is its host twin), one
//     per rank.  Pass 1: each rank scores its keys and keeps its local max.
//     Each rank writes its maxima into every rank's shared memory
//     (distributed shared memory), so every rank holds the EXACT row max
//     and rounds p against the same m as the TPU kernel: the split costs no
//     ulp of p, unlike an online-softmax split.  Pass 2: each rank sums l
//     and p.V over its keys; then rank r adds outputs [r n / C, (r + 1) n /
//     C) of the partials of ranks 0, 1, ..., C - 1, in that order, through
//     distributed shared memory.  One launch, no atomics, no combine
//     kernel; the result is the same from run to run.  Every rank reaches
//     every cluster barrier, keys or not.  Distributed shared memory may
//     be touched only once every CTA of the cluster has started: each rank
//     arrives on the cluster barrier (relaxed) right after its set-up and
//     waits on it just before it writes its maxima, so the wait overlaps
//     pass 1; a rank with no keys would otherwise write into a CTA not yet
//     started, which then reads a stale max.
//   * Loads kept in flight.  The rank's page ids are read into shared
//     memory once; K (pass 1) and V (pass 2) move in their storage dtype as
//     64-key tiles (aligned to multiples of 64 keys) through a 3-stage ring
//     with full / empty mbarriers per slot: warp 0 also produces (it
//     refills a slot once all eight warps have released it), so two tiles
//     are in flight while one is used and no barrier spans the block; the
//     first V tiles are issued before the max exchange.  A tile arrives as
//     TMA boxes of 128 bytes x (64 keys, or one page of 8..32) from the flat
//     pool seen as bytes [pages, page, row_bytes], 128-byte swizzled, which
//     keeps the ldmatrix reads and the FMA route's 16-byte reads free of
//     bank conflicts.  Few large copies matter: on the H100, one bulk copy
//     per key row (512 bytes) held each CTA's stream to a fraction of the
//     rate of a few boxes per tile.  Shapes TMA cannot take (rows not
//     whole 128-byte units, pages that neither divide nor are multiples of
//     64) are copied by warp 0 into the same layout.  Widening (FPnew's
//     CONV) happens in registers at the multiplier input.
//   * Arithmetic off the critical path.  Route ``MMA`` (src bf16 / fp16, D a
//     multiple of 16: the operands as multiplied are exact 16-bit values)
//     runs both products on mma.sync.m16n8k16 with f32 accumulators and
//     the heads, 8 at a time (a head tile), as the 8 columns (wgmma's
//     64-row minimum would waste 62 of 64 rows at G = 2): S^T = K Q^T with
//     16 keys as rows, each warp a quarter of the tile's keys and half of D
//     (its partner warp adds the other half in a fixed order), head tile
//     after head tile over the same K tile in shared memory; and O^T = V^T
//     P^T with 16 d as rows: the (head tile, 16-d block) output tiles are
//     dealt to the warps, at most 8 a warp in registers, and the keys of
//     each V tile split into 4, 2 or 1 groups, as many as the tiles allow
//     (4 for G <= 16 at D 128, 1 at G 48); the groups' sums are added in
//     order at the end.  G > 8 loops over n8 column tiles rather than
//     putting Q in the A operand (48 heads as 3 m16 tiles): the K and V
//     tiles stay the A operand, read once from the ring for all heads, and
//     G <= 8 keeps its arithmetic (one head tile).  Fragments of
//     16-bit pools come by ldmatrix (transposed for V); other pools widen
//     element pairs.  Each lane forms the p it multiplies itself (no block
//     barrier per tile).  Route ``FMA`` (f32 src, other D): f32 FMAs, a
//     key per thread over a quarter of D for each head tile, the four
//     partial sums added in a fixed order through shared memory (no
//     per-key shuffle tree); p.V a (head tile, column d) unit per thread,
//     up to 4 units.
//
// The G scores of each key wait between the passes in a global scratch
// strip (4 G bytes per key against 512 bytes of K/V at granite's D 128 and
// G 48: 3.2 MB for 4 rows of 4112 keys, 6.3 MB at 8192 keys, L2-resident
// within the 50 MB).  A key outside the rank's range in a loaded tile has
// p = 0 and its V fragment is masked to 0, so 0 x stale data never makes a
// NaN.  The kernel parameters are
// __grid_constant__: a by-value parameter read through a reference is
// copied to local memory, which cost every access a local load.
//
// Telemetry (the TPU kernel's ``debug_visits`` / ``debug_flags``) is a
// compile-time instantiation (``kFlags``) of the same kernel: the flags-off
// instantiation keeps its instruction stream, and the passes above run
// unchanged in the flags-on one, so the output is bitwise the same.  After
// the last cluster barrier each rank marks the units it worked (cells of a
// page, or of 64 keys for a strip) and counts OF / UF / NX / NV over whole
// units of the row's live keys, units r, r + C, ... for rank r, by a
// count-only read (the keys left of a window included: the TPU kernel
// counts every live key, this kernel reads only the window's); each warp
// adds its counts into the cell with one atomic per nonzero channel, q's
// flags go to cell 0.  The read is an extra pass over the row's K and V.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "quant_common.cuh"
#include "tc_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadTile = 8;  // heads per mma column tile / FMA head tile
constexpr int kAccTiles = 8;  // pass 2: f32 accumulator tiles (of 4) a thread
constexpr int kMaxD = 256;
// ceil(G / 8) D at most: the output's head tiles x columns spread over the
// threads' kAccTiles x 4 accumulators (32 x 256 = 8 x 1024)
constexpr int kMaxTileCols = 1024;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use
constexpr int kTile = 64;    // keys per ring slot
constexpr int kStages = 3;   // ring slots
constexpr int kParts = kThreads / kTile;  // FMA route: D split per key
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
constexpr float kNegInf = -1e30f;

// route codes shared with decode_attention.py
enum Route { ROUTE_FMA = 0, ROUTE_MMA_BF16 = 1, ROUTE_MMA_F16 = 2 };

struct DecodeParams {
  const void* q;           // [BH, G, D] in q_dtype
  const int* kv_len;       // [BH]
  const int* block_table;  // [BH, nk] flat page ids, or null (contiguous)
  float* out;              // [BH, G, D]
  float* scores;           // [BH, G, smax] scratch
  int* visits;             // [BH, nk] telemetry (zeroed), or null
  int* flags;              // [BH, nk, 4] telemetry (zeroed), or null
  int g, d, nk, unit, pool_rows, smax, q_dtype, src_kind;
  int ngt;                 // head tiles of 8: ceil(G / 8)
  int mma;                 // 1: route MMA
  int kq;                  // route MMA: key groups of pass 2 (4, 2 or 1)
  int cluster;             // CTAs per row
  int max_units;           // page-id slots per CTA
  int row_bytes;           // bytes of one key row in the pool
  int nch;                 // 128-byte chunks of a row in a ring slot
  int tma;                 // 1: tiles arrive by TMA (else thread copies)
  Snap kv_snap, q_snap;
  float scale;
  int window;              // < 0: none
  float softcap;           // <= 0: none
  float two_over_cap;
};

// Shared-memory layout (byte offsets), the same on host and device.
__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }
struct Layout {
  int ring, bar, qs, qf, work, pid, wmax, mloc, mall, mrow, total;
  __host__ __device__ Layout(const DecodeParams& p) {
    ring = 0;
    // the ring, which also holds the partials at the end: [G][D] p.V and
    // [G] l, then (MMA) the key groups' [kq][G][D] and [kq][G] that they
    // are added from
    const int parts = 4 * (p.mma ? p.kq + 1 : 1) * (p.g * p.d + p.g);
    const int ring_bytes = kStages * kTile * 128 * p.nch;
    bar = align16(ring_bytes > parts ? ring_bytes : parts);
    qs = bar + 16 * kStages;  // full [kStages], then empty [kStages]
    qf = qs + (p.mma ? 0 : align16(4 * p.g * p.d));
    work = qf + (p.mma ? 8 * 32 * (p.d / 16) * p.ngt : 0);
    // FMA: [kParts][8][kTile] partial scores, then [G][kTile] p and
    // [G][kTile] l slots; MMA: [2][4][32][4] pass-1 hand-over sums
    const int fma_work = 4 * (kParts * kHeadTile > 2 * p.g
                                  ? kParts * kHeadTile : 2 * p.g) * kTile;
    pid = work + (p.mma ? 4 * 1024 : fma_work);
    wmax = pid + 4 * (p.max_units > 0 ? p.max_units : 1);
    mloc = wmax + 4 * kWarps * p.g;
    mall = mloc + 4 * p.g;
    mrow = mall + 4 * kMaxCluster * p.g;
    total = mrow + 4 * kHeadTile * p.ngt;
  }
};

// The keys [lo, hi) and pages [u0, u1) of rank ``rank`` of a row: the live
// range cut into ``cluster`` runs of whole units (pages; 64 keys for a
// contiguous strip), rank r taking units [n r / C, n (r + 1) / C).
struct Split {
  int lo, hi, u0, u1;
};
__device__ __forceinline__ Split split_of(const DecodeParams& p, int kvl,
                                          int rank) {
  const int start = p.window >= 0 ? max(0, kvl - p.window) : 0;
  if (kvl <= start) return Split{0, 0, 0, 0};
  const int first = start / p.unit;
  const long long n = (kvl - 1) / p.unit - first + 1;
  Split s;
  s.u0 = first + (int)(n * rank / p.cluster);
  s.u1 = first + (int)(n * (rank + 1) / p.cluster);
  s.lo = max(start, s.u0 * p.unit);
  s.hi = min(kvl, s.u1 * p.unit);
  return s;
}

// Byte offset of key j of this row in the (flat) pool.
__device__ __forceinline__ long long key_bytes(const DecodeParams& p,
                                               const int* pid, int row,
                                               int u0, int j) {
  if (!p.block_table) return ((long long)row * p.smax + j) * p.row_bytes;
  const int u = j / p.unit;
  return ((long long)pid[u - u0] * p.unit + (j - u * p.unit)) * p.row_bytes;
}

// Byte offset of byte ``b`` of key row ``r`` in a ring slot: ``nch``
// chunks of [kTile rows][128 bytes], each row's 16-byte units XOR-ed with
// r % 8 (TMA's 128-byte swizzle; slots are 1024-byte aligned).
__device__ __forceinline__ int swz(int r, int b) {
  return (b >> 7) * (kTile * 128) + r * 128 + ((((b >> 4) & 7) ^ (r & 7)) << 4) +
         (b & 15);
}

// Load tile t (keys [64 t, 64 t + 64)) of this row into a ring slot and
// complete one phase of ``bar`` when it has landed; called by warp 0.  TMA
// (``p.tma``): lane 0 sets the byte count, the lanes issue one box per
// 128-byte chunk and page segment; only pages of this rank's units are
// read, so rows outside its keys may hold stale or foreign data.
// Otherwise the lanes copy the live rows [rlo, rhi) and lane 0 completes
// the phase.
__device__ __noinline__ void issue_tile(
    unsigned char* slot, uint64_t* bar, const CUtensorMap* map,
    const unsigned char* pool, const DecodeParams& p, const int* pid, int row,
    int u0, int u1, int t, int rlo, int rhi) {
  const int tid = threadIdx.x;
  const int j0 = t * kTile;
  if (p.tma) {
    // page segments of the tile: one (a page of >= 64 keys, or a strip),
    // or kTile / page whole pages
    const bool small = p.block_table && p.unit < kTile;
    const int nseg = small ? kTile / p.unit : 1;
    const int rows = small ? p.unit : kTile;
    auto page_of = [&](int s) { return small ? j0 / p.unit + s : j0 / p.unit; };
    auto valid = [&](int s) {
      const int pg = page_of(s);
      return !p.block_table || (pg >= u0 && pg < u1);
    };
    if (tid == 0) {
      int nv = 0;
      for (int s = 0; s < nseg; ++s) nv += valid(s);
      tc::mbar_arrive_expect_tx(bar, (uint32_t)(nv * p.nch * 128 * rows));
    }
    __syncwarp();
    for (int i = tid; i < nseg * p.nch; i += 32) {
      const int sg = i / p.nch, c = i - sg * p.nch;
      if (!valid(sg)) continue;
      unsigned char* dst = slot + c * (kTile * 128) + sg * rows * 128;
      if (!p.block_table)
        tc::tma_load_3d(dst, map, bar, c * 128, j0, row);
      else
        tc::tma_load_3d(dst, map, bar, c * 128, small ? 0 : j0 % p.unit,
                        pid[page_of(sg) - u0]);
    }
    return;
  }
  const int total = (rhi - rlo) * p.row_bytes;
  for (int i = tid; i < total; i += 32) {
    const int r = rlo + i / p.row_bytes, b = i % p.row_bytes;
    slot[swz(r, b)] = pool[key_bytes(p, pid, row, u0, j0 + r) + b];
  }
  __syncwarp();
  if (tid == 0) tc::mbar_arrive(bar);
}

// ---------------------------------------------------------------------------
// 16-bit tile values and mma.sync.m16n8k16 (f32 accumulators).  Fragment of
// lane (gid = lane / 4, tig = lane % 4): A a0 = (row gid, k 2 tig .. +1),
// a1 = (row gid + 8, same k), a2 = (row gid, k 2 tig + 8 .. +9), a3 = (row
// gid + 8, ..); B b0 = (k 2 tig .. +1, col gid), b1 = (k 2 tig + 8 .. +9,
// col gid); C c0, c1 = (row gid, col 2 tig .. +1), c2, c3 = (row gid + 8, ..).
// The lower half of a 32-bit register holds the lower index.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ uint32_t raw16(const T* e) {
  return *reinterpret_cast<const uint16_t*>(e);
}

// Two consecutive elements e[0], e[1] as a tile pair.
template <typename KT, typename TT>
__device__ __forceinline__ uint32_t pair_contig(const KT* e,
                                                const DecodeParams& p) {
  if constexpr (std::is_same<KT, TT>::value)
    return *reinterpret_cast<const uint32_t*>(e);
  else
    return tc::pack2<TT>(widen(e[0], p.kv_snap, p.src_kind),
                     widen(e[1], p.kv_snap, p.src_kind));
}
// Elements a[0] (key j) and b[0] (key j + 1) as a tile pair.
template <typename KT, typename TT>
__device__ __forceinline__ uint32_t pair_rows(const KT* a, const KT* b,
                                              const DecodeParams& p) {
  if constexpr (std::is_same<KT, TT>::value)
    return raw16(a) | (raw16(b) << 16);
  else
    return tc::pack2<TT>(widen(a[0], p.kv_snap, p.src_kind),
                     widen(b[0], p.kv_snap, p.src_kind));
}

// mma.sync.m16n8k16, bf16 or fp16 operands, f32 accumulators.
template <typename TT>
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<TT, __nv_bfloat16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 16-bit matrices from shared memory (lanes 8 i .. 8 i + 7 give
// the row addresses of matrix i), as mma fragments; ``.trans`` transposes.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_u32(a)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tc::smem_u32(a)));
}

__device__ __forceinline__ float load_q(const DecodeParams& p, long long i) {
  switch (p.q_dtype) {
    case DT_BF16:
      return widen(static_cast<const __nv_bfloat16*>(p.q)[i], p.q_snap,
                   p.src_kind);
    case DT_F16:
      return widen(static_cast<const __half*>(p.q)[i], p.q_snap, p.src_kind);
    default:
      return widen(static_cast<const float*>(p.q)[i], p.q_snap, p.src_kind);
  }
}

__device__ __forceinline__ float cap_score(const DecodeParams& p, float a) {
  float s = a * p.scale;
  if (p.softcap > 0.f) {
    const float e = expf(s * p.two_over_cap);
    s = p.softcap * (1.f - 2.f / (e + 1.f));
  }
  return s;
}

// The cluster barrier in halves: arrive (relaxed, it orders no memory
// access) and wait.  Every thread of every CTA runs both.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Route MMA, pass 1: lane (gid, tig) holds maxima m0, m1 of heads g0 + 2
// tig and g0 + 2 tig + 1 over its keys; the warp's maxima over all its
// keys go into its row ``wrow`` of ``wmax`` (max with what is there).
__device__ __forceinline__ void fold_mma_max(float* wrow, int g0, int G,
                                             float m0, float m1) {
  const int tig = threadIdx.x & 3, gid = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  const int g = g0 + 2 * tig;
  if (gid == 0 && g < G) wrow[g] = fmaxf(wrow[g], m0);
  if (gid == 0 && g + 1 < G) wrow[g + 1] = fmaxf(wrow[g + 1], m1);
}

template <typename KT, int kRoute, bool kFlags, bool kOne>
__global__ void __launch_bounds__(kThreads, 2)
decode_cluster_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const KT* __restrict__ k, const KT* __restrict__ v,
                      const __grid_constant__ DecodeParams p) {
  constexpr bool kMma = kRoute != ROUTE_FMA;
  using TT = typename std::conditional<kRoute == ROUTE_MMA_BF16,
                                       __nv_bfloat16, __half>::type;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout L(p);
  unsigned char* ring = smem + L.ring;
  float* qs = reinterpret_cast<float*>(smem + L.qs);     // [G][D] widened q
  // route MMA: q's B fragments, [head tile][k16 step][lane] (head gid of
  // the tile, d 2 tig ..)
  uint2* qf = reinterpret_cast<uint2*>(smem + L.qf);
  float* work = reinterpret_cast<float*>(smem + L.work); // p tile / partials
  int* pid = reinterpret_cast<int*>(smem + L.pid);       // the split's pages
  // full[s]: tile landed in slot s; empty[s]: every warp is done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + kStages;
  constexpr int S = kStages;
  float* wmax = reinterpret_cast<float*>(smem + L.wmax); // [kWarps][G]
  float* mloc = reinterpret_cast<float*>(smem + L.mloc); // [G] this rank
  float* mall = reinterpret_cast<float*>(smem + L.mall); // [C][G] all ranks
  float* mrow = reinterpret_cast<float*>(smem + L.mrow); // [ngt * 8] the row

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / p.cluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // kOne: one head tile (G <= 8), a separate instantiation in which the
  // head-tile loops and the multi-tile paths fold away
  const int G = p.g, D = p.d, ngt = kOne ? 1 : p.ngt;
  const int kvl = min(p.kv_len[row], p.smax);
  const Split sp = split_of(p, kvl, rank);
  // tiles t0 .. t0 + ntiles - 1 of 64 keys hold the rank's keys [lo, hi)
  const int t0 = sp.lo / kTile;
  const int ntiles = sp.hi > sp.lo ? (sp.hi - 1) / kTile - t0 + 1 : 0;
  const int slot_bytes = kTile * 128 * p.nch;
  // The G scores of each of the rank's keys, between the passes, in the
  // row's global scratch strip (4 G bytes per key, L2-resident).
  float* const sbase = p.scores + (long long)row * G * p.smax;
  auto score = [&](int g, int j) -> float& {
    return sbase[(long long)g * p.smax + j];
  };
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);

  if (p.block_table && ntiles) {
    for (int i = tid; i < sp.u1 - sp.u0; i += kThreads) {
      const int id = p.block_table[(long long)row * p.nk + sp.u0 + i];
      if (id < 0 || id >= p.pool_rows) __trap();  // page id outside the pool
      pid[i] = id;
    }
  }
  const int nks = D / 16;  // route MMA: k16 steps over D
  if constexpr (!kMma) {
    for (int i = tid; i < G * D; i += kThreads)
      qs[i] = load_q(p, (long long)row * G * D + i);
  } else {
    for (int i = tid; i < ngt * nks * 32; i += kThreads) {
      const int nt = i / (nks * 32), ks = (i / 32) % nks;
      const int g = nt * kHeadTile + ((i % 32) >> 2), tg = i & 3;
      uint2 f = make_uint2(0u, 0u);
      if (g < G) {
        const long long b = ((long long)row * G + g) * D + ks * 16 + 2 * tg;
        f.x = tc::pack2<TT>(load_q(p, b), load_q(p, b + 1));
        f.y = tc::pack2<TT>(load_q(p, b + 8), load_q(p, b + 9));
      }
      qf[i] = f;
    }
  }
  for (int i = tid; i < kWarps * G; i += kThreads) wmax[i] = kNegInf;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      tc::mbar_init(full + s, 1);
      tc::mbar_init(empty + s, kWarps);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();
  cluster_arrive_relaxed();  // this CTA has started (waited on before DSMEM)

  // Tile i of a pass is ring use u = base + i (base 0 for K, ntiles for
  // V): slot u % S, phase parity (u / S) & 1.  Its live rows
  // are [rlo(i), rhi(i)).  Warp 0 also produces: before it uses tile i it
  // refills the slot of tile i - 1 once every warp has released that, so
  // S - 1 tiles stay in flight and no barrier spans the block.
  auto rlo = [&](int i) { return max(sp.lo - (t0 + i) * kTile, 0); };
  auto rhi = [&](int i) { return min(sp.hi - (t0 + i) * kTile, kTile); };
  auto issue = [&](int base, int i, bool is_v) {  // warp 0
    const int u = base + i, sl = u % S;
    if (u >= S) tc::mbar_wait(empty + sl, (uint32_t)(((u / S) + 1) & 1));
    issue_tile(ring + sl * slot_bytes, full + sl, is_v ? &vmap : &kmap,
               is_v ? vb : kb, p, pid, row, sp.u0, sp.u1, t0 + i, rlo(i),
               rhi(i));
  };
  auto prologue = [&](int base, bool is_v) {
    if (warp == 0)
      for (int i = 0; i < S - 1 && i < ntiles; ++i) issue(base, i, is_v);
  };
  auto next = [&](int base, int i, bool is_v) {
    const int u = base + i;
    if (warp == 0 && i + S - 1 < ntiles) issue(base, i + S - 1, is_v);
    tc::mbar_wait(full + u % S, (uint32_t)((u / S) & 1));
    return ring + (u % S) * slot_bytes;
  };
  auto release = [&](int base, int i) {
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(empty + (base + i) % S);
  };

  // ---- pass 1: every key's G scores (stored) and this rank's max --------
  // route MMA on 16-bit pools of the tile type: fragments by ldmatrix
  constexpr bool kLdsm = std::is_same<KT, TT>::value;
  // With one head tile (kOne) each thread keeps its two running maxima in
  // registers and folds them into ``wmax`` once, after the pass; with
  // more, each (tile, head tile) folds its maxima at once.
  float lmax0 = kNegInf, lmax1 = kNegInf;
  prologue(0, false);
  for (int i = 0; i < ntiles; ++i) {
    const unsigned char* slot = next(0, i, false);
    const int j0 = (t0 + i) * kTile, lo = rlo(i), hi = rhi(i);
    if constexpr (kMma) {
      // S^T [key][head] = K [key][d] Q^T [d][head], mma m16n8k16 with the
      // keys the rows and a head tile's 8 heads the columns, head tile by
      // head tile on the same K tile.  Warp w takes keys 16 mq .. 16 mq +
      // 15 (mq = w % 4) over half dh = w / 4 of the k16 steps of D, in two
      // accumulator chains (even and odd steps); warp w + 4 hands its sums
      // to warp w through shared memory (double buffered by head tile),
      // which adds them in a fixed order, stores the scores and folds
      // their max into its row of ``wmax``.
      const int mq = warp & 3, dh = warp >> 2, half = (nks + 1) / 2;
      const int ks0 = dh * half, ks1 = min(nks, ks0 + half);
      const bool any = mq * 16 + 16 > lo && mq * 16 < hi;
      // the A fragment (16 keys x 16 d) of k16 step ks
      auto frag = [&](int ks, uint32_t (&a)[4]) {
        if constexpr (kLdsm) {
          // matrices (keys 0-7 | 8-15) x (d 0-7 | 8-15): lane 8 i + x
          // points at key x + 8 (i % 2), d 8 (i / 2)
          ldsm_x4(a, slot + swz(mq * 16 + (lane & 7) + 8 * ((lane >> 3) & 1),
                                (ks * 16 + 8 * (lane >> 4)) * 2));
        } else {
          auto at = [&](int r, int dd) {
            return reinterpret_cast<const KT*>(slot + swz(r, dd * (int)sizeof(KT)));
          };
          const int r = mq * 16 + gid, dd = ks * 16 + 2 * tig;
          a[0] = pair_contig<KT, TT>(at(r, dd), p);
          a[1] = pair_contig<KT, TT>(at(r + 8, dd), p);
          a[2] = pair_contig<KT, TT>(at(r, dd + 8), p);
          a[3] = pair_contig<KT, TT>(at(r + 8, dd + 8), p);
        }
      };
#pragma unroll 1
      for (int nt = 0; nt < ngt; ++nt) {
        float c[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
        const uint2* qt = qf + nt * nks * 32;
        if (any) {
          // a rolled loop over step pairs: the kernel's code must stay
          // small enough for the SM's instruction cache
#pragma unroll 1
          for (int ks = ks0; ks < ks1; ks += 2) {
            uint32_t a[4], a2[4];
            frag(ks, a);
            const uint2 qb = qt[ks * 32 + lane];
            mma16816<TT>(c, a[0], a[1], a[2], a[3], qb.x, qb.y);
            if (ks + 1 < ks1) {
              frag(ks + 1, a2);
              const uint2 qb2 = qt[(ks + 1) * 32 + lane];
              mma16816<TT>(c2, a2[0], a2[1], a2[2], a2[3], qb2.x, qb2.y);
            }
          }
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) c[x] += c2[x];
        // [2][4][32 lanes][4], by the parity of the (tile, head tile) step
        float* xs = work + (((i * ngt + nt) & 1) * 4 + mq) * 128;
        if (dh == 1) {
#pragma unroll
          for (int x = 0; x < 4; ++x) xs[lane * 4 + x] = c[x];
        }
        tc::named_sync(1 + mq, 64);
        if (dh == 0 && any) {
          // the four caps first (independent, no branches), then the stores
          float sv[4], m0 = kNegInf, m1 = kNegInf;
#pragma unroll
          for (int x = 0; x < 4; ++x) sv[x] = cap_score(p, c[x] + xs[lane * 4 + x]);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int g = nt * kHeadTile + 2 * tig + (x & 1),
                      j = mq * 16 + gid + (x >> 1) * 8;
            if (g < G && j >= lo && j < hi) {
              score(g, j0 + j) = sv[x];
              if (x & 1) m1 = fmaxf(m1, sv[x]);
              else m0 = fmaxf(m0, sv[x]);
            }
          }
          if constexpr (kOne) {
            lmax0 = fmaxf(lmax0, m0);
            lmax1 = fmaxf(lmax1, m1);
          } else {
            fold_mma_max(wmax + warp * G, nt * kHeadTile, G, m0, m1);
          }
        }
      }
    } else {
      // thread (key jj, quarter part) sums its part of D for the 8 heads of
      // a head tile; the four parts are then added in a fixed order
      const int jj = tid % kTile, part = tid / kTile;
#pragma unroll 1
      for (int nt = 0; nt < ngt; ++nt) {
        const int gn = min(kHeadTile, G - nt * kHeadTile);
        const float* qt = qs + nt * kHeadTile * D;
        float acc[kHeadTile];
#pragma unroll
        for (int g = 0; g < kHeadTile; ++g) acc[g] = 0.f;
        if (jj >= lo && jj < hi) {
          constexpr int kEpv = 16 / sizeof(KT);
          const int nvec = (D + kEpv - 1) / kEpv;
          for (int vv = part; vv < nvec; vv += kParts) {
            const uint4 raw =
                *reinterpret_cast<const uint4*>(slot + swz(jj, vv * 16));
            const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
            for (int x = 0; x < kEpv; ++x) {
              const int dd = vv * kEpv + x;
              if (dd < D) {
                const float kv = widen(e[x], p.kv_snap, p.src_kind);
#pragma unroll
                for (int g = 0; g < kHeadTile; ++g)
                  if (g < gn) acc[g] += qt[g * D + dd] * kv;
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kHeadTile; ++g)
          if (g < gn) work[(part * kHeadTile + g) * kTile + jj] = acc[g];
        __syncthreads();
        // thread (head g, key j): the warp shares g, so it folds the max of
        // its 32 keys into its row of ``wmax``
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = tid + h * kThreads, g = idx / kTile, j = idx % kTile;
          float s = kNegInf;
          if (g < gn && j >= lo && j < hi) {
            float a = work[g * kTile + j];
            for (int q = 1; q < kParts; ++q)
              a += work[(q * kHeadTile + g) * kTile + j];
            s = cap_score(p, a);
            score(nt * kHeadTile + g, j0 + j) = s;
          }
          if constexpr (kOne) {
            if (h == 0) lmax0 = fmaxf(lmax0, s);
            else lmax1 = fmaxf(lmax1, s);
          } else {
            s = warp_max(s);
            if (lane == 0 && g < gn) {
              float* w = wmax + warp * G + nt * kHeadTile + g;
              *w = fmaxf(*w, s);
            }
          }
        }
        __syncthreads();  // ``work`` is reused by the next head tile
      }
    }
    release(0, i);
  }
  if constexpr (kOne) {
    if constexpr (kMma) {
      fold_mma_max(wmax + warp * G, 0, G, lmax0, lmax1);
    } else {
      // warp w holds head w / 2 (h 0) and w / 2 + 4 (h 1)
      lmax0 = warp_max(lmax0);
      lmax1 = warp_max(lmax1);
      if (lane == 0 && warp / 2 < G) wmax[warp * G + warp / 2] = lmax0;
      if (lane == 0 && warp / 2 + 4 < G) wmax[warp * G + warp / 2 + 4] = lmax1;
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wmax[w * G + g]);
    mloc[g] = m;
  }
  // FMA: the per-(head, key slot) running sums of l, [G][kTile]
  float* pr = work;                   // FMA: [G][kTile] p, rounded to src
  float* lacc = work + G * kTile;
  if constexpr (!kMma) {
    for (int x = tid; x < G * kTile; x += kThreads) lacc[x] = 0.f;
  }
  __syncthreads();  // the ring is idle: start on V before the exchange
  prologue(ntiles, true);

  // ---- the exact row max: each rank writes its maxima into every rank's
  // table, then reads its own ----------------------------------------------
  cluster_wait();  // every CTA of the cluster has started
  for (int x = tid; x < p.cluster * G; x += kThreads) {
    const int r = x / G, g = x % G;
    *cluster.map_shared_rank(mall + rank * G + g, r) = mloc[g];
  }
  cluster.sync();
  for (int g = tid; g < ngt * kHeadTile; g += kThreads) {
    float m = kNegInf;
    if (g < G)
      for (int r = 0; r < p.cluster; ++r) m = fmaxf(m, mall[r * G + g]);
    mrow[g] = (m <= kNegInf / 2) ? 0.f : m;
  }
  __syncthreads();

  // ---- pass 2: l and p.V over this rank's keys ---------------------------
  // MMA: acc[t] is the warp's t-th output tile; FMA: acc[2 s + g / 4][g % 4]
  // is head g of the s-th (head tile, column d) unit
  float acc[kAccTiles][4];
#pragma unroll
  for (int a = 0; a < kAccTiles; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  float lsum[kAccTiles];
#pragma unroll
  for (int a = 0; a < kAccTiles; ++a) lsum[a] = 0.f;
  // Route MMA: O^T [d][head] += V^T [d][keys] P^T [keys][head], mma m16n8k16
  // with d the rows, the keys the k16 step and a head tile's 8 heads the
  // columns.  The output tiles (head tile nt, m-block mb of 16 d), u = nt
  // nmb + mb, are dealt to the warps: the warps form p.kq key groups (warp
  // w: keys of group kq = w % kq of each tile, its nks2 = 4 / kq k16 steps)
  // and each group's warps take runs of upw consecutive tiles (at most
  // kAccTiles).  For each k16 step, lane (gid, tig) forms p for head gid of
  // a head tile and keys kb + 2 tig + {0, 1, 8, 9} from the tile's scores
  // (the first of each tile loaded one tile ahead; a dead key's score is
  // -inf, so its p is 0) once per head tile it meets, and the warp holding
  // the tile's m-block 0 keeps its l.  The key groups' sums are added in
  // group order at the end.
  const int nmb = D / 16, nunits = ngt * nmb;
  const int KQ = p.kq, nks2 = 4 / KQ, kq = warp % KQ;
  const int wpg = kWarps / KQ, upw = (nunits + wpg - 1) / wpg;
  const int u0 = (warp / KQ) * upw, u1 = min(nunits, u0 + upw);
  const int kb0 = kq * nks2 * 16, nt0 = u0 / max(nmb, 1),
            mb0 = u0 - nt0 * nmb;
  const bool one_nt = kOne || (u1 > u0 && (u1 - 1) / max(nmb, 1) == nt0);
  float sc[4];
  auto load_scores = [&](int i, int kb, int h, float (&o)[4]) {
    const int j0 = (t0 + i) * kTile, lo = rlo(i), hi = rhi(i);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = kb + 2 * tig + (x & 1) + (x >> 1) * 8;
      o[x] = (h < G && j >= lo && j < hi) ? score(h, j0 + j) : -INFINITY;
    }
  };
  // the row max of the warp's first head tile, held for the pass
  const float mg0 = kMma && u0 < u1 ? mrow[nt0 * kHeadTile + gid] : 0.f;
  if (kMma && ntiles > 0 && u0 < u1)
    load_scores(0, kb0, nt0 * kHeadTile + gid, sc);
  for (int i = 0; i < ntiles; ++i) {
    const unsigned char* slot = next(ntiles, i, true);
    const int j0 = (t0 + i) * kTile, lo = rlo(i), hi = rhi(i);
    if constexpr (kMma) {
      float pre[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) pre[x] = sc[x];
      if (i + 1 < ntiles && u0 < u1)
        load_scores(i + 1, kb0, nt0 * kHeadTile + gid, sc);
#pragma unroll 1
      for (int s = 0; s < nks2 && u0 < u1; ++s) {
        const int kb = kb0 + s * 16;
        if (!(kb + 16 > lo && kb < hi)) continue;
        const int j = kb + 2 * tig;
        // V of keys outside [lo, hi) (stale rows) is zeroed in the
        // fragments: p = 0 there, and 0 x (Inf or NaN) would be NaN
        auto live = [&](int r) { return r >= lo && r < hi ? 0xffffu : 0u; };
        const uint32_t mask0 = live(j) | (live(j + 1) << 16),
                       mask8 = live(j + 8) | (live(j + 9) << 16);
        // p for head nt g + gid at this step's keys as the B fragment
        // (b0, b1); ``keep_l``: add the unrounded p into ``ls``
        auto form = [&](int nt, bool first, bool keep_l, float& ls,
                        uint32_t& b0, uint32_t& b1) {
          float e[4];
          if (first) {
#pragma unroll
            for (int x = 0; x < 4; ++x) e[x] = pre[x];
          } else {
            load_scores(i, kb, nt * kHeadTile + gid, e);
          }
          const float mg = nt == nt0 ? mg0 : mrow[nt * kHeadTile + gid];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            e[x] = expf(e[x] - mg);
            if (keep_l) ls += e[x];
          }
          b0 = tc::pack2<TT>(e[0], e[1]);
          b1 = tc::pack2<TT>(e[2], e[3]);
        };
        // c += V^T (m-block mb, this step's keys) P^T
        auto pv = [&](float (&c)[4], int mb, uint32_t b0, uint32_t b1) {
          uint32_t a[4];
          if constexpr (kLdsm) {
            // matrices (keys 0-7 | 8-15) x (d 0-7 | 8-15), transposed:
            // lane 8 i + x points at key x + 8 (i / 2), d 8 (i % 2)
            ldsm_x4_trans(a, slot + swz(kb + (lane & 7) + 8 * (lane >> 4),
                                        (mb * 16 + 8 * ((lane >> 3) & 1)) * 2));
          } else {
            auto at = [&](int r, int dd) {
              return reinterpret_cast<const KT*>(slot + swz(r, dd * (int)sizeof(KT)));
            };
            const int dd = mb * 16 + gid;
            a[0] = pair_rows<KT, TT>(at(j, dd), at(j + 1, dd), p);
            a[1] = pair_rows<KT, TT>(at(j, dd + 8), at(j + 1, dd + 8), p);
            a[2] = pair_rows<KT, TT>(at(j + 8, dd), at(j + 9, dd), p);
            a[3] = pair_rows<KT, TT>(at(j + 8, dd + 8), at(j + 9, dd + 8), p);
          }
          mma16816<TT>(c, a[0] & mask0, a[1] & mask0, a[2] & mask8,
                       a[3] & mask8, b0, b1);
        };
        uint32_t b0 = 0u, b1 = 0u;
        if (one_nt) {
          // every tile of the warp in head tile nt0 (always for G <= 8):
          // p once, then a straight run of products
          form(nt0, s == 0, mb0 == 0, lsum[0], b0, b1);
#pragma unroll
          for (int t = 0; t < kAccTiles; ++t)
            if (u0 + t < u1) pv(acc[t], mb0 + t, b0, b1);
        } else {
          int cur = -1, nt = nt0, mb = mb0;  // tile t's head tile, m-block
#pragma unroll
          for (int t = 0; t < kAccTiles; ++t) {
            if (t > 0 && ++mb == nmb) {
              mb = 0;
              ++nt;
            }
            if (u0 + t >= u1) continue;  // (not break: stays unrolled)
            if (nt != cur) {
              cur = nt;
              form(nt, s == 0 && nt == nt0, mb == 0, lsum[t], b0, b1);
            }
            pv(acc[t], mb, b0, b1);
          }
        }
      }
    } else {
      // thread (head, key) forms p and adds it into its l slot; thread
      // (head tile, d) then sums p.V for column d of the tile's heads
      for (int x = tid; x < G * kTile; x += kThreads) {
        const int g = x / kTile, j = x % kTile;
        float e = 0.f;
        if (j >= lo && j < hi) e = expf(score(g, j0 + j) - mrow[g]);
        lacc[x] += e;
        pr[x] = round_src(e, p.src_kind);
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kAccTiles / 2; ++s) {
        const int u = tid + s * kThreads, nt = u / D, dc = u - nt * D;
        if (nt < ngt) {
          const float* pt = pr + nt * kHeadTile * kTile;
          const int gn = min(kHeadTile, G - nt * kHeadTile);
          for (int j = lo; j < hi; ++j) {
            const float vv = widen(*reinterpret_cast<const KT*>(
                                       slot + swz(j, dc * (int)sizeof(KT))),
                                   p.kv_snap, p.src_kind);
#pragma unroll
            for (int g = 0; g < kHeadTile; ++g)
              if (g < gn) acc[2 * s + g / 4][g % 4] += pt[g * kTile + j] * vv;
          }
        }
      }
      __syncthreads();  // ``pr`` is reused by the next tile
    }
    release(ntiles, i);
  }

  // ---- this rank's partials into shared memory (over the idle ring) ------
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);  // [G][D] p.V, then [G] l
  if constexpr (kMma) {
    // the key groups' sums, staged and added in group order
    float* stage = part + G * D + G;  // [kq][G][D], then [kq][G] l
    float* lst = stage + KQ * G * D;
    int nt = nt0, mb = mb0;
#pragma unroll
    for (int t = 0; t < kAccTiles; ++t) {
      if (t > 0 && ++mb == nmb) {
        mb = 0;
        ++nt;
      }
      if (u0 + t >= u1) continue;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int g = nt * kHeadTile + 2 * tig + (x & 1),
                  dd = mb * 16 + gid + (x >> 1) * 8;
        if (g < G) stage[(kq * G + g) * D + dd] = acc[t][x];
      }
      if (mb == 0) {
        // l of head gid of the tile over the key group: its four tig
        // lanes, in a fixed order
        float l = lsum[t] + __shfl_xor_sync(0xffffffffu, lsum[t], 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int g = nt * kHeadTile + gid;
        if (tig == 0 && g < G) lst[kq * G + g] = l;
      }
    }
    __syncthreads();
    for (int x = tid; x < G * D; x += kThreads) {
      float a = stage[x];
      for (int q = 1; q < KQ; ++q) a += stage[q * G * D + x];
      part[x] = a;
    }
    for (int g = tid; g < G; g += kThreads) {
      float a = lst[g];
      for (int q = 1; q < KQ; ++q) a += lst[q * G + g];
      part[G * D + g] = a;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kAccTiles / 2; ++s) {
      const int u = tid + s * kThreads, nt = u / D, dc = u - nt * D;
      if (nt < ngt) {
#pragma unroll
        for (int g = 0; g < kHeadTile; ++g)
          if (nt * kHeadTile + g < G)
            part[(nt * kHeadTile + g) * D + dc] = acc[2 * s + g / 4][g % 4];
      }
    }
    // head g's l: its kTile slots in key order
    for (int g = tid; g < G; g += kThreads) {
      float a = 0.f;
      for (int j = 0; j < kTile; ++j) a += lacc[g * kTile + j];
      part[G * D + g] = a;
    }
  }

  // ---- the partials of ranks 0, 1, ..., C - 1 added in that order; rank r
  // adds and stores outputs [r n / C, (r + 1) n / C) of the row's n = G D ----
  cluster.sync();
  {
    const int n = G * D, i0 = n * rank / p.cluster,
              i1 = n * (rank + 1) / p.cluster;
    for (int i = i0 + tid; i < i1; i += kThreads) {
      const int g = i / D;
      float a[kMaxCluster], l[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < p.cluster) {
          const float* rp = cluster.map_shared_rank(part, r);
          a[r] = rp[i];
          l[r] = rp[n + g];
        }
      }
      float sa = a[0], sl = l[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) {
        if (r < p.cluster) {
          sa += a[r];
          sl += l[r];
        }
      }
      p.out[(long long)row * n + i] = sa / (sl == 0.f ? 1.f : sl);
    }
  }
  cluster.sync();  // no rank leaves while others read its shared memory

  if constexpr (kFlags) {
    // ---- telemetry (the TPU kernel's debug_visits / debug_flags) ---------
    // visits: the units this rank worked (a window's whole units left of
    // it are never read, so they stay 0)
    for (int u = sp.u0 + tid; u < sp.u1; u += kThreads)
      p.visits[(long long)row * p.nk + u] = 1;
    // flags: a count-only read of every live key [0, kvl) of the row, K and
    // V, once per row, unit by unit (the units spread over the ranks), q
    // once in cell 0.  It covers the keys left of the window, which the
    // TPU kernel counts and this kernel never reads, and it leaves the
    // passes above untouched, so the output is the flags-off output.
    const int nun = kvl > 0 ? (kvl - 1) / p.unit + 1 : 0;
    for (int u = rank; u < nun; u += p.cluster) {
      const int j0 = u * p.unit, j1 = min(kvl, j0 + p.unit);
      long long base;
      if (p.block_table) {
        const int id = p.block_table[(long long)row * p.nk + u];
        if (id < 0 || id >= p.pool_rows) __trap();  // page id outside the pool
        base = (long long)id * p.unit * D;
      } else {
        base = ((long long)row * p.smax + j0) * D;
      }
      const long long n = (long long)(j1 - j0) * D;
      int c[4] = {0, 0, 0, 0};
      count_flags(k + base, n, p.kv_snap, tid, kThreads, c);
      count_flags(v + base, n, p.kv_snap, tid, kThreads, c);
      if (u == 0)
        count_flags_any(p.q, p.q_dtype, (long long)row * G * D, (long long)G * D,
                        p.q_snap, tid, kThreads, c);
      flush_flags(p.flags + ((long long)row * p.nk + u) * 4, c);
    }
  }
}

template <typename KT, int kRoute, bool kFlags, bool kOne>
cudaError_t launch_typed(const CUtensorMap& kmap, const CUtensorMap& vmap,
                         const void* k, const void* v, int rows,
                         const DecodeParams& p, size_t smem,
                         cudaStream_t stream) {
  auto kern = decode_cluster_kernel<KT, kRoute, kFlags, kOne>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * p.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  // once per (cluster size, shared memory): the kernel's attributes, and a
  // check that the card can place such a cluster at all (one that cannot
  // would never start)
  static int ok_cluster = 0;
  static size_t ok_smem = 0;
  if (ok_cluster != p.cluster || ok_smem != smem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (p.cluster > kPortableCluster) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorLaunchOutOfResources;
    ok_cluster = p.cluster;
    ok_smem = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kern, kmap, vmap, static_cast<const KT*>(k),
                           static_cast<const KT*>(v), p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename KT, bool kFlags, bool kOne>
cudaError_t launch_route(const CUtensorMap& kmap, const CUtensorMap& vmap,
                         const void* k, const void* v, int rows, int route,
                         const DecodeParams& p, size_t smem,
                         cudaStream_t stream) {
  switch (route) {
    case ROUTE_FMA:
      return launch_typed<KT, ROUTE_FMA, kFlags, kOne>(kmap, vmap, k, v, rows, p, smem, stream);
    case ROUTE_MMA_BF16:
      return launch_typed<KT, ROUTE_MMA_BF16, kFlags, kOne>(kmap, vmap, k, v, rows, p, smem, stream);
    case ROUTE_MMA_F16:
      return launch_typed<KT, ROUTE_MMA_F16, kFlags, kOne>(kmap, vmap, k, v, rows, p, smem, stream);
  }
  return cudaErrorInvalidValue;
}

// The one-head-tile instantiation for G <= 8, the general one above.
template <typename KT, bool kFlags>
cudaError_t launch_tiles(const CUtensorMap& kmap, const CUtensorMap& vmap,
                         const void* k, const void* v, int rows, int route,
                         const DecodeParams& p, size_t smem,
                         cudaStream_t stream) {
  return p.ngt == 1
             ? launch_route<KT, kFlags, true>(kmap, vmap, k, v, rows, route, p, smem, stream)
             : launch_route<KT, kFlags, false>(kmap, vmap, k, v, rows, route, p, smem, stream);
}

// The telemetry instantiation (``kFlags``) when the caller asked for it.
template <typename KT>
cudaError_t launch_flags(const CUtensorMap& kmap, const CUtensorMap& vmap,
                         const void* k, const void* v, int rows, int route,
                         const DecodeParams& p, size_t smem,
                         cudaStream_t stream) {
  return p.flags ? launch_tiles<KT, true>(kmap, vmap, k, v, rows, route, p, smem, stream)
                 : launch_tiles<KT, false>(kmap, vmap, k, v, rows, route, p, smem, stream);
}

int elem_bytes(int dtype) {
  switch (dtype) {
    case DT_F32: return 4;
    case DT_BF16: case DT_F16: return 2;
    case DT_FP8E5M2: return 1;
  }
  return 0;
}

// The byte view of a pool for TMA: [pages][rows][row_bytes], boxes of
// 128 bytes x ``box_rows`` rows, 128-byte swizzle.  False where
// ``cuTensorMapEncodeTiled`` refuses it.
bool encode_pool_map(CUtensorMap* map, const void* base, int row_bytes,
                     long long rows, long long pages, int box_rows) {
  tc_host::EncodeTiled enc = tc_host::encode_fn();
  if (!enc) return false;
  cuuint64_t gdim[3] = {(cuuint64_t)row_bytes, (cuuint64_t)rows,
                        (cuuint64_t)pages};
  cuuint64_t gstride[2] = {(cuuint64_t)row_bytes,
                           (cuuint64_t)row_bytes * (cuuint64_t)rows};
  cuuint32_t box[3] = {128u, (cuuint32_t)box_rows, 1u}, estr[3] = {1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
             gdim, gstride, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ``encode_pool_map`` with a small cache: a serving step calls the kernel
// once per layer on the same pools, so the maps of the last few pools are
// kept (host memory only; the maps travel as kernel parameters).
bool make_pool_map(CUtensorMap* map, const void* base, int row_bytes,
                   long long rows, long long pages, int box_rows) {
  struct Entry {
    const void* base;
    long long rows, pages;
    int row_bytes, box_rows;
    CUtensorMap map;
  };
  static Entry cache[8];
  static int next_slot = 0;
  for (const Entry& e : cache) {
    if (e.base == base && e.rows == rows && e.pages == pages &&
        e.row_bytes == row_bytes && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  }
  if (!encode_pool_map(map, base, row_bytes, rows, pages, box_rows)) return false;
  cache[next_slot] = Entry{base, rows, pages, row_bytes, box_rows, *map};
  next_slot = (next_slot + 1) % 8;
  return true;
}

}  // namespace

// ``unit``: keys per split unit (the page; 64 for contiguous strips, whose
// ``smax`` is the strip length and ``nk`` its unit count).  ``visits`` /
// ``flags``: the zeroed telemetry outputs [rows, nk] / [rows, nk, 4] (both
// or neither; null launches the flags-off kernel).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* block_table, void* out, void* scores, void* visits,
    void* flags, int rows, int g, int d,
    int nk, int unit, int pool_rows, int smax, int cluster, int q_dtype,
    int kv_dtype, int src_kind, int route, int kv_m, int kv_emax, int kv_emin,
    int q_m, int q_emax, int q_emin, float scale, int window, float softcap,
    void* stream) {
  const int esz = elem_bytes(kv_dtype);
  const int ngt = (g + kHeadTile - 1) / kHeadTile;
  if (g < 1 || ngt * d > kMaxTileCols || d < 1 || d > kMaxD || esz == 0 ||
      unit < 1 ||
      cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return cudaErrorInvalidValue;
  if (route != ROUTE_FMA &&
      (d % 16 != 0 || src_kind != (route == ROUTE_MMA_BF16 ? SRC_BF16 : SRC_F16)))
    return cudaErrorInvalidValue;
  if ((visits == nullptr) != (flags == nullptr)) return cudaErrorInvalidValue;
  DecodeParams p;
  p.q = q;
  p.kv_len = static_cast<const int*>(kv_len);
  p.block_table = static_cast<const int*>(block_table);
  p.out = static_cast<float*>(out);
  p.scores = static_cast<float*>(scores);
  p.visits = static_cast<int*>(visits);
  p.flags = static_cast<int*>(flags);
  p.g = g; p.d = d; p.nk = nk; p.unit = unit; p.pool_rows = pool_rows;
  p.ngt = ngt;
  p.mma = route != ROUTE_FMA;
  // pass 2 of route MMA: ngt * D / 16 output tiles over 8 warps, at most
  // kAccTiles a warp; the keys split into as many groups as that allows
  const int units = ngt * (d / 16);
  p.kq = !p.mma ? 1 : units <= 2 * kAccTiles ? 4 : units <= 4 * kAccTiles ? 2 : 1;
  p.smax = smax; p.q_dtype = q_dtype; p.src_kind = src_kind;
  p.cluster = cluster;
  p.max_units = (nk + cluster - 1) / cluster;
  p.row_bytes = d * esz;
  p.nch = (p.row_bytes + 127) / 128;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  // TMA: whole 128-byte chunks, and pages that tile a 64-key tile exactly
  // (a multiple of 64, or 8..32 keys dividing 64; a strip is one "page")
  const bool paged = block_table != nullptr;
  const bool pages_fit = !paged || unit % kTile == 0 ||
                         (kTile % unit == 0 && unit % 8 == 0);
  CUtensorMap kmap, vmap;
  memset(&kmap, 0, sizeof(kmap));
  memset(&vmap, 0, sizeof(vmap));
  p.tma = p.row_bytes % 128 == 0 && addr % 16 == 0 && pages_fit;
  if (p.tma) {
    const long long r = paged ? unit : smax;
    const long long n = paged ? pool_rows : rows;
    const int box_rows = paged && unit < kTile ? unit : kTile;
    p.tma = make_pool_map(&kmap, k, p.row_bytes, r, n, box_rows) &&
            make_pool_map(&vmap, v, p.row_bytes, r, n, box_rows);
  }

  p.kv_snap = Snap{kv_m, kv_emax, kv_emin};
  p.q_snap = Snap{q_m, q_emax, q_emin};
  p.scale = scale;
  p.window = window;
  p.softcap = softcap;
  p.two_over_cap = softcap > 0.f ? 2.f / softcap : 0.f;
  const size_t smem = (size_t)Layout(p).total;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case DT_F32:
      return launch_flags<float>(kmap, vmap, k, v, rows, route, p, smem, s);
    case DT_BF16:
      return launch_flags<__nv_bfloat16>(kmap, vmap, k, v, rows, route, p, smem, s);
    case DT_F16:
      return launch_flags<__half>(kmap, vmap, k, v, rows, route, p, smem, s);
    case DT_FP8E5M2:
      return launch_flags<__nv_fp8_e5m2>(kmap, vmap, k, v, rows, route, p, smem, s);
  }
  return cudaErrorInvalidValue;
}
