// The one-token GQA decode body shared by K1 (ring cache,
// decode_attention.cu) and K2 (block-paged pool,
// paged_decode_attention.cu).
//
// Both kernels run this same template and differ only in where the K/V
// row of logical slot s lives: ring slot s of the lane's buffer, or
// in-page slot s % page of physical page bt[b, s / page].  The split of
// the slots, their order and every float32 operation are shared, so on
// the same logical contents the paged kernel's output is bitwise equal to
// the ring kernel's (paged lanes and ring lanes then decode the same
// tokens).
//
// What bounds it on an H100.  One token reads the live part of the cache
// once: 2 * min(S, t+1) * KV * hd elements per lane, 4 FLOPs each, far
// below the ~295 FLOP/byte at which the tensor cores would be the limit.
// At the serving shapes that is 20-660 KB, 0.01-0.2 us at 3.35 TB/s:
// what a call costs is latency, i.e. how many dependent steps (loads,
// barriers, reductions) lie between launch and the last store, and how
// few SMs the work lands on.  The design cuts both:
//
//  * Split over a thread-block cluster.  Each (lane, KV head) runs on a
//    cluster of n = split_plan(S) blocks (a power of two <= 8, from S
//    alone; kernels/decode_attention.py).  Past 64 live slots, block
//    `rank` takes the contiguous slots [rank * per, (rank + 1) * per) of
//    the live range [0, min(S, t[b] + 1)), per = ceil(live / n), so a
//    lane's plan depends on (t[b], S) only: never on B or on the other
//    lanes, which keeps each lane equal bit for bit to its scalar-t
//    launch and K2 equal to K1.  B = 1, S = 512 is 40 blocks, not 5.
//  * Solo: up to 64 live slots (the serial path's first tokens, a lane's
//    early steps), and always in a cluster of one, rank 0 takes them all,
//    folds its warps and stores the output; the other ranks return at
//    once and no block touches the cluster barrier, which with the merge
//    costs more than 64 slots do on one block.  Folding that single
//    partial in rank 0 would give the same bits (the empty partials weigh
//    0 and the full one exactly 1).
//  * Warps own slots.  A warp holds R = 32 / lpr slot rows at a time,
//    lpr lanes to a row, each lane loading NC chunks of 16 bytes (8 bf16
//    or 4 f32 of the row) of K and of V, chunk j of lane c at column
//    (c + j * lpr) * 16 bytes, so a warp's loads stay contiguous; 8 warps
//    cover 32 slots a step at hd 64 in bf16.  NC is 1 up to 32 chunks a
//    row (hd 256 in bf16: a whole warp to a row); float32 rows past 128
//    take NC = 2, 8 floats a lane, as a bf16 row of 256 does.  The G
//    query rows of the group sit in registers; a score is a register dot
//    product over the lane's chunks and a butterfly of warp shuffles over
//    the row's lanes.
//  * Each row group of lanes keeps its own online softmax (m, l, acc) in
//    registers, with one exponential per slot and head, and there is no
//    barrier of any kind inside the slot loop.
//  * bf16 at head widths 128 and 256 with up to 8 query heads a KV head
//    (jamba, llama-3.2-vision, gemma3, and the hd-128 registry models)
//    takes a second body, decode_tc_kernel below.  There a lane body's
//    slot row took 16 or 32 lanes, so a warp held 2 or 1 slots a step and
//    each score paid G x log2(lanes) shuffles in series: at 64 live slots
//    a warp ran ~8 dependent steps.  The tensor-core body computes a
//    16-slot tile's scores for all G heads with mma.sync (S^T = K Q^T,
//    slots in M, heads in N = 8) and P V the same way (O^T = V^T P^T,
//    head_dim in M), so a 64-slot block is one tile per warp pair and a
//    handful of mma in series.  Fragments load straight from global
//    memory, 16 bytes a lane (a fragment's K positions may take any
//    order both operands share), with no shared-memory staging and no
//    barrier in the slot loop.  Its split plan, merges and output are
//    the lane body's (block_fold), so K2 == K1 and lane == scalar-t hold
//    as before.
//  * One merge at the end: row groups by shuffles, warps through shared
//    memory, then the cluster through distributed shared memory, with no
//    second combine kernel, no global scratch and no atomics (block_fold).
//    An empty split's partial is (kNegInf, 0, 0) and folding it in leaves
//    the other partial bitwise unchanged.  Outside solo (which every block
//    of a cluster decides alike, from (t, S)) every block reaches both
//    cluster barriers: a relaxed arrive once t is read, waited on just
//    before its first remote store, proves that every rank has started,
//    and after the second barrier a rank reads only its own shared
//    memory, so a block may exit right after it.  Pulling the partials
//    instead would cost a second full barrier, to keep every block alive
//    until the others have read it, and remote loads in series.
//  * Wide query groups.  The tensor-core body is compiled at GM = 8 for
//    any G, so its loads and mma are those of G 2, but the merge's work is
//    G x hd a block: at gemma-2b's 8 heads over one KV head of width 256
//    that merge was 8.5 of a 12.4 us call at t = 127 (scripts/
//    k1_stages.py): rank 0 folding eight blocks' 2,048-column partials
//    alone (5.4 us), every element recomputing its fold weights (__expf
//    of each partial) and a runtime division, and the pairs' partial
//    stores 8-way bank-conflicted (the four tig of a store on one bank).
//    So (a) a pair stores columns d, d + 1 as one 8-byte store into a row
//    swizzled by the head (swz: column d at d ^ (g & 6)), which a
//    half-warp's stores spread over 16 bank pairs; (b) each step of a
//    fold, 4 columns of one head at the body's compile-time hd, takes its
//    head's weights once, in registers, and then runs FMAs only, its
//    loads unguarded (weights shared through shared memory behind a
//    barrier measured slower even where a thread folds two steps, and a
//    runtime guard around each partial's loads made them run one after
//    another); the tensor-core body skips the warp pairs that held
//    no slot (at t = 127 a rank's 16 slots fill one of its four pairs),
//    the lane body, one element a thread, folds all eight warps, which
//    measured faster; (c) the cluster's fold is spread over the ranks by
//    column: every block pushes its (m, l) of each head to every rank and
//    columns [j hd / n, (j + 1) hd / n) of its partial to rank j, and
//    after the one barrier each rank folds and stores its columns, so no
//    rank receives or folds more than G x hd / n columns of each block
//    and the cluster part of a block's shared memory is GM x hd floats,
//    not n x GM x hd.  Every element is folded with the
//    operations, in the order, of one block folding whole rows and rank
//    0 folding every block, so the output is that fold's bit for bit.
//    At gemma-2b's heads a call at t = 127 then takes 5.9 us against
//    SDPA's 7.6 on the same work (scripts/attention_timing.py on an
//    H100), and its merge 2.6 of the 6.2 us that k1_stages times.

// The fill level is read on the device, one shared value (t_stride 0) or
// one per lane (t_stride 1): a ring that has wrapped attends every slot,
// and a lane whose t has run past its window (a stopped lane still
// stepping until its segment ends) stays finite.  The launcher allocates
// nothing and returns the launch's cudaError_t.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kSplitSlots = 64;     // live slots rank 0 takes alone
constexpr float kNegInf = -1e30f;   // the reference's finite mask value
constexpr size_t kMaxSmem = 232448; // dynamic shared memory of a block

// Element strides; the head_dim axis is contiguous everywhere.
struct DecodeArgs {
  const void* q;            // (B, 1, H, hd)
  const void* k;            // ring (B,S,KV,hd) | pool (n_pages,page,KV,hd)
  const void* v;
  const int32_t* t;         // fill level(s)
  const int32_t* bt;        // paged: (B, P) block table, else unused
  void* o;                  // (B, 1, H, hd)
  int S;                    // logical window: ring slots | P * page
  int G, hd;
  int lpr;                  // lanes per slot row: pow2 >= chunks, <= 32
  int t_stride;             // 0: one shared t, 1: t[b]
  int page, P;              // paged only
  int64_t q_sb, q_sh, o_sb, o_sh;
  int64_t c_sb;             // ring: lane stride
  int64_t c_sp;             // paged: page stride
  int64_t c_ss, c_sh;       // slot stride (ring axis | in-page), head stride
  int64_t bt_sb;            // paged: block-table row stride
  float scale;
};

// 16 bytes of one row as floats: 8 bf16 or 4 f32.
template <typename T> struct Row16;
template <> struct Row16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void cvt(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Row16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void cvt(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory: per-warp partials (m, l: G each; acc: G * hd), the
// cluster's block partials (m, l of every rank, pushed by every rank),
// the columns of the blocks' accumulators that this rank folds (hd /
// n_split of each head from each rank: GM * hd floats, only in a cluster)
// and, paged, the block-table row.  kernels/decode_attention.py's
// decode_smem_bytes states the same sum, so the wrapper refuses a shape
// whose block would not fit.
template <int GM>
struct Smem {
  float wm[kWarps][GM], wl[kWarps][GM];
  float cm[kMaxSplits][GM], cl[kMaxSplits][GM];
};

inline size_t smem_bytes(const DecodeArgs& a, int gm, int n_split,
                         bool paged) {
  return sizeof(float) * (2 * (kWarps + kMaxSplits) * gm +
                          (size_t)(kWarps + (n_split > 1)) * gm * a.hd) +
         (paged ? sizeof(int32_t) * a.P : 0);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The tensor-core body's warp pairs keep column d of head g's accumulator
// row at d ^ (g & 6): its lanes (gid, tig) store heads 2 tig, 2 tig + 1 at
// columns 8 gid + 2 i, so without the swizzle a store's four tig land on
// one bank; with it each half-warp's 8-byte stores take 16 distinct bank
// pairs.  It permutes within 8 columns (hd is a multiple of 8).  The lane
// body's rows are plain.
__device__ __forceinline__ int swz(int g, int d) { return d ^ (g & 6); }

// Columns d .. d + U - 1 of head g's warp row: U = 1, a plain row (the
// lane body); U = 4, a swizzled one, a 16-byte load at 4-aligned d with
// its halves swapped back when g & 2.
template <int U>
__device__ __forceinline__ void load_row(const float* row, int g, int d,
                                         float* x) {
  if constexpr (U == 1) {
    x[0] = row[d];
  } else {
    const float4 f = *reinterpret_cast<const float4*>(row + (d ^ (g & 4)));
    const bool sw = g & 2;
    x[0] = sw ? f.z : f.x;
    x[1] = sw ? f.w : f.y;
    x[2] = sw ? f.x : f.z;
    x[3] = sw ? f.y : f.w;
  }
}

template <int U>
__device__ __forceinline__ void load_f32(const float* p, float* x) {
  if constexpr (U == 1) {
    x[0] = p[0];
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  }
}

template <int U>
__device__ __forceinline__ void store_f32(float* p, const float* x) {
  if constexpr (U == 1)
    p[0] = x[0];
  else
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// (q, r) = (x / y, x % y): by shifts when y = 2^lg (pow2), else by
// division
__device__ __forceinline__ void divmod(int x, int y, int lg, bool pow2,
                                       int& q, int& r) {
  if (pow2) {
    q = x >> lg;
    r = x & (y - 1);
  } else {
    q = x / y;
    r = x - q * y;
  }
}

// The fold weights exp(m_k - max m) of the first n (>= 1) of K partials
// m[k * stride], and their max.  Branch-free: partial k >= n reads
// partial n - 1 (a duplicate changes no max, and no fold uses a weight
// past n), so the unrolled loads go out together.
template <int K>
__device__ __forceinline__ float fold_weights(const float* m, int stride,
                                              int n, float* e) {
  float v[K], mx = kNegInf;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = m[min(k, n - 1) * stride];
    mx = fmaxf(mx, v[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) e[k] = __expf(v[k] - mx);
  return mx;
}

// s[u] (and lsum) += the first n of K partials' columns times their
// weights, in partial order: x(k, xk) loads partial k's U columns, l[k]
// is its l.  The loads (of partial min(k, n - 1)) go out together; only
// the FMAs of partials past n are skipped.
template <int K, int U, class Load>
__device__ __forceinline__ void fold_cols(Load x, const float* l, int stride,
                                          int n, const float* e, float& lsum,
                                          float* s) {
  float xs[K][U], ls[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x(min(k, n - 1), xs[k]);
    ls[k] = l[min(k, n - 1) * stride];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < n) {
      lsum = fmaf(ls[k], e[k], lsum);
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] = fmaf(xs[k][u], e[k], s[u]);
    }
  }
}

// out[u] = s[u] / max(lsum, 1e-30) in T, U columns at once.
template <typename T, int U>
__device__ __forceinline__ void store_out(T* p, const float* s, float lsum) {
  const float den = fmaxf(lsum, 1e-30f);
  if constexpr (U == 4 && sizeof(T) == 2) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s[0] / den, s[1] / den);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2] / den, s[3] / den);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) p[u] = from_f32<T>(s[u] / den);
  }
}

// The block's end, shared by both bodies once each of its NW warp
// partials (m, l and the accumulator of every head) is in shared memory;
// only the first nw (>= 1) of them held slots or were stored (the others
// are the identity, (kNegInf, 0, 0), and folding them in would leave
// every bit as it is).
//  1. Warp fold: each step of U columns of one head takes the weights
//     exp(m_w - max_w m_w) of its head once, in registers, and folds the
//     warps in order with FMAs.  Solo: that is the output.
//  2. Else each block pushes its (m, l) of every head into every rank
//     and columns [j hd / n, (j + 1) hd / n) of its accumulator into rank
//     j (every block has started once the wait returns); one cluster
//     barrier; each rank takes the weights of the n partials as in 1,
//     folds its columns in rank order and stores them.
// Every element is folded with the operations, in the order, of one
// block folding whole rows and rank 0 folding every block, so the output
// is that fold's bit for bit.  HD is the head width when the body fixes
// it at compile time (the steps then take U = 4 columns), else 0.
template <typename T, int GM, int NW, int HD>
__device__ __forceinline__ void block_fold(const DecodeArgs& a, Smem<GM>& sh,
                                           const float* wacc, float* cacc,
                                           cg::cluster_group& cluster,
                                           int n_split, int rank, bool solo,
                                           int nw, int kvh, int b, int tid) {
  constexpr int U = HD ? 4 : 1;
  const int G = a.G, hd = HD ? HD : a.hd;
  const int lg_n = 31 - __clz(n_split);     // n_split is a power of two
  const int cols = hd >> lg_n;               // columns a rank folds
  // hd and cols by shifts where hd is a power of two (always at HD)
  const bool pow2 = HD || !(hd & (hd - 1));
  const int lg_hd = 31 - __clz(hd), lg_c = lg_hd - lg_n;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + (int64_t)kvh * G * a.o_sh;
  if (!solo) cluster_wait();
#pragma unroll 2
  for (int i = tid * U; i < G * hd; i += kThreads * U) {
    int g, d;
    divmod(i, hd, lg_hd, pow2, g, d);
    float e[NW];
    const float mx = fold_weights<NW>(&sh.wm[0][g], GM, nw, e);
    float lsum = 0.f, s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = 0.f;
    fold_cols<NW, U>(
        [&](int w, float* x) {
          load_row<U>(wacc + (w * GM + g) * hd, g, d, x);
        },
        &sh.wl[0][g], GM, nw, e, lsum, s);
    if (solo) {
      store_out<T, U>(o + (int64_t)g * a.o_sh + d, s, lsum);
      continue;
    }
    // push: columns to their rank
    int j, c;
    divmod(d, cols, lg_c, pow2, j, c);
    store_f32<U>(cluster.map_shared_rank(cacc, j) + (rank * GM + g) * cols + c,
                 s);
    if (c == 0) {
      *cluster.map_shared_rank(&sh.cm[rank][g], j) = mx;
      *cluster.map_shared_rank(&sh.cl[rank][g], j) = lsum;
    }
  }
  if (solo) return;
  cluster.sync();                    // every rank holds its columns
  for (int i = tid * U; i < G * cols; i += kThreads * U) {
    int g, c;
    divmod(i, cols, lg_c, pow2, g, c);
    float e[kMaxSplits];
    fold_weights<kMaxSplits>(&sh.cm[0][g], GM, n_split, e);
    float lsum = 0.f, s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = 0.f;
    fold_cols<kMaxSplits, U>(
        [&](int r, float* x) {
          load_f32<U>(cacc + (r * GM + g) * cols + c, x);
        },
        &sh.cl[0][g], GM, n_split, e, lsum, s);
    store_out<T, U>(o + (int64_t)g * a.o_sh + rank * cols + c, s, lsum);
  }
}

template <typename T, int GM, int NC, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  constexpr int V = Row16<T>::kN;       // elements of one 16-byte chunk
  constexpr int VE = NC * V;            // elements a lane holds of a row
  extern __shared__ float smem[];
  Smem<GM>& sh = *reinterpret_cast<Smem<GM>*>(smem);
  float* wacc = smem + sizeof(Smem<GM>) / sizeof(float);   // [kWarps][GM][hd]
  float* cacc = wacc + kWarps * GM * a.hd;        // [n_split][GM][hd / n]
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int32_t* row =
      reinterpret_cast<int32_t*>(cacc + (n_split > 1) * GM * a.hd);
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, hd = a.hd, lpr = a.lpr;
  const int R = 32 / lpr;                  // slot rows a warp holds
  const int rg = lane / lpr, c = lane % lpr;
  bool has_chunk[NC];                   // chunk j: column (c + j*lpr) * V
#pragma unroll
  for (int j = 0; j < NC; ++j) has_chunk[j] = (c + j * lpr) * V < hd;

  const T* kb = static_cast<const T*>(a.k) + kvh * a.c_sh + c * V;
  const T* vb = static_cast<const T*>(a.v) + kvh * a.c_sh + c * V;
  if (!kPaged) {
    kb += b * a.c_sb;
    vb += b * a.c_sb;
  }
  // the split plan: up to kSplitSlots live slots, rank 0 alone takes
  // them all, computes and stores the output, and no block touches the
  // cluster's barrier or another block's shared memory; past that,
  // contiguous ranges of ceil(live / n) slots by rank
  const int t = a.t[b * a.t_stride];
  const int live = t + 1 < a.S ? t + 1 : a.S;
  const bool solo = live <= kSplitSlots || n_split == 1;
  const int per = solo ? live : (live + n_split - 1) / n_split;
  const int lo = min(live, rank * per);
  const int hi = min(live, lo + per);
  if (solo && rank != 0) return;
  // announce that this block runs; the matching wait, before the first
  // store into rank 0's shared memory, overlaps the slot loop
  if (!solo) cluster_arrive_relaxed();

  if (kPaged) {                      // no scalar prefetch: load the row
    for (int i = tid; i < a.P; i += kThreads) row[i] = a.bt[b * a.bt_sb + i];
    __syncthreads();
  }

  float q[GM][VE];
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + c * V;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      uint4 u = make_uint4(0, 0, 0, 0);
      if (g < G && has_chunk[j])
        u = __ldg(reinterpret_cast<const uint4*>(
            qb + (int64_t)(kvh * G + g) * a.q_sh + j * lpr * V));
      Row16<T>::cvt(u, q[g] + j * V);
    }
  }
  float m[GM], l[GM], acc[GM][VE];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[g][i] = 0.f;
  }

  // row group rg of warp w holds slot base + w * R + rg of each step
  for (int base = lo; base < hi; base += kWarps * R) {
    const int s = base + warp * R + rg;
    const bool ok = s < hi;
    float kf[VE], vf[VE];
    {
      const int64_t off = !ok ? 0
                          : kPaged ? (int64_t)row[s / a.page] * a.c_sp +
                                         (int64_t)(s % a.page) * a.c_ss
                                   : (int64_t)s * a.c_ss;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
        if (ok && has_chunk[j]) {
          kr = __ldg(reinterpret_cast<const uint4*>(kb + off + j * lpr * V));
          vr = __ldg(reinterpret_cast<const uint4*>(vb + off + j * lpr * V));
        }
        Row16<T>::cvt(kr, kf + j * V);
        Row16<T>::cvt(vr, vf + j * V);
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < VE; ++i) d = fmaf(q[g][i], kf[i], d);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)     // over the row's lpr lanes
        if (o < lpr) d += __shfl_xor_sync(0xffffffffu, d, o);
      // online softmax with one exponential: the larger of the running
      // max and the score keeps weight 1
      const float sc = d * a.scale;
      const float e = __expf(-fabsf(sc - m[g]));
      const bool up = ok && sc > m[g];
      const float alpha = up ? e : 1.f;
      const float pg = !ok ? 0.f : up ? 1.f : e;
      m[g] = up ? sc : m[g];
      l[g] = fmaf(l[g], alpha, pg);
#pragma unroll
      for (int i = 0; i < VE; ++i)
        acc[g][i] = fmaf(acc[g][i], alpha, pg * vf[i]);
    }
  }

  // merge the warp's row groups; symmetric in the two sides, so every
  // lane of a row group ends with the same partial
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o < lpr) continue;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float e = __expf(-fabsf(m[g] - mo));
      const float ea = m[g] >= mo ? 1.f : e, eb = mo >= m[g] ? 1.f : e;
      l[g] = l[g] * ea + lo_ * eb;
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * ea + ao * eb;
      }
      m[g] = fmaxf(m[g], mo);
    }
  }
  // every warp stores its partial and the fold takes all eight: one
  // element a thread, skipping the empty ones cost more than it saved
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (has_chunk[j]) {
          float* dst = wacc + (warp * GM + g) * hd + (c + j * lpr) * V;
#pragma unroll
          for (int i = 0; i < V; ++i) dst[i] = acc[g][j * V + i];
        }
      }
      if (c == 0) {
        sh.wm[warp][g] = m[g];
        sh.wl[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  block_fold<T, GM, kWarps, 0>(a, sh, wacc, cacc, cluster, n_split, rank,
                               solo, kWarps, kvh, b, tid);
}

// One launch of `kern` (either body) over clusters of n_split blocks, one
// cluster per (lane, KV head), with GM accumulator rows a block.
template <class Kernel>
int launch_clusters(Kernel kern, const DecodeArgs& a, int GM, bool paged,
                    int B, int KV, int n_split, cudaStream_t stream) {
  const size_t smem = smem_bytes(a, GM, n_split, paged);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, KV, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int GM, int NC, bool kPaged>
int launch_decode(const DecodeArgs& a, int B, int KV, int n_split,
                  cudaStream_t stream) {
  return launch_clusters(decode_kernel<T, GM, NC, kPaged>, a, GM, kPaged, B,
                         KV, n_split, stream);
}

// --------------------------------------------------------------------------
// bf16 at head widths 128 and 256, G <= 8: scores and P V on the tensor
// cores.  Warp pair p (warps 2p, 2p + 1) takes the 16-slot tiles that start
// at lo + 16 (p + 4 i); both warps of a pair compute the tile's scores,
// S^T = K Q^T with mma.sync.m16n8k16 (the 16 slots in M, the group's heads
// in N = 8, head_dim in K), and warp half h of the pair takes columns
// [h hd / 2, (h + 1) hd / 2) of O^T += V^T P^T (head_dim in M, the slots in
// K).  K, V and q go from global memory straight into fragments, 16 bytes
// a load: a fragment's K positions may hold any head_dim (or slot) order
// as long as both operands agree, so lane (gid, tig) loads head_dim
// 32 j + 8 tig .. + 7 of slot rows gid and gid + 8 (and of q row gid) for
// K steps 2j and 2j + 1, and V columns 64 j + 8 gid .. + 7 of slots 2 tig,
// 2 tig + 1, 2 tig + 8, 2 tig + 9, whose halves a byte permute pairs into
// the A fragment of V^T (output rows d and d + 1 of m-tile 4 j + i sit at
// head_dim 64 j + 8 gid + 2 i and + 1).  P leaves the score accumulator as
// bf16 and movmatrix transposes it into P^T's B fragment.  The online
// softmax keeps one (m, l) per head column in f32; the pair's partial is
// one of NW = 4 in block_fold.
template <bool kPaged>
__device__ __forceinline__ int64_t slot_offset(const DecodeArgs& a,
                                               const int32_t* row, int s) {
  return kPaged ? (int64_t)row[s / a.page] * a.c_sp +
                      (int64_t)(s % a.page) * a.c_ss
                : (int64_t)s * a.c_ss;
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p, bool in) {
  return in ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

constexpr int kTcPairs = kWarps / 2;     // warp pairs: the block's partials
constexpr int kTcSlots = 16;             // slots of a tile (mma M)

template <int HD, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_tc_kernel(DecodeArgs a) {
  constexpr int GM = 8;
  constexpr int KJ = HD / 32;            // 16-byte loads of a K (q) row
  constexpr int VJ = HD / 128;           // 16-byte loads of a V row's half
  constexpr int MT = HD / 32;            // m-tiles of a half of O^T
  using bf16 = __nv_bfloat16;
  extern __shared__ float smem[];
  Smem<GM>& sh = *reinterpret_cast<Smem<GM>*>(smem);
  float* wacc = smem + sizeof(Smem<GM>) / sizeof(float);   // [kWarps][GM][hd]
  float* cacc = wacc + kWarps * GM * HD;              // [n_split][GM][hd / n]
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int32_t* row = reinterpret_cast<int32_t*>(cacc + (n_split > 1) * GM * HD);
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pair = warp / 2, half = warp % 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = a.G;

  // the split plan, as the lane body's
  const int t = a.t[b * a.t_stride];
  const int live = t + 1 < a.S ? t + 1 : a.S;
  const bool solo = live <= kSplitSlots || n_split == 1;
  const int per = solo ? live : (live + n_split - 1) / n_split;
  const int lo = min(live, rank * per);
  const int hi = min(live, lo + per);
  if (solo && rank != 0) return;
  if (!solo) cluster_arrive_relaxed();
  if (kPaged) {
    for (int i = tid; i < a.P; i += kThreads) row[i] = a.bt[b * a.bt_sb + i];
    __syncthreads();
  }

  const bf16* kb = static_cast<const bf16*>(a.k) + kvh * a.c_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + kvh * a.c_sh;
  if (!kPaged) {
    kb += b * a.c_sb;
    vb += b * a.c_sb;
  }
  // q as the scores' B fragments: head gid (zeros past G)
  uint4 qf[KJ];
  {
    const bf16* qr = static_cast<const bf16*>(a.q) + b * a.q_sb +
                     (int64_t)(kvh * G + gid) * a.q_sh + 8 * tig;
#pragma unroll
    for (int j = 0; j < KJ; ++j) qf[j] = ldg16(qr + 32 * j, gid < G);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // heads 2 tig + c
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int base = lo + pair * kTcSlots; base < hi;
       base += kTcPairs * kTcSlots) {
    // K rows gid, gid + 8 and V rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9
    uint4 k0[KJ], k1[KJ], vr[4][VJ];
    {
      const int s0 = base + gid, s1 = s0 + 8;
      const bool in0 = s0 < hi, in1 = s1 < hi;
      const bf16* p0 = kb + (in0 ? slot_offset<kPaged>(a, row, s0) : 0) + 8 * tig;
      const bf16* p1 = kb + (in1 ? slot_offset<kPaged>(a, row, s1) : 0) + 8 * tig;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        k0[j] = ldg16(p0 + 32 * j, in0);
        k1[j] = ldg16(p1 + 32 * j, in1);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = base + 2 * tig + (r & 1) + 8 * (r >> 1);
        const bool in = s < hi;
        const bf16* pv = vb + (in ? slot_offset<kPaged>(a, row, s) : 0) +
                         half * (HD / 2) + 8 * gid;
#pragma unroll
        for (int j = 0; j < VJ; ++j) vr[r][j] = ldg16(pv + 64 * j, in);
      }
    }
    // S^T: rows = slots gid, gid + 8; columns = heads 2 tig, 2 tig + 1;
    // even and odd K steps in two accumulators
    float se[4] = {0.f, 0.f, 0.f, 0.f}, so[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const uint32_t ae[4] = {k0[j].x, k1[j].x, k0[j].y, k1[j].y};
      const uint32_t ao[4] = {k0[j].z, k1[j].z, k0[j].w, k1[j].w};
      mma16816(se, ae, qf[j].x, qf[j].y);
      mma16816(so, ao, qf[j].z, qf[j].w);
    }
    float p[4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float x0 = (se[c] + so[c]) * a.scale;          // slot gid
      float x1 = (se[2 + c] + so[2 + c]) * a.scale;  // slot gid + 8
      if (base + gid >= hi) x0 = kNegInf;
      if (base + gid + 8 >= hi) x1 = kNegInf;
      float mx = fmaxf(x0, x1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      mx = fmaxf(mx, m[c]);
      const float alpha = __expf(m[c] - mx);
      p[c] = x0 == kNegInf ? 0.f : __expf(x0 - mx);
      p[2 + c] = x1 == kNegInf ? 0.f : __expf(x1 - mx);
      l[c] = fmaf(l[c], alpha, p[c] + p[2 + c]);
      m[c] = mx;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        acc[i][c] *= alpha;
        acc[i][2 + c] *= alpha;
      }
    }
    // P^T as B: (slots 2 tig, 2 tig + 1 | + 8; head gid)
    const uint32_t b0 = movmatrix_t(pack_bf16(p[0], p[1]));
    const uint32_t b1 = movmatrix_t(pack_bf16(p[2], p[3]));
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint32_t w0 = word(vr[0][i / 4], i % 4), w1 = word(vr[1][i / 4], i % 4);
      const uint32_t w2 = word(vr[2][i / 4], i % 4), w3 = word(vr[3][i / 4], i % 4);
      const uint32_t av[4] = {
          __byte_perm(w0, w1, 0x5410), __byte_perm(w0, w1, 0x7632),
          __byte_perm(w2, w3, 0x5410), __byte_perm(w2, w3, 0x7632)};
      mma16816(acc[i], av, b0, b1);
    }
  }
  // the pair's partial: l summed over the slot lanes; m is already theirs
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 4);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 8);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 16);
  }
  // head_dim d and d + 1 (rows gid, gid + 8 of m-tile i) as one 8-byte
  // store into the swizzled row; pairs past the range hold no slot (pair
  // 0 stores the identity of an empty block)
  const int nw = max(1, min(kTcPairs, (hi - lo + kTcSlots - 1) / kTcSlots));
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int g = 2 * tig + c;
    if (g >= G || pair >= nw) continue;
    float* dst = wacc + (pair * GM + g) * HD;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int d = half * (HD / 2) + 64 * (i / 4) + 8 * gid + 2 * (i % 4);
      *reinterpret_cast<float2*>(dst + swz(g, d)) =
          make_float2(acc[i][c], acc[i][2 + c]);
    }
    if (half == 0 && gid == 0) {
      sh.wm[pair][g] = m[c];
      sh.wl[pair][g] = l[c];
    }
  }
  __syncthreads();
  block_fold<bf16, GM, kTcPairs, HD>(a, sh, wacc, cacc, cluster, n_split,
                                     rank, solo, nw, kvh, b, tid);
}

// GM: the group width the kernel is compiled for (G <= GM; rows past G
// are zero and never stored).  Two chunks a lane (float32 past hd 128)
// are compiled up to GM 8: the block's shared memory at hd 256 holds no
// more, and the registers of q and acc stay those of GM 8 at one chunk.
template <typename T, int NC, bool kPaged>
int dispatch_group(const DecodeArgs& a, int B, int KV, int n_split,
                   cudaStream_t st) {
  if (a.G == 1) return launch_decode<T, 1, NC, kPaged>(a, B, KV, n_split, st);
  if (a.G == 2) return launch_decode<T, 2, NC, kPaged>(a, B, KV, n_split, st);
  if (a.G == 3) return launch_decode<T, 3, NC, kPaged>(a, B, KV, n_split, st);
  if (a.G == 4) return launch_decode<T, 4, NC, kPaged>(a, B, KV, n_split, st);
  if (a.G <= 8) return launch_decode<T, 8, NC, kPaged>(a, B, KV, n_split, st);
  if constexpr (NC == 1) {
    if (a.G <= 16)
      return launch_decode<T, 16, NC, kPaged>(a, B, KV, n_split, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Validates what the kernel assumes and launches: dtype 0 = float32,
// 1 = bfloat16; hd a multiple of 8, at most 256; n_split a power of two
// up to 8 (a rank folds hd / n_split columns).
// lpr lanes take a row, a power of two up to a warp; a float32 row of
// more than 32 chunks (hd > 128) takes two chunks a lane.
template <bool kPaged>
int dispatch_dtype(int dtype, DecodeArgs a, int B, int KV, int n_split,
                   cudaStream_t stream) {
  if (a.hd < 8 || a.hd > 256 || a.hd % 8 || n_split < 1 ||
      n_split > kMaxSplits || (n_split & (n_split - 1)) || a.G < 1)
    return (int)cudaErrorInvalidValue;
  const int vec = dtype == 0 ? 4 : 8;
  const int chunks = a.hd / vec;
  int lpr = 1;
  while (lpr < chunks && lpr < 32) lpr *= 2;
  a.lpr = lpr;
  a.scale = 1.0f / sqrtf((float)a.hd);
  if (dtype == 0) {
    if (chunks > 32)
      return dispatch_group<float, 2, kPaged>(a, B, KV, n_split, stream);
    return dispatch_group<float, 1, kPaged>(a, B, KV, n_split, stream);
  }
  if (dtype == 1) {
    if (a.G <= 8 && a.hd == 128)
      return launch_clusters(decode_tc_kernel<128, kPaged>, a, 8, kPaged, B,
                             KV, n_split, stream);
    if (a.G <= 8 && a.hd == 256)
      return launch_clusters(decode_tc_kernel<256, kPaged>, a, 8, kPaged, B,
                             KV, n_split, stream);
    return dispatch_group<__nv_bfloat16, 1, kPaged>(a, B, KV, n_split,
                                                    stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
