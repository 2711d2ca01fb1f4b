// K4 and K5: batched GBDT ensemble scoring (the Clairvoyant predictor).
//
// K4 replaces the Pallas TPU kernel gbdt_margins_kernel /
// _gbdt_dense_kernel (src/repro/kernels/gbdt_infer.py).  Same function:
// every sample walks every complete binary tree (T, N) -- feature < 0
// marks a leaf, go left iff x < threshold, children of node i at 2i+1 /
// 2i+2 -- and tree t adds its leaf value to class t % K.
//
// K5 replaces gbdt_margins_packed_kernel / _gbdt_packed_kernel (same
// file): the same walk over the pruned (T, M) layout of
// core/ensemble_pack.py.  Every walk takes exactly `depth` steps,
// idx = child[idx] + !(x[feat[idx]] < thr[idx]); a leaf points at itself
// with a +inf threshold, so a finished walk stays put and there is no leaf
// branch.  The margins get base_score added after the tree sum.
//
// What bounds it on an H100: latency, not bytes or operations.  One
// admission needs ~12 KB of node fields out of a ~275 KB ensemble, but
// each level of a walk is a load that depends on the one before, and the
// class sums are a reduction over T trees.  A call costs the dependent
// steps between launch and the last store: each an L2 hit when the trees
// are warm, an HBM round trip when a decode has streamed its weights
// through the 50 MB L2 since the last admission.  The design takes out
// each chain of the earlier one-block-per-sample kernel:
//
//  * One thread per (tree, sample).  No thread walks two trees in series
//    (the earlier 128-thread block did, for T = 180): at B = 1 the 180
//    walks run at once, `depth` steps deep.  Past 256 walks a block, a
//    thread runs kIlp of them in lockstep, their loads interleaved.
//  * Trees split over a thread-block cluster.  Block `rank` of a cluster
//    of n = tree_split_plan(T, K) <= 8 blocks (kernels/gbdt_infer.py)
//    takes the trees [lo, hi), lo = (rank * G / n) * K, hi = ((rank + 1)
//    * G / n) * K for G = T / K groups: a range that starts on a multiple
//    of K, so tree lo + j has class j % K.  The plan depends on (T, K)
//    alone, never on B, so one admission scored alone equals its row of
//    any burst bit for bit.  One launch (cudaLaunchKernelEx with a
//    cluster dimension) covers every slice; at larger B the grid also
//    tiles the samples, 8 to 32 rows a block against the same staged
//    trees (the rows, like everything but the plan, may follow B: they
//    change no float operation of a row).
//  * The block's trees staged in shared memory first: one thread issues a
//    1-D TMA bulk copy (cp.async.bulk, completion on an mbarrier) per
//    node array, each the 16-byte-aligned span around the slice's rows
//    (the extra bytes lie in the same 16-byte granules as the slice's
//    first and last bytes, so they never leave a mapped page).  Every
//    walk step is then a shared-memory read: one round trip to L2 or HBM
//    for the whole slice instead of one per level, and no data-dependent
//    global load at all.  A slice that does not fit shared memory at once
//    (T = 1800 at N 127) streams in stages of whole trees through a
//    two-buffer ring, walking one while the next arrives; a tree too
//    large for half of shared memory is walked from global memory
//    instead.  The launcher fixes both from the shapes.
//  * K4's leaf marker without a divergent break: once a walk reaches a
//    leaf it keeps that index for the remaining levels.
//  * One fold, in one fixed order, with no atomics, no global scratch and
//    no second launch.  Each walk stores its leaf value into shared
//    memory; per (row, class) the slice's groups are summed in chunks of
//    w lanes (w: the largest slice's groups rounded up to a power of two,
//    at most 32, from (T, K) alone) by a butterfly of warp shuffles
//    (offsets w/2 .. 1, each lane adding its partner's value to its own),
//    the chunks in order.  Every block then stores its (rows, K) partial
//    into rank 0's shared memory at its rank, one cluster barrier
//    follows, and rank 0 folds the partials in rank order, adds
//    base_score (K5) and stores.  The earlier kernel summed 60 leaves a
//    class in series while 125 threads waited; here a class sum is
//    log2(w) shuffles plus n - 1 adds.
//  * Barriers: one block barrier once the features are in shared memory
//    (the tree copy is in flight), one before the fold, and the cluster
//    barrier of the merge, whose relaxed arrive at the start (waited on
//    before the remote stores) proves that rank 0 runs.
//
// K4 and K5 run one template: the same plan, the same fold and the same
// order of every float32 add, so on the same ensemble K5's margins equal
// K4's plus base_score bit for bit.  tree_fold in kernels/gbdt_infer.py
// states the fold in plain PyTorch.  The launchers allocate nothing and
// return the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxSlices = 8;           // the portable cluster size
constexpr int kMinRows = 8;             // sample rows a block walks ...
constexpr int kMaxRows = 32;            // ... between these
constexpr int kTiles = 32;              // row tiles before rows grow
constexpr int kMaxWarps = 8;
constexpr int kIlp = 2;                 // walks a thread runs in lockstep
constexpr int kSmemBytes = 227 * 1024;  // shared memory a block can have

struct Args {
  const float* X;          // (B, F)
  const void* arr[4];      // K4: feature, threshold, value; K5: feat, thr,
                           // child, value; each (T, W), 4-byte elements
  float* out;              // (B, K)
  int B, F, T, W, K, depth;
  int n;                   // tree slices: blocks of a cluster
  int rows;                // sample rows of a block's tile
  int stage_trees;         // trees a staging buffer holds (0: no staging)
  int leaf_stride;         // trees of the largest slice
  int fold_w;              // lanes that fold one (row, class)
  int off_xs, off_leaf, off_parts, off_stage, region;  // shared layout
  float base;              // K5's base score
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(1)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// First byte of tree `tree`'s row of array k in global memory.
__device__ __forceinline__ uintptr_t row_addr(const Args& a, int k,
                                              int tree) {
  return reinterpret_cast<uintptr_t>(a.arr[k]) + (uintptr_t)tree * a.W * 4;
}

// Thread 0: stage trees [tree0, tree0 + ntrees) of every node array into
// buffer `buf`, completing on `bar`: the 16-byte-aligned span around each
// array's rows goes to region k of the buffer.
template <int NA>
__device__ void issue_stage(const Args& a, unsigned char* buf, uint64_t* bar,
                            int tree0, int ntrees) {
  uintptr_t lo[NA];
  uint32_t len[NA], total = 0;
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    const uintptr_t s = row_addr(a, k, tree0);
    const uintptr_t e = s + (uintptr_t)ntrees * a.W * 4;
    lo[k] = s & ~(uintptr_t)15;
    len[k] = (uint32_t)(((e + 15) & ~(uintptr_t)15) - lo[k]);
    total += len[k];
  }
  mbar_expect(bar, total);
#pragma unroll
  for (int k = 0; k < NA; ++k)
    bulk_copy(buf + k * a.region, reinterpret_cast<const void*>(lo[k]),
              len[k], bar);
}

template <bool kStaged, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kStaged) return *p;
  else return __ldg(p);
}

// kIlp walks in lockstep, over trees tr[j] (slots tr[j] * W ... of the
// node arrays at `node`) for the samples whose features (in shared
// memory) start at x[j]: their loads interleave.  v[j] = the leaf value.
template <bool kPacked, bool kStaged>
__device__ __forceinline__ void walk(const void* const* node, int W,
                                     const int (&tr)[kIlp],
                                     const float* const (&x)[kIlp],
                                     int depth, float (&v)[kIlp]) {
  const int* feat = static_cast<const int*>(node[0]);
  const float* thr = static_cast<const float*>(node[1]);
  const float* val = static_cast<const float*>(node[kPacked ? 3 : 2]);
  int base[kIlp], idx[kIlp];
#pragma unroll
  for (int j = 0; j < kIlp; ++j) base[j] = tr[j] * W, idx[j] = 0;
  for (int s = 0; s < depth; ++s) {
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const int n = base[j] + idx[j];
      if constexpr (kPacked) {
        const int* child = static_cast<const int*>(node[2]);
        idx[j] = ld<kStaged>(child + n) +
                 (x[j][ld<kStaged>(feat + n)] < ld<kStaged>(thr + n) ? 0
                                                                     : 1);
      } else {
        const int f = ld<kStaged>(feat + n);
        const int nxt = x[j][max(f, 0)] < ld<kStaged>(thr + n)
                            ? 2 * idx[j] + 1 : 2 * idx[j] + 2;
        idx[j] = f < 0 ? idx[j] : nxt;   // a leaf keeps its index
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kIlp; ++j) v[j] = ld<kStaged>(val + base[j] + idx[j]);
}

template <bool kPacked, bool kStaged>
__global__ void __launch_bounds__(32 * kMaxWarps) gbdt_kernel(const Args a) {
  constexpr int NA = kPacked ? 4 : 3;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);       // [2]
  float* xs = reinterpret_cast<float*>(smem + a.off_xs);    // [rows][F]
  float* leaf = reinterpret_cast<float*>(smem + a.off_leaf);  // [rows][ls]
  float* parts = reinterpret_cast<float*>(smem + a.off_parts);  // [n][rows*K]
  unsigned char* stage = smem + a.off_stage;     // [2][NA][region]

  const int n = a.n, K = a.K, W = a.W;
  const int rank = (int)(blockIdx.x % n);        // == the cluster rank
  const int row0 = (int)(blockIdx.x / n) * a.rows;
  const int rows = min(a.rows, a.B - row0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int G = a.T / K;
  const int lo = (rank * G / n) * K, hi = ((rank + 1) * G / n) * K;
  const int nt = hi - lo;                        // trees of this slice
  const int st = kStaged ? a.stage_trees : nt;   // trees a stage walks
  const int n_stages = (nt + st - 1) / st;

  if (kStaged && tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < 2 && s < n_stages; ++s)
      issue_stage<NA>(a, stage + s * NA * a.region, &full[s], lo + s * st,
                      min(st, nt - s * st));
  }
  for (int i = tid; i < rows * a.F; i += nthr)
    xs[i] = a.X[(int64_t)row0 * a.F + i];
  // announce that this block runs; the matching wait, before the first
  // store into rank 0's shared memory, overlaps the walks
  if (n > 1) cluster_arrive_relaxed();
  __syncthreads();

  for (int s = 0; s < n_stages; ++s) {
    const int t0 = s * st, cnt = min(st, nt - t0);
    const void* base[NA];
    if (kStaged) {
      mbar_wait(&full[s & 1], (s >> 1) & 1);
      const unsigned char* buf = stage + (s & 1) * NA * a.region;
#pragma unroll
      for (int k = 0; k < NA; ++k)
        base[k] = buf + k * a.region + (row_addr(a, k, lo + t0) & 15);
    } else {
#pragma unroll
      for (int k = 0; k < NA; ++k)
        base[k] = reinterpret_cast<const void*>(row_addr(a, k, lo + t0));
    }
    // walk item i = (row i / cnt, tree i % cnt); each thread takes kIlp
    // items nthr apart at a time (a missing one repeats the first)
    const int items = rows * cnt;
    for (int i0 = tid; i0 < items; i0 += kIlp * nthr) {
      int tr[kIlp], r[kIlp];
      const float* x[kIlp];
      float v[kIlp];
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        const int i = i0 + j * nthr < items ? i0 + j * nthr : i0;
        r[j] = i / cnt, tr[j] = i - r[j] * cnt;
        x[j] = xs + r[j] * a.F;
      }
      walk<kPacked, kStaged>(base, W, tr, x, a.depth, v);
#pragma unroll
      for (int j = 0; j < kIlp; ++j)
        if (i0 + j * nthr < items)
          leaf[r[j] * a.leaf_stride + t0 + tr[j]] = v[j];
    }
    if (kStaged && s + 2 < n_stages) {
      __syncthreads();               // every walk of this buffer is done
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_stage<NA>(a, stage + (s & 1) * NA * a.region, &full[s & 1],
                        lo + (s + 2) * st, min(st, nt - (s + 2) * st));
      }
    }
  }
  __syncthreads();

  // per (row, class): the slice's groups in chunks of w lanes, each chunk
  // a butterfly of shuffles, the chunks in order
  const int w = a.fold_w, per_warp = 32 / w;
  const int lane = tid & 31, sub = lane / w, j = lane % w;
  const int groups = nt / K;
  const int items = rows * K;
  float* dst = parts;
  if (n > 1) {
    cluster_wait();                  // rank 0 has started
    dst = cg::this_cluster().map_shared_rank(parts, 0) + rank * a.rows * K;
  }
  for (int it0 = (tid >> 5) * per_warp; it0 < items;
       it0 += (nthr >> 5) * per_warp) {
    const int it = it0 + sub;        // whole warps stay in the loop
    const int r = it / K, c = it - r * K;
    float acc = 0.f;
    for (int g0 = 0; g0 < groups; g0 += w) {
      const int g = g0 + j;
      float v = (it < items && g < groups)
                    ? leaf[r * a.leaf_stride + g * K + c] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)   // unrolled; offsets >= w skipped
        if (o < w) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc = g0 == 0 ? v : acc + v;
    }
    if (j == 0 && it < items) {
      if (n > 1) dst[it] = acc;
      else a.out[(int64_t)row0 * K + it] = kPacked ? acc + a.base : acc;
    }
  }
  if (n == 1) return;
  cg::this_cluster().sync();         // every partial is in rank 0
  if (rank != 0) return;             // nothing reads this block any more
  for (int i = tid; i < items; i += nthr) {
    float s = parts[i];
    for (int r = 1; r < n; ++r) s += parts[r * a.rows * K + i];
    a.out[(int64_t)row0 * K + i] = kPacked ? s + a.base : s;
  }
}

size_t round16(size_t x) { return (x + 15) & ~(size_t)15; }

// The launch plan from the shapes, then one cluster launch.  n comes from
// tree_split_plan(T, K); rows, staging and block size from the rest.
template <bool kPacked>
int launch(Args a, cudaStream_t stream) {
  constexpr int NA = kPacked ? 4 : 3;
  const int G = a.K > 0 ? a.T / a.K : 0;
  if (a.K <= 0 || a.T <= 0 || a.T % a.K || a.n < 1 || a.n > kMaxSlices ||
      a.n > G || a.W <= 0 || a.F <= 0 || a.depth < 0 || a.B <= 0)
    return (int)cudaErrorInvalidValue;
  a.leaf_stride = (G + a.n - 1) / a.n * a.K;      // the largest slice
  const int groups = a.leaf_stride / a.K;
  a.fold_w = 1;
  while (a.fold_w < groups && a.fold_w < 32) a.fold_w *= 2;
  // rows of a tile: kMinRows until there are kTiles tiles (a cluster of
  // n blocks per tile: at T 180 ~256 blocks, two per SM), then more, up
  // to kMaxRows; fewer while the features, leaf values and partials
  // would take more than half of shared memory
  auto fixed = [&](int rows) {
    return round16(16 + sizeof(float) * (size_t)rows *
                            (a.F + a.leaf_stride + (size_t)a.n * a.K));
  };
  a.rows = (a.B + kTiles - 1) / kTiles;
  a.rows = a.rows < kMinRows ? kMinRows
           : a.rows > kMaxRows ? kMaxRows : a.rows;
  if (a.rows > a.B) a.rows = a.B;
  while (a.rows > 1 && fixed(a.rows) > kSmemBytes / 2)
    a.rows = (a.rows + 1) / 2;
  if (fixed(a.rows) > kSmemBytes) return (int)cudaErrorInvalidValue;
  // staging: the whole slice in one buffer if it fits, else a ring of two
  // buffers of whole trees, else (a tree larger than half of what is
  // left) walks straight from global memory
  const size_t avail = kSmemBytes - fixed(a.rows);
  const size_t tree_bytes = (size_t)a.W * 4;
  auto region = [&](int trees) { return round16(trees * tree_bytes) + 16; };
  int nbuf = 1;
  a.stage_trees = a.leaf_stride;
  if (NA * region(a.stage_trees) > avail) {
    nbuf = 2;
    const size_t per = avail / (2 * NA);
    a.stage_trees = per > 32 ? (int)((per - 32) / tree_bytes) : 0;
    if (a.stage_trees > a.leaf_stride) a.stage_trees = a.leaf_stride;
  }
  const bool staged = a.stage_trees > 0;
  a.region = staged ? (int)region(a.stage_trees) : 0;
  a.off_xs = 16;
  a.off_leaf = a.off_xs + (int)(sizeof(float) * a.rows * a.F);
  a.off_parts = a.off_leaf + (int)(sizeof(float) * a.rows * a.leaf_stride);
  a.off_stage = (int)round16(a.off_parts +
                             sizeof(float) * (size_t)a.n * a.rows * a.K);
  const size_t smem =
      a.off_stage + (staged ? (size_t)nbuf * NA * a.region : 0);
  // threads: one per (row, tree) of a stage, or enough warps to fold every
  // (row, class) at once, at most kMaxWarps warps
  const int walks = a.rows * (staged ? a.stage_trees : a.leaf_stride);
  const int folds = (a.rows * a.K + 32 / a.fold_w - 1) / (32 / a.fold_w);
  int warps = (walks + 31) / 32 > folds ? (walks + 31) / 32 : folds;
  if (warps > kMaxWarps) warps = kMaxWarps;
  const int tiles = (a.B + a.rows - 1) / a.rows;

  void (*kern)(Args) =
      staged ? &gbdt_kernel<kPacked, true> : &gbdt_kernel<kPacked, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.n * tiles), 1, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// X: (B, F) f32; feature: (T, N) int32; threshold, value: (T, N) f32;
// out: (B, K) f32; all contiguous.  depth = log2(N + 1) - 1; n_slices =
// tree_split_plan(T, K).
extern "C" int gbdt_margins_launch(const void* X, const void* feature,
                                   const void* threshold, const void* value,
                                   void* out, int B, int F, int T, int N,
                                   int K, int depth, int n_slices,
                                   void* stream) {
  Args a = {};
  a.X = static_cast<const float*>(X);
  a.arr[0] = feature;
  a.arr[1] = threshold;
  a.arr[2] = value;
  a.out = static_cast<float*>(out);
  a.B = B, a.F = F, a.T = T, a.W = N, a.K = K, a.depth = depth;
  a.n = n_slices;
  return launch<false>(a, static_cast<cudaStream_t>(stream));
}

// X: (B, F) f32; feat, child: (T, M) int32; thr, value: (T, M) f32; out:
// (B, K) f32; all contiguous.  Every feat entry is < F, and for finite
// features every walk from slot 0 stays inside its tree's M slots
// (core/ensemble_pack.py builds them so; the wrapper checks F).
extern "C" int gbdt_margins_packed_launch(const void* X, const void* feat,
                                          const void* thr, const void* child,
                                          const void* value, void* out, int B,
                                          int F, int T, int M, int K,
                                          int depth, int n_slices,
                                          float base_score, void* stream) {
  Args a = {};
  a.X = static_cast<const float*>(X);
  a.arr[0] = feat;
  a.arr[1] = thr;
  a.arr[2] = child;
  a.arr[3] = value;
  a.out = static_cast<float*>(out);
  a.B = B, a.F = F, a.T = T, a.W = M, a.K = K, a.depth = depth;
  a.n = n_slices;
  a.base = base_score;
  return launch<true>(a, static_cast<cudaStream_t>(stream));
}
