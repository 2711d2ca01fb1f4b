// K3b: the backward of causal (or full) flash attention, for training.
//
// The TPU side has no Pallas kernel for it: the JAX package takes the
// gradient of its chunked jnp flash attention (src/repro/models/
// attention.py:76-160) by autodiff through the nested jax.checkpoint of
// :119-131, "the flash-attention backward recurrence".  This kernel is
// that recurrence written out.  From q, k, v, the forward's output o,
// the output's gradient dO and K3's per-row log-sum-exp (lse):
//
//   P   = exp(q k^T * scale - lse)           (recomputed, never stored)
//   D   = rowsum(dO * o)                     (pass 1)
//   dP  = dO v^T,   dS = P * (dP - D)
//   dV  = P^T dO,   dK = scale * dS^T q      (pass 2, per key tile)
//   dQ  = scale * dS k                       (pass 3, per query tile)
//
// Shapes are the training ones: q/o/dO/dq (B, Sq, H, hd) and k/v/dk/dv
// (B, Skv, KV, hd), all contiguous with rows on 16-byte boundaries, GQA
// through kv head = h / G; lse and D are (B, H, Sq) f32.  Causal
// attention has Sq == Skv (query row i at key position i: the train step
// has no offset); full attention takes any Sq and Skv (cross-attention:
// Sq text rows over Skv image rows).  bf16 and f32 in, the input dtype
// out, every sum in f32; head widths 16, 32, 64, 128 and 256.
//
// What bounds it on an H100.  The function does five Sq x Skv x hd
// products per head (over the causal half when causal), 5 * 2 * B * H *
// hd * S^2 / 2 FLOPs causal (1.0e10 at B 8, S 512, H 15, hd 64: 10 us at
// the bf16 tensor-core peak) on 42 MB that must be read or written once
// (12.6 us at 3.35 TB/s): it sits near the ridge, and only the tensor
// cores reach either bound.  This design does seven products, not five,
// to stay deterministic (S and dP again in pass 3), and no atomics.
//
// Pass 1 (D), every dtype: L = min(hd / 8, 32) neighbouring lanes read a
// row's o and dO, 16 bytes each (hd / 8 / L chunks a lane, in order), and
// sum their partial dots by a butterfly of shuffles (one fixed order).
//
// bf16 (the training dtype) runs every product on the tensor cores, bf16
// in and f32 accumulate.  Rounding, either body: P and dS are computed in
// f32 and rounded to bf16 for the products that consume them (P^T for dV;
// dS^T for dK; dS for dQ), as the plain version does with
// round_dtype=torch.bfloat16; dK and dQ are scaled in f32 and every output
// is rounded to bf16 once, at its store.  A step whose tile crosses no
// row's diagonal and no end of Sq or Skv skips the per-element mask.  No
// atomics and fixed walks: two runs give the same bits.
//
// Head widths 64, 128 and 256 (smollm-360m, musicgen-large,
// llama-3.2-vision-90b's self- and cross-attention, gemma3-4b-edge):
// wgmma, from TMA-fed shared memory (wgmma_bf16.cuh).  The mma.sync body
// below lost 1.17-2.22x to autograd's SDPA backward there: ~240 registers
// a thread held one 8-warp block an SM, and at hd 128/256 128-256 pass-2
// blocks each walked up to 128 query steps in series.  This one runs at
// 0.74-1.00x of it on the trained stacks' shapes (scripts/k3b_timing.py).
//  * Pass 2 (dK, dV): one block per (key tile, KV head, batch row) and
//    query chunk, two consumer warpgroups, no producer warp (a ninth warp
//    would make ptxas budget 168 registers a thread: the roles spilled).
//    Warp 0 brings the block's K and V tiles, then, as step i begins,
//    step i + 1's Q and dO tiles (64 query rows of one head: 4-d tensor
//    maps over the model layout, 64-column boxes in the 128-byte swizzle;
//    rows past Sq come as zeros) into an mbarrier ring, and its lse and D
//    rows by cp.async completing on the same barrier.  A warpgroup holds
//    64 keys as wgmma's M rows: S^T = K Q^T and dP^T = V dO^T (m64n64,
//    both operands K-major from shared memory), P^T and dS^T per column
//    from lse and D, then dV += P^T dO and dK += dS^T Q (m64n{hd}, P^T and
//    dS^T from the accumulator registers as A fragments, dO and Q MN-major
//    through the transpose bit).  hd 64 and 128: the key tile is 128
//    keys, each warpgroup holds dK and dV of its 64 (128 f32 a thread at
//    hd 128: 254 registers; 192 at hd 64), and the two share each Q/dO
//    tile, so that one's products run while the other computes P and dS
//    (one warpgroup a block ran 1.2x slower).  hd 256: dK and dV would be
//    256 f32 a thread, so
//    the two warpgroups split the roles over one 64-key tile: role 0
//    computes S^T and P^T, hands P^T (f32, fragment order) to role 1
//    through a double buffer in shared memory under named barriers and
//    holds dV; role 1 computes dP^T, dS^T and holds dK (222 registers).
//    Each product runs once (PR 25's design computed S^T in both roles).
//  * The walk is split for the grid's sake: the (query head, query row)
//    pairs a key tile's keys see are cut by absolute query index into
//    chunks of query_chunk(Sq, G, causal) rows (about 32 steps of the G
//    heads when causal, 128 at full attention; at most 8 chunks), and
//    rank c of a thread-block cluster walks chunk c alone, from zero, head
//    by head, 64 rows a step (causal: from the key tile's first key; a
//    rank below it leaves at once).  The ranks store their partials in
//    their shared memory, and rank r adds its share of the fragment slots
//    from every rank's shared memory in chunk order (mbarriers in cluster
//    scope, no global scratch) and stores them.  Each key's dK/dV is the same sum in the same order
//    whatever the grid or the batch (flash_bwd_launch_plan and
//    flash_bwd_walk in kernels/flash_attention_bwd.py state the plan for
//    the tests).  The fold and the wait for the other ranks cost ~10-15
//    kcycles a block (scripts/k3b_phases.py), about four steps: causal
//    walks split, as their key tiles' walks differ up to G * Sq / 64
//    steps; equal ones at full attention mostly do not.
//  * Passes 2 and 3 need only pass 1's D: pass 2 runs on a side stream of
//    the highest priority, pass 3 on the caller's beside it, so that pass
//    3's short blocks fill the SMs that pass 2's clusters leave; the
//    caller's stream then waits for pass 2.
//  * Pass 3 (dQ): one block per 64 stacked rows (row r = query r / G,
//    head r % G) of one KV head, the causal tail's longest row tiles
//    first; the rows' Q and dO are staged once by cp.async into the
//    swizzle, the K/V tiles arrive by TMA into a ring, and one consumer
//    warpgroup walks them from key 0 in one fixed order: S = Q K^T, dP =
//    dO V^T, dS per row, dQ += dS K (K MN-major through the transpose
//    bit), dQ in f32 registers until its one store.  Each K/V tile is
//    fetched once per group, not G times.  Two blocks an SM at hd 64 and
//    128 (161 registers at 128); two warpgroups a block sharing each tile
//    ran slower.
//
// Head widths 16 and 32 (no model has them; the tests): mma.sync.m16n8k16,
// fragments through ldmatrix from shared memory rows padded by 16 bytes
// (free of bank conflicts), tiles brought by cp.async (16 bytes a thread;
// lse and D 4 bytes a thread) into two-stage rings, rows past Sq or Skv
// zero-filled:
//  * Pass 2 (dK, dV): one block per (64-key tile, KV head, batch row),
//    key tile 0 launched first (it walks the most query tiles when
//    causal), warps of 16 keys each.  A warp computes the transposed
//    tiles with its keys as the M rows: S^T = K Q^T and dP^T = V dO^T (K
//    and V the A operands, held in registers; Q and dO the B operands
//    from the ring), P^T and dS^T per column (query) from lse and D, then
//    dV += P^T dO and dK += dS^T Q with P^T and dS^T turned from
//    accumulator fragments straight into A fragments and Q, dO through
//    ldmatrix.trans.  The block walks the G query heads of the KV head,
//    each over the Sq query tiles that can see the key tile (from the
//    diagonal on when causal), in one fixed order.  Two groups of four
//    warps take the walk's steps in turn, each with its own ring and
//    named barrier, so that they drift apart and one group's products
//    overlap the other's P and dS.  dK and dV stay in f32 registers for
//    the whole walk (2 x hd / 2 floats a lane); group 1's sums are added
//    to group 0's, in that order, at the end.  No two blocks write one dK
//    or dV row.
//  * Pass 3 (dQ): the G query heads of a KV head stacked into rows, one
//    block per (128 stacked rows, KV head, batch row), the causal tail's
//    longest row tiles first.  A warp holds its 32 rows' Q and dO as A
//    fragments, walks 32-key tiles of Skv from tile 0 up to the last one
//    its rows can see, in one fixed order, computes S = Q K^T, dP = dO
//    V^T, dS, and dQ += dS K (K through ldmatrix.trans), each K and V
//    fragment serving both 16-row m-tiles, dQ in f32 registers until its
//    one store.
//
// float32 runs the three passes on the CUDA cores in full f32 (TF32
// would break the 1e-4 bar): pass 1 as above (4 floats a chunk), then
// 256-thread blocks that stage f32 tiles in shared memory (rows padded by
// one float), compute each TL x TL step's S and dP (a TL/16 x TL/16 patch
// a thread) into P and dS tiles, and update the hd * TL / 256
// accumulator entries of the one key (pass 2) or query row (pass 3, one
// block per head) each thread owns.  TL is 64, and 32 at hd 256, where
// four 64-row tiles of 257 floats would pass the 227 KiB a block may
// take.
//
// The launcher runs the three passes on the caller's stream (bf16 at hd
// 128 and 256: pass 2 on its side stream, joined back before it
// returns), allocates no device memory (D is a (B, H, Sq) f32 scratch the
// wrapper passes) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <mutex>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------------ pass 1
constexpr int kDotThreads = 256;

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       float) {
  const float* x = reinterpret_cast<const float*>(&a);
  const float* y = reinterpret_cast<const float*>(&b);
  float s = x[0] * y[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) s = fmaf(x[i], y[i], s);
  return s;
}

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       __nv_bfloat16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// lanes that share one row in pass 1: one 16-byte chunk each, at most a
// warp
template <int HD, typename T>
__host__ __device__ constexpr int dot_lanes() {
  return HD * (int)sizeof(T) / 16 < 32 ? HD * (int)sizeof(T) / 16 : 32;
}

// D[b, h, i] = sum_d dO[b, i, h, d] * o[b, i, h, d]: the L lanes of a row
// read 16 bytes each (neighbouring lanes, neighbouring addresses; NC
// chunks a lane, L chunks apart) and sum by a butterfly of shuffles; rows
// are (b, i, h) in memory order
template <int HD, typename T>
__global__ void __launch_bounds__(kDotThreads) bwd_dot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ D, int64_t rows, int Sq, int H) {
  constexpr int E = 16 / sizeof(T);      // elements a chunk
  constexpr int L = dot_lanes<HD, T>();  // lanes a row
  constexpr int NC = HD / E / L;         // chunks a lane
  static_assert(L >= 1 && (L & (L - 1)) == 0 && NC * L * E == HD,
                "lanes a row");
  const int64_t t = (int64_t)blockIdx.x * kDotThreads + threadIdx.x;
  const int64_t r = t / L;
  const int c = (int)(t % L) * E;
  float acc = 0.f;
  if (r < rows) {
    acc = dot16(*reinterpret_cast<const uint4*>(o + r * HD + c),
                *reinterpret_cast<const uint4*>(dout + r * HD + c), T());
#pragma unroll
    for (int j = 1; j < NC; ++j)
      acc += dot16(*reinterpret_cast<const uint4*>(o + r * HD + c + j * L * E),
                   *reinterpret_cast<const uint4*>(dout + r * HD + c +
                                                   j * L * E),
                   T());
  }
#pragma unroll
  for (int w = L / 2; w > 0; w /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (r < rows && c == 0) {
    const int h = (int)(r % H);
    const int64_t bs = r / H;
    const int i = (int)(bs % Sq);
    const int64_t b = bs / Sq;
    D[(b * H + h) * Sq + i] = acc;
  }
}

// ------------------------------------------------------ bf16, mma.sync
constexpr int kWarps = 4;    // a warp group: 16 keys or 16 MT rows a warp
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kDkdvThreads = 2 * kMmaThreads;    // pass 2: two groups
constexpr int kKeyTile = 16 * kWarps;    // pass 2's keys a block

template <int HD>
struct Tiles {
  static_assert(HD <= 32, "mma.sync passes: head widths 16 and 32");
  static constexpr int LD = HD + 8;      // padded smem row (elements)
  static constexpr int KS = HD / 16;     // k steps over hd
  static constexpr int CH = HD / 8;      // 16-byte chunks of a row
  static constexpr int QT = 64;          // pass 2's query step
  static constexpr int KT = 32;          // pass 3's key step
  static constexpr int MT = 2;           // pass 3's m-tiles a warp
  static constexpr int RT = 16 * MT * kWarps;      // pass 3's rows a block
  // pass 2's ring of one warp group: Q, dO [2][QT][LD]; lse, D [2][QT]
  static constexpr int kRingBytes =
      2 * 2 * QT * LD * (int)sizeof(__nv_bfloat16) + 2 * 2 * QT * 4;
};

// n_rows rows of head h from row r0 of a (B, S, heads, HD) bf16 tensor
// into a padded smem tile by cp.async, thread t of NT; rows past S are
// zero
template <int HD, int NT>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int b,
                                          int r0, int n_rows, int S,
                                          int heads, int h, int t) {
  using T = Tiles<HD>;
  for (int i = t; i < n_rows * T::CH; i += NT) {
    const int j = i / T::CH, c = (i % T::CH) * 8;
    const bool in = r0 + j < S;
    const int64_t row = in ? r0 + j : 0;
    cp_async16(dst + j * T::LD + c,
               src + (((int64_t)b * S + row) * heads + h) * HD + c, in);
  }
}

// S^T = K Q^T and dP^T = V dO^T for one warp's 16 keys against the
// step's QT query rows (the n axis): ka/va are the keys' A fragments
template <int HD>
__device__ __forceinline__ void kq_tile(
    float (&s)[Tiles<HD>::QT / 8][4], float (&dp)[Tiles<HD>::QT / 8][4],
    const uint32_t (&ka)[4], const uint32_t (&va)[4],
    const __nv_bfloat16* tq, const __nv_bfloat16* tdo, int kk, int lane) {
  using T = Tiles<HD>;
#pragma unroll
  for (int jp = 0; jp < T::QT / 16; ++jp) {
    const int at = (16 * jp + (lane / 16) * 8 + lane % 8) * T::LD + 16 * kk +
                   ((lane / 8) & 1) * 8;
    uint32_t r[4];
    ldsm_x4(r, tq + at);
    mma16816(s[2 * jp], ka, r[0], r[1]);
    mma16816(s[2 * jp + 1], ka, r[2], r[3]);
    ldsm_x4(r, tdo + at);
    mma16816(dp[2 * jp], va, r[0], r[1]);
    mma16816(dp[2 * jp + 1], va, r[2], r[3]);
  }
}

// pass 2's P^T (and, with kDS, dS^T) in place of S^T (and dP^T): entry
// (key, query) of the thread's fragments, lse and D per column from the
// step's smem
template <bool kMask, int NQ, bool kDS = true>
__device__ __forceinline__ void p_ds_cols(float (&s)[NQ][4],
                                          float (&dp)[NQ][4],
                                          const float* tl, const float* td,
                                          int key0, int q0, int tig, int Sq,
                                          int Skv, int causal,
                                          float scale_log2) {
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * n + 2 * tig + e;
      const float l2 = tl[col] * kLog2e;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float p = ex2(fmaf(s[n][2 * i + e], scale_log2, -l2));
        if (kMask) {
          const int key = key0 + 8 * i, query = q0 + col;
          if (key >= Skv || query >= Sq || (causal && key > query)) p = 0.f;
        }
        s[n][2 * i + e] = p;
        if constexpr (kDS) dp[n][2 * i + e] = p * (dp[n][2 * i + e] - td[col]);
      }
    }
  }
}

// acc[mt] (16 rows x hd) += f[mt] (16 x 16 kc, accumulator fragments
// turned into A fragments, rounded to bf16) x the first 16 kc rows of a
// padded smem tile through ldmatrix.trans, for a warp's MT m-tiles, each
// B fragment loaded once for all of them
template <int HD, int NK, int MT>
__device__ __forceinline__ void acc_product(
    float (&acc)[MT][HD / 8][4], const float (&f)[MT][NK][4],
    const __nv_bfloat16* tile, int lane) {
  constexpr int LD = Tiles<HD>::LD;
#pragma unroll
  for (int kc = 0; kc < NK / 2; ++kc) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(f[mt][2 * kc][0], f[mt][2 * kc][1]);
      a[mt][1] = pack_bf16(f[mt][2 * kc][2], f[mt][2 * kc][3]);
      a[mt][2] = pack_bf16(f[mt][2 * kc + 1][0], f[mt][2 * kc + 1][1]);
      a[mt][3] = pack_bf16(f[mt][2 * kc + 1][2], f[mt][2 * kc + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t r[4];
      ldsm_x4_t(r, tile + (16 * kc + ((lane / 8) & 1) * 8 + lane % 8) * LD +
                       16 * dp + (lane / 16) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(acc[mt][2 * dp], a[mt], r[0], r[1]);
        mma16816(acc[mt][2 * dp + 1], a[mt], r[2], r[3]);
      }
    }
  }
}

// the 128 threads of warp group g (0 or 1) of a pass-2 block wait for
// each other (named barrier 1 + g; barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(kMmaThreads));
}

// pass 2 at hd <= 64: dK, dV of one 64-key tile of one KV head (grid:
// KV * B, key tiles; key tile 0 first).  Two groups of four warps take
// the walk's steps in turn (group g the steps g, g + 2, ...), each with
// its own ring, its own barrier and its own dK/dV accumulators, so one
// group's products can run while the other computes P and dS; at the end
// group 1 hands its sums to group 0 through shared memory, which adds
// them in that order.
template <int HD>
__global__ void __launch_bounds__(kDkdvThreads) bwd_dkdv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ D, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H, int KV,
    int causal, float scale, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int LD = T::LD, KS = T::KS, QT = T::QT, NQ = QT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kKeyTile * LD;
  unsigned char* rings = reinterpret_cast<unsigned char*>(sV + kKeyTile * LD);

  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp / kWarps, gt = tid % kMmaThreads;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = H / KV, k0 = blockIdx.y * kKeyTile;
  const int kw0 = k0 + 16 * (warp % kWarps);
  const int qt0 = causal ? k0 / QT : 0;
  const int nqt = (Sq + QT - 1) / QT - qt0;
  const int n_steps = G * nqt, n_rounds = (n_steps + 1) / 2;
  // this group's ring: Q and dO [2][QT][LD], then lse and D [2][QT]
  __nv_bfloat16* sQ =
      reinterpret_cast<__nv_bfloat16*>(rings + grp * T::kRingBytes);
  __nv_bfloat16* sdO = sQ + 2 * QT * LD;
  float* sL = reinterpret_cast<float*>(sdO + 2 * QT * LD);
  float* sD = sL + 2 * QT;

  // the group's step st into its ring stage buf; past the walk, an empty
  // cp.async group, so every thread commits the same count
  auto load_step = [&](int st, int buf) {
    if (st < n_steps) {
      const int h = kvh * G + st / nqt, q0 = (qt0 + st % nqt) * QT;
      load_rows<HD, kMmaThreads>(sQ + buf * QT * LD, q, b, q0, QT, Sq, H, h,
                                 gt);
      load_rows<HD, kMmaThreads>(sdO + buf * QT * LD, dout, b, q0, QT, Sq, H,
                                 h, gt);
      if (gt < 2 * QT) {
        const int i = gt % QT, row = q0 + i;
        const bool in = row < Sq;
        const int64_t at = ((int64_t)b * H + h) * Sq + (in ? row : 0);
        if (gt < QT)
          cp_async4(sL + buf * QT + i, lse + at, in);
        else
          cp_async4(sD + buf * QT + i, D + at, in);
      }
    }
    cp_async_commit();
  };

  load_rows<HD, kDkdvThreads>(sK, k, b, k0, kKeyTile, Skv, KV, kvh, tid);
  load_rows<HD, kDkdvThreads>(sV, v, b, k0, kKeyTile, Skv, KV, kvh, tid);
  cp_async_commit();
  load_step(grp, 0);
  cp_async_wait<1>();                    // K and V are in
  __syncthreads();
  const __nv_bfloat16* wk = sK + 16 * (warp % kWarps) * LD;
  const __nv_bfloat16* wv = sV + 16 * (warp % kWarps) * LD;
  const int a_at = (lane % 16) * LD + (lane / 16) * 8;
  // K and V as A fragments, all of hd held
  uint32_t ka[KS][4], va[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldsm_x4(ka[kk], wk + a_at + 16 * kk);
    ldsm_x4(va[kk], wv + a_at + 16 * kk);
  }

  float adk[1][HD / 8][4], adv[1][HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) adk[0][n][j] = adv[0][n][j] = 0.f;
  }
  for (int rd = 0; rd < n_rounds; ++rd) {
    if (rd + 1 < n_rounds) {
      load_step(2 * (rd + 1) + grp, (rd + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_sync(grp);                     // the round's tiles visible
    const int st = 2 * rd + grp, buf = rd & 1;
    const int q0 = (qt0 + st % nqt) * QT;
    // a warp whose keys are all past Skv, or all past the step's last
    // query when causal, has nothing to add
    if (st < n_steps && kw0 < Skv && (!causal || kw0 <= q0 + QT - 1)) {
      const __nv_bfloat16* tq = sQ + buf * QT * LD;
      const __nv_bfloat16* tdo = sdO + buf * QT * LD;
      float s[1][NQ][4], dp[1][NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[0][n][j] = dp[0][n][j] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        kq_tile<HD>(s[0], dp[0], ka[kk], va[kk], tq, tdo, kk, lane);
      const float* tl = sL + buf * QT;
      const float* td = sD + buf * QT;
      if (kw0 + 16 > Skv || q0 + QT > Sq || (causal && kw0 + 15 > q0)) {
        p_ds_cols<true, NQ>(s[0], dp[0], tl, td, kw0 + gid, q0, tig, Sq, Skv,
                            causal, scale_log2);
      } else {
        p_ds_cols<false, NQ>(s[0], dp[0], tl, td, kw0 + gid, q0, tig, Sq,
                             Skv, causal, scale_log2);
      }
      acc_product<HD, NQ, 1>(adv, s, tdo, lane);    // dV += P^T dO
      acc_product<HD, NQ, 1>(adk, dp, tq, lane);    // dK += dS^T Q
    }
    group_sync(grp);                     // the ring stage is free again
  }
  __syncthreads();                       // both groups are done
  // group 1's sums into the free rings, [value][thread] so that the
  // stores are conflict-free; group 0 adds them to its own and stores
  float* part = reinterpret_cast<float*>(rings);
  static_assert(HD * kMmaThreads * sizeof(float) <= 2 * T::kRingBytes,
                "the rings hold the hand-over");
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        part[(4 * n + j) * kMmaThreads + gt] = adk[0][n][j];
        part[(HD / 2 + 4 * n + j) * kMmaThreads + gt] = adv[0][n][j];
      }
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw0 + gid + 8 * i;
    if (key >= Skv) continue;
    const int64_t at = (((int64_t)b * Skv + key) * KV + kvh) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float* pk = part + (4 * n + 2 * i) * kMmaThreads + gt;
      const float* pv = part + (HD / 2 + 4 * n + 2 * i) * kMmaThreads + gt;
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n) =
          pack_bf16((adk[0][n][2 * i] + pk[0]) * scale,
                    (adk[0][n][2 * i + 1] + pk[kMmaThreads]) * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n) =
          pack_bf16(adv[0][n][2 * i] + pv[0],
                    adv[0][n][2 * i + 1] + pv[kMmaThreads]);
    }
  }
}

// pass 3: dQ of RT stacked rows (query r / G, head r % G) of one KV head,
// 16 MT a warp (grid: KV * B, row tiles; when causal the last row tile
// first)
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ D, __nv_bfloat16* __restrict__ dq, int Sq,
    int Skv, int H, int KV, int causal, float scale, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int LD = T::LD, KS = T::KS, KT = T::KT, NK = KT / 8;
  constexpr int MT = T::MT, RT = T::RT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + 2 * KT * LD;            // [2][KT][LD] each

  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = H / KV, rows = G * Sq;
  const int rt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r_blk = rt * RT, r_warp = r_blk + 16 * MT * warp;

  auto load_tile = [&](int t, int buf) {
    load_rows<HD, kMmaThreads>(sK + buf * KT * LD, k, b, t * KT, KT, Skv, KV,
                               kvh, tid);
    load_rows<HD, kMmaThreads>(sV + buf * KT * LD, v, b, t * KT, KT, Skv, KV,
                               kvh, tid);
    cp_async_commit();
  };
  load_tile(0, 0);                       // in flight while Q, dO load

  // this thread's rows: gid and gid + 8 of each of the warp's m-tiles
  bool live[MT][2];
  int pos[MT][2];
  float l2[MT][2], dd[MT][2];
  __nv_bfloat16* dqp[MT][2];
  // Q and dO as A fragments
  uint32_t qa[MT][KS][4], oa[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_warp + 16 * mt + gid + 8 * i;
      const bool in = r < rows;
      const int qrow = in ? r / G : 0, h = kvh * G + (in ? r % G : 0);
      const int64_t row_at = (((int64_t)b * Sq + qrow) * H + h) * HD;
      const int64_t at = ((int64_t)b * H + h) * Sq + qrow;
      live[mt][i] = in;
      pos[mt][i] = qrow;
      l2[mt][i] = in ? lse[at] * kLog2e : 0.f;
      dd[mt][i] = in ? D[at] : 0.f;
      dqp[mt][i] = dq + row_at;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int d = 16 * kk + 2 * tig + 8 * hf;
          qa[mt][kk][i + 2 * hf] =
              in ? *reinterpret_cast<const uint32_t*>(q + row_at + d) : 0;
          oa[mt][kk][i + 2 * hf] =
              in ? *reinterpret_cast<const uint32_t*>(dout + row_at + d) : 0;
        }
      }
    }
  }
  // causal: up to the key tile of the block's last live row's position
  const int r_last = min(r_blk + RT, rows) - 1;
  const int n_kt = causal ? (r_last / G) / KT + 1 : (Skv + KT - 1) / KT;
  const bool warp_live = r_warp < rows;
  const int warp_first_pos = r_warp / G;
  const int warp_last_pos = (min(r_warp + 16 * MT, rows) - 1) / G;

  float acc[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][n][j] = 0.f;
    }
  }
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) {
      load_tile(t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                     // the tile visible to all warps
    const int c0 = t * KT;
    if (warp_live && (!causal || c0 <= warp_last_pos)) {
      const __nv_bfloat16* tk = sK + (t & 1) * KT * LD;
      const __nv_bfloat16* tv = sV + (t & 1) * KT * LD;
      float s[MT][NK][4], dp[MT][NK][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NK; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[mt][n][j] = dp[mt][n][j] = 0.f;
        }
      }
      // S = Q K^T, dP = dO V^T: ldmatrix x4 gives b0/b1 of two n-tiles,
      // used by every m-tile
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int jp = 0; jp < KT / 16; ++jp) {
          const int at = (16 * jp + (lane / 16) * 8 + lane % 8) * LD +
                         16 * kk + ((lane / 8) & 1) * 8;
          uint32_t r[4];
          ldsm_x4(r, tk + at);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(s[mt][2 * jp], qa[mt][kk], r[0], r[1]);
            mma16816(s[mt][2 * jp + 1], qa[mt][kk], r[2], r[3]);
          }
          ldsm_x4(r, tv + at);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(dp[mt][2 * jp], oa[mt][kk], r[0], r[1]);
            mma16816(dp[mt][2 * jp + 1], oa[mt][kk], r[2], r[3]);
          }
        }
      }
      // dS per row (its lse and D in registers); a masked entry is 0
      const bool mask =
          c0 + KT > Skv || (causal && c0 + KT - 1 > warp_first_pos);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NK; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = j / 2, key = c0 + 8 * n + 2 * tig + (j & 1);
            float p = ex2(fmaf(s[mt][n][j], scale_log2, -l2[mt][i]));
            if (mask && (key >= Skv || (causal && key > pos[mt][i]))) p = 0.f;
            dp[mt][n][j] = p * (dp[mt][n][j] - dd[mt][i]);
          }
        }
      }
      acc_product<HD, NK, MT>(acc, dp, tk, lane);   // dQ += dS K
    }
    __syncthreads();                     // the ring stage is free again
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[mt][i]) continue;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(dqp[mt][i] + 8 * n + 2 * tig) =
            pack_bf16(acc[mt][n][2 * i] * scale,
                      acc[mt][n][2 * i + 1] * scale);
    }
  }
}

// ------------------------------------------ bf16 at hd 128 and 256, wgmma
constexpr int kWg = 64;          // keys of a pass-2 block or a pass-3 step,
                                 // query rows of a pass-2 step, stacked
                                 // rows of a pass-3 block
constexpr int kChunkSteps = 32;  // a causal partial's steps (CHUNK_STEPS)
constexpr int kMaxSplits = 8;    // the portable cluster size
constexpr int kSlab = 64 * 128;  // 64 rows of 128 bytes: one swizzled slab

// Query rows of one pass-2 partial (query_chunk in
// kernels/flash_attention_bwd.py), from the model's shape alone: about
// kChunkSteps 64-row steps of its G heads when causal, where the key
// tiles' walks differ (the first one walks every query row) and splitting
// them evens the blocks out; four times that at full attention, where
// every key tile walks the same rows and a split mostly adds its fold;
// widened where Sq would take more than kMaxSplits.  Chunk c is query
// rows [c * chunk, (c + 1) * chunk), whatever the key tile.
__host__ __device__ inline int query_chunk(int Sq, int G, int causal) {
  const int steps = causal ? kChunkSteps : 4 * kChunkSteps;
  const int chunk = kWg * ((steps + G - 1) / G);
  const int tiles = (Sq + kWg - 1) / kWg;
  const int least = kWg * ((tiles + kMaxSplits - 1) / kMaxSplits);
  return chunk > least ? chunk : least;
}

// Pass 2's shared memory, in bytes from a 1024-byte aligned base: the
// block's K and V tiles (kSlabs slabs of 64 rows x 64 columns, one TMA box
// each), a ring of Q and dO tiles, at hd 256 two P^T hand-over buffers
// (fragment order, f32), the ring's lse and D rows, the barriers.  After
// the walk the ring holds the block's partial of the fold.
template <int HD>
struct DkdvCfg {
  // two consumer warpgroups: at hd 128 each holds dK and dV of its own 64
  // keys (2 x 64 f32 a thread), so that one's products overlap the
  // other's P and dS; at hd 256 (128 f32 each) they split the roles over
  // one 64-key group, role 0 dV and role 1 dK.  No producer warp: warp 0
  // issues the loads, so that the block is 8 warps and ptxas may give a
  // thread 255 registers (with a ninth warp it budgets for 12, 168 each,
  // and spills)
  static constexpr bool kSplitRoles = HD > 128;
  static constexpr int kKeyGroups = kSplitRoles ? 1 : 2;
  static constexpr int kKeys = kWg * kKeyGroups;   // keys a block
  static constexpr int kThreads = 256;
  static constexpr int kSlabs = HD / 64;
  static constexpr int kTile = kSlabs * kSlab;     // 64 rows x HD, bytes
  static constexpr int kStages = HD > 128 ? 2 : 3;
  static constexpr int kK = 0;                     // [key group] tiles
  static constexpr int kV = kKeyGroups * kTile;
  static constexpr int kRing = 2 * kKeyGroups * kTile;   // stage: Q, dO
  static constexpr int kHand = kRing + kStages * 2 * kTile;
  static constexpr int kHandBytes = kSplitRoles ? 2 * 8 * 128 * 16 : 0;
  static constexpr int kLD = kHand + kHandBytes;   // [stage][lse, D][64]
  static constexpr int kBar = kLD + kStages * 2 * kWg * 4;
  static constexpr int kSmem = kBar + 8 * (2 * kStages + 3);
  // the fold's partial, [slot][thread] float4: dV and dK of the block's keys
  static constexpr int kPartBytes = 2 * kKeyGroups * (HD / 8) * 128 * 16;
  static_assert(kPartBytes <= kHand, "K, V and the ring hold the partial");
  static_assert(kSmem <= 232448, "the block fits in shared memory");
};

// Pass 3's shared memory: the block's stacked Q and dO tiles (staged once
// by cp.async into the swizzle), a ring of K and V tiles, the barriers.
template <int HD>
struct DqCfg {
  static constexpr int kThreads = 128 + 32;
  static constexpr int kBlocksPerSM = HD > 128 ? 1 : 2;
  static constexpr int kSlabs = HD / 64;
  static constexpr int kTile = kSlabs * kSlab;
  static constexpr int kStages = 2;
  static constexpr int kQ = 0;
  static constexpr int kdO = kTile;
  static constexpr int kRing = 2 * kTile;          // stage s: K, then V
  static constexpr int kBar = kRing + kStages * 2 * kTile;
  static constexpr int kSmem = kBar + 8 * 2 * kStages;
  static_assert(kBlocksPerSM * (kSmem + 1024) <= 233472,
                "the blocks fit an SM");
};

// d = A (64 rows x HD, shared memory at a, K-major) * B^T (64 rows x HD at
// b, K-major): 64 x 64 f32 accumulators, HD / 16 k steps of 32 bytes, one
// commit group
template <int HD>
__device__ __forceinline__ void wg_rows_product(float (&d)[8][4], uint32_t a,
                                                uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
    wgmma_ss_n64(d, sw128_desc(a + off, 16, 1024),
                 sw128_desc(b + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// d (64 x HD) += A (64 x 16, registers) * B (16 x HD, shared memory,
// MN-major)
template <int HD>
__device__ __forceinline__ void wg_rs(float (&d)[HD / 8][4],
                                      const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (HD == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n256(d, a, db);
  }
}

// acc (64 x HD) += F (64 x 64: accumulator fragments, rounded to bf16 as
// A fragments) * the 64 x HD tile at `tile` (MN-major through the
// transpose bit: 16 rows, 2048 bytes, a k step); at hd 256 the four steps
// go in two groups, so that 8 A registers stay live instead of 16
template <int HD>
__device__ __forceinline__ void wg_acc_product(float (&acc)[HD / 8][4],
                                               const float (&f)[8][4],
                                               uint32_t tile) {
  constexpr int kGroups = HD > 128 ? 2 : 1;
  constexpr int kSteps = 4 / kGroups;
#pragma unroll
  for (int grp = 0; grp < kGroups; ++grp) {
    uint32_t a[kSteps][4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int kc = grp * kSteps + j;
      a[j][0] = pack_bf16(f[2 * kc][0], f[2 * kc][1]);
      a[j][1] = pack_bf16(f[2 * kc][2], f[2 * kc][3]);
      a[j][2] = pack_bf16(f[2 * kc + 1][0], f[2 * kc + 1][1]);
      a[j][3] = pack_bf16(f[2 * kc + 1][2], f[2 * kc + 1][3]);
    }
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const uint64_t db =
          sw128_desc(tile + (grp * kSteps + j) * 2048, kSlab, 1024);
      wg_rs<HD>(acc, a[j], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(a);
  }
}

// the two products of a pass-2 step at hd <= 128 in one commit group: acc0
// += F0 * tile0 (dV += P^T dO) and acc1 += F1 * tile1 (dK += dS^T Q), as
// wg_acc_product does each
template <int HD>
__device__ __forceinline__ void wg_acc_pair(float (&acc0)[HD / 8][4],
                                            const float (&f0)[8][4],
                                            uint32_t tile0,
                                            float (&acc1)[HD / 8][4],
                                            const float (&f1)[8][4],
                                            uint32_t tile1) {
  static_assert(HD <= 128, "two accumulators a thread up to hd 128");
  uint32_t a0[4][4], a1[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a0[kc][0] = pack_bf16(f0[2 * kc][0], f0[2 * kc][1]);
    a0[kc][1] = pack_bf16(f0[2 * kc][2], f0[2 * kc][3]);
    a0[kc][2] = pack_bf16(f0[2 * kc + 1][0], f0[2 * kc + 1][1]);
    a0[kc][3] = pack_bf16(f0[2 * kc + 1][2], f0[2 * kc + 1][3]);
    a1[kc][0] = pack_bf16(f1[2 * kc][0], f1[2 * kc][1]);
    a1[kc][1] = pack_bf16(f1[2 * kc][2], f1[2 * kc][3]);
    a1[kc][2] = pack_bf16(f1[2 * kc + 1][0], f1[2 * kc + 1][1]);
    a1[kc][3] = pack_bf16(f1[2 * kc + 1][2], f1[2 * kc + 1][3]);
  }
  reg_fence(acc0);
  reg_fence(acc1);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wg_rs<HD>(acc0, a0[kc], sw128_desc(tile0 + kc * 2048, kSlab, 1024));
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wg_rs<HD>(acc1, a1[kc], sw128_desc(tile1 + kc * 2048, kSlab, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc0);
  reg_fence(acc1);
  reg_fence(a0);
  reg_fence(a1);
}

template <int HD>
__device__ __forceinline__ void zero_acc(float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// pass 2: dK, dV of one key tile (128 keys at hd 128, 64 at hd 256) of one
// KV head (grid: n_split x KV, B, key tiles; a cluster of n_split blocks
// along x).  Rank r walks query chunk r (query_chunk rows of every query
// head of the KV head, from the key tile's diagonal when causal) in one
// fixed order, head by head, 64 rows a step.  A key tile whose keys see
// several chunks folds their partials in chunk order: each rank stores
// its partial in its shared memory, and rank r adds, in chunk order, the
// partials of its share of the fragment slots from every rank's shared
// memory and stores those.  A rank below the key tile's first chunk has
// nothing to walk and leaves.
template <int HD>
__global__ void __launch_bounds__(DkdvCfg<HD>::kThreads, 1)
    bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ D,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                          int H, int KV, int causal, float scale,
                          float scale_log2) {
  using Cfg = DkdvCfg<HD>;
  constexpr int kStages = Cfg::kStages, J = HD / 8;
  constexpr bool kSplitRoles = Cfg::kSplitRoles;
  // fragment slots a warpgroup holds: (role, j) at hd 128, j at hd 256
  constexpr int kSlots = kSplitRoles ? J : 2 * J;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* smem = wg_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_ready = empty + kStages;
  uint64_t* ready = kv_ready + 1;        // every active rank's partial
  uint64_t* done = ready + 1;            // every active rank has read it
  const int n_split = (int)cluster_size(), rank = (int)cluster_rank();
  const int kvh = blockIdx.x / n_split, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KV, k0 = blockIdx.z * Cfg::kKeys;
  const int chunk = query_chunk(Sq, G, causal);
  // the key tile's partials: chunks c_lo .. n_split - 1 (causal: from the
  // chunk of its first key, the first query row that sees it)
  const int c_lo = causal ? k0 / chunk : 0;
  const int n_active = n_split - c_lo;
  // this rank's query tiles of each head: those of chunk `rank` that see
  // the key tile
  const int qt_lo = max(rank * chunk, causal ? k0 : 0) / kWg;
  const int qt_hi = min((rank + 1) * chunk, Sq + kWg - 1) / kWg;
  const int n_qt = max(qt_hi - qt_lo, 0);
  const int n_steps = G * n_qt;

  if (tid == 0) {
    if ((__cvta_generic_to_shared(smem) & 1023) != 0) __trap();
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);       // the TMA's expect, 32 cp.async lanes
      mbar_init(&empty[s], 2);           // both warpgroups
    }
    mbar_init(kv_ready, 1);
    mbar_init(ready, n_active > 0 ? n_active : 1);
    mbar_init(done, n_active > 0 ? n_active : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every barrier is initialised before any block of the cluster uses it
  if (n_split > 1) {
    cluster_sync_all();
  } else {
    __syncthreads();
  }
  if (rank < c_lo) return;               // no query row of this chunk sees it

  // the producer's work, by warp 0: the block's K and V, then step i's Q
  // and dO by TMA and its lse and D rows by cp.async (rows past Sq as
  // zeros), into ring stage i % kStages once both warpgroups are done
  // with it.  Warp 0 issues step i + 1's loads as step i begins.
  auto produce = [&](int i) {
    const int s = i % kStages;
    const int h = kvh * G + i / n_qt, q0 = (qt_lo + i % n_qt) * kWg;
    mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
    unsigned char* st = smem + Cfg::kRing + s * 2 * Cfg::kTile;
    if (lane == 0) {
      mbar_expect(&full[s], 2 * Cfg::kTile);
#pragma unroll
      for (int sl = 0; sl < Cfg::kSlabs; ++sl) {
        tma_load_4d(st + sl * kSlab, &tq, 64 * sl, h, q0, b, &full[s]);
        tma_load_4d(st + Cfg::kTile + sl * kSlab, &tdo, 64 * sl, h, q0, b,
                    &full[s]);
      }
    }
    float* ld = reinterpret_cast<float*>(smem + Cfg::kLD) + s * 2 * kWg;
    const int64_t at = ((int64_t)b * H + h) * Sq;
#pragma unroll
    for (int j = lane; j < kWg; j += 32) {
      const bool in = q0 + j < Sq;
      cp_async4(ld + j, lse + at + (in ? q0 + j : 0), in);
      cp_async4(ld + kWg + j, D + at + (in ? q0 + j : 0), in);
    }
    cp_async_mbar_arrive(&full[s]);
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_expect(kv_ready, 2 * Cfg::kKeyGroups * Cfg::kTile);
#pragma unroll
      for (int g = 0; g < Cfg::kKeyGroups; ++g)
#pragma unroll
        for (int sl = 0; sl < Cfg::kSlabs; ++sl) {
          const int off = g * Cfg::kTile + sl * kSlab;
          tma_load_4d(smem + Cfg::kK + off, &tk, 64 * sl, kvh, k0 + kWg * g,
                      b, kv_ready);
          tma_load_4d(smem + Cfg::kV + off, &tv, 64 * sl, kvh, k0 + kWg * g,
                      b, kv_ready);
        }
    }
    if (n_steps > 0) produce(0);
  }

  // consumers: warpgroup wg's warp w holds 16 keys (the M rows): at hd
  // 128 keys k0 + 64 wg + 16 w .., at hd 256 k0 + 16 w .. in both roles;
  // its thread's fragments rows gid and gid + 8, columns (query rows of
  // the step) 8 n + 2 tig and + 1
  const int wg = tid / 128, ctid = tid % 128, w = ctid / 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int kg = kSplitRoles ? 0 : wg;   // the warpgroup's 64-key group
  const int kw0 = k0 + kWg * kg + 16 * w;
  const uint32_t kb = smem_u32(smem + Cfg::kK + kg * Cfg::kTile);
  const uint32_t vb = smem_u32(smem + Cfg::kV + kg * Cfg::kTile);
  float4* hand = reinterpret_cast<float4*>(smem + Cfg::kHand);
  // hd 128: acc[0] dV, acc[1] dK; hd 256: acc[0] is role wg's (0 dV, 1 dK)
  constexpr int kAcc = kSplitRoles ? 1 : 2;
  float acc[kAcc][J][4];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) zero_acc<HD>(acc[r]);
  mbar_wait(kv_ready, 0);
  for (int i = 0; i < n_steps; ++i) {
    if (warp == 0 && i + 1 < n_steps) produce(i + 1);
    const int s = i % kStages;
    const int q0 = (qt_lo + i % n_qt) * kWg;
    const uint32_t qb = smem_u32(smem + Cfg::kRing + s * 2 * Cfg::kTile);
    const uint32_t dob = qb + Cfg::kTile;
    const float* ld = reinterpret_cast<const float*>(smem + Cfg::kLD) +
                      s * 2 * kWg;
    // a step whose tile crosses no end and (causal) no diagonal of the
    // warp's keys skips the per-element mask
    const bool mask =
        kw0 + 16 > Skv || q0 + kWg > Sq || (causal && kw0 + 15 > q0);
    mbar_wait(&full[s], (i / kStages) & 1);
    float st[8][4], dpt[8][4];
    if constexpr (!kSplitRoles) {
      // S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T per column
      wgmma_fence();
      wg_rows_product<HD>(st, kb, qb);
      wg_rows_product<HD>(dpt, vb, dob);
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);
      if (mask) {
        p_ds_cols<true, 8>(st, dpt, ld, ld + kWg, kw0 + gid, q0, tig, Sq,
                           Skv, causal, scale_log2);
      } else {
        p_ds_cols<false, 8>(st, dpt, ld, ld + kWg, kw0 + gid, q0, tig, Sq,
                            Skv, causal, scale_log2);
      }
      wg_acc_pair<HD>(acc[0], st, dob, acc[1], dpt, qb);   // dV, dK
    } else if (wg == 0) {
      // role 0: S^T = K Q^T and P^T, handed to role 1, then dV += P^T dO
      wgmma_fence();
      wg_rows_product<HD>(st, kb, qb);
      wgmma_wait<0>();
      reg_fence(st);
      if (mask) {
        p_ds_cols<true, 8, false>(st, st, ld, ld, kw0 + gid, q0, tig, Sq,
                                  Skv, causal, scale_log2);
      } else {
        p_ds_cols<false, 8, false>(st, st, ld, ld, kw0 + gid, q0, tig, Sq,
                                   Skv, causal, scale_log2);
      }
      const int hb = i & 1;
      if (i >= 2) named_sync(4 + hb, 256);   // role 1 has read step i - 2's
      float4* hp = hand + hb * 8 * 128;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        hp[n * 128 + ctid] = make_float4(st[n][0], st[n][1], st[n][2],
                                         st[n][3]);
      named_arrive(2 + hb, 256);
      wg_acc_product<HD>(acc[0], st, dob);       // dV += P^T dO
    } else {
      // role 1: dP^T = V dO^T, P^T from role 0, dS^T, dK += dS^T Q
      wgmma_fence();
      wg_rows_product<HD>(dpt, vb, dob);
      wgmma_wait<0>();
      reg_fence(dpt);
      const int hb = i & 1;
      named_sync(2 + hb, 256);               // step i's P^T is in buffer hb
      const float4* hp = hand + hb * 8 * 128;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 p = hp[n * 128 + ctid];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[n][e] = pv[e] * (dpt[n][e] - ld[kWg + 8 * n + 2 * tig + (e & 1)]);
      }
      if (i + 2 < n_steps) named_arrive(4 + hb, 256);
      wg_acc_product<HD>(acc[0], dpt, qb);       // dK += dS^T Q
    }
    if (ctid == 0) mbar_arrive(&empty[s]);   // the stage may be refilled
  }

  // fragment slot sl (0 .. 2 kSlots - 1), held by warpgroup sl / kSlots:
  // its thread ctid's keys kw0 + gid (+ 8) of that warpgroup, columns 8 j
  // + 2 tig (+ 1) of dV (role 0) or dK (role 1, scaled)
  auto store_slot = [&](int sl, float4 x) {
    const int owner = sl / kSlots, local = sl % kSlots;
    const int role = kSplitRoles ? owner : local / J, j = local % J;
    __nv_bfloat16* out = role == 0 ? dv : dk;
    const float mul = role == 0 ? 1.f : scale;
    const int key0 = k0 + kWg * (kSplitRoles ? 0 : owner) + 16 * w + gid;
    const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= Skv) continue;
      *reinterpret_cast<uint32_t*>(
          out + (((int64_t)b * Skv + key) * KV + kvh) * HD + 8 * j +
          2 * tig) = pack_bf16(e[2 * i] * mul, e[2 * i + 1] * mul);
    }
  };
  auto slot_value = [&](int r, int j) {
    return make_float4(acc[r][j][0], acc[r][j][1], acc[r][j][2],
                       acc[r][j][3]);
  };
  if (n_active == 1) {                   // one partial: the sums as they are
#pragma unroll
    for (int r = 0; r < kAcc; ++r)
#pragma unroll
      for (int j = 0; j < J; ++j)
        store_slot(wg * kSlots + r * J + j, slot_value(r, j));
    return;
  }
  // the partial into the block's shared memory (K, V and the ring, free
  // once every consumer is done with them), [slot][thread]
  float4* part = reinterpret_cast<float4*>(smem);
  named_sync(1, 256);
  fence_proxy_async();
#pragma unroll
  for (int r = 0; r < kAcc; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j)
      part[(wg * kSlots + r * J + j) * 128 + ctid] = slot_value(r, j);
  named_sync(1, 256);
  if (tid == 0)
    for (int c = c_lo; c < n_split; ++c) mbar_arrive_remote(ready, c);
  mbar_wait_cluster(ready, 0);
  // this rank's share of the slots (slot % n_active == rank - c_lo), each
  // folded by the warpgroup that holds it, in chunk order
  cg::cluster_group cluster = cg::this_cluster();
  for (int sl = rank - c_lo; sl < 2 * kSlots; sl += n_active) {
    if (sl / kSlots != wg) continue;
    float4 x = cluster.map_shared_rank(part, c_lo)[sl * 128 + ctid];
    for (int c = c_lo + 1; c < n_split; ++c) {
      const float4 y = cluster.map_shared_rank(part, c)[sl * 128 + ctid];
      x.x = __fadd_rn(x.x, y.x);
      x.y = __fadd_rn(x.y, y.y);
      x.z = __fadd_rn(x.z, y.z);
      x.w = __fadd_rn(x.w, y.w);
    }
    store_slot(sl, x);
  }
  // stay until every active rank has read this one's partial
  named_sync(1, 256);
  if (tid == 0) {
    for (int c = c_lo; c < n_split; ++c) mbar_arrive_remote(done, c);
    mbar_wait_cluster(done, 0);
  }
}

// pass 3: dQ of 64 stacked rows (query r / G, head r % G) of one KV head
// (grid: KV x B, row tiles; causal: the last row tile first).  One
// consumer warpgroup walks the 64-key K/V tiles from key 0 up to the last
// one its rows see, in one fixed order: S = Q K^T and dP = dO V^T from
// shared memory, dS per row from its lse and D, dQ += dS K.
template <int HD>
__global__ void __launch_bounds__(DqCfg<HD>::kThreads, DqCfg<HD>::kBlocksPerSM)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D,
                        __nv_bfloat16* __restrict__ dq, int Sq, int Skv,
                        int H, int KV, int causal, float scale,
                        float scale_log2) {
  using Cfg = DqCfg<HD>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* smem = wg_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::kBar);
  uint64_t* empty = full + kStages;
  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KV, rows = G * Sq;
  const int r_blk =
      (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kWg;
  const int r_last = min(r_blk + kWg, rows) - 1;
  const int key_tiles = (Skv + kWg - 1) / kWg;
  const int n_kt =
      causal ? min(key_tiles, (r_last / G) / kWg + 1) : key_tiles;
  if (tid == 0) {
    if ((__cvta_generic_to_shared(smem) & 1023) != 0) __trap();
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 4) {
    // producer: one thread keeps the ring's TMA loads in flight
    if (lane == 0) {
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect(&full[s], 2 * Cfg::kTile);
        unsigned char* st = smem + Cfg::kRing + s * 2 * Cfg::kTile;
#pragma unroll
        for (int sl = 0; sl < Cfg::kSlabs; ++sl) {
          tma_load_4d(st + sl * kSlab, &tk, 64 * sl, kvh, t * kWg, b,
                      &full[s]);
          tma_load_4d(st + Cfg::kTile + sl * kSlab, &tv, 64 * sl, kvh,
                      t * kWg, b, &full[s]);
        }
      }
    }
    return;
  }
  // the block's stacked Q and dO rows, once, into the 128-byte swizzled
  // layout (16-byte chunk c of row j of a slab at c ^ (j % 8)); dead rows
  // are zero-filled
  for (int i = tid; i < kWg * (HD / 8); i += 128) {
    const int j = i / (HD / 8), c = i % (HD / 8);
    const int r = r_blk + j;
    const bool in = r < rows;
    const int qrow = in ? r / G : 0, h = kvh * G + (in ? r % G : 0);
    const int64_t at = (((int64_t)b * Sq + qrow) * H + h) * HD + c * 8;
    const int off = (c / 8) * kSlab + j * 128 + (((c % 8) ^ (j & 7)) << 4);
    cp_async16(smem + Cfg::kQ + off, q + at, in);
    cp_async16(smem + Cfg::kdO + off, dout + at, in);
  }
  cp_async_commit();
  // this thread's two stacked rows, gid and gid + 8 of its warp's 16
  const int gid = lane >> 2, tig = lane & 3;
  const int r_warp = r_blk + 16 * warp;
  bool live[2];
  int pos[2];
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_warp + gid + 8 * i;
    live[i] = r < rows;
    const int qrow = live[i] ? r / G : 0, h = kvh * G + (live[i] ? r % G : 0);
    const int64_t at = ((int64_t)b * H + h) * Sq + qrow;
    pos[i] = qrow;
    l2[i] = live[i] ? lse[at] * kLog2e : 0.f;
    dd[i] = live[i] ? D[at] : 0.f;
  }
  cp_async_wait<0>();
  fence_proxy_async();
  named_sync(1, 128);
  const uint32_t qb = smem_u32(smem + Cfg::kQ);
  const uint32_t dob = smem_u32(smem + Cfg::kdO);
  const int warp_first_pos = r_warp / G;

  float acc[HD / 8][4];
  zero_acc<HD>(acc);
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint32_t kt = smem_u32(smem + Cfg::kRing + s * 2 * Cfg::kTile);
    const uint32_t vt = kt + Cfg::kTile;
    float sc[8][4], dp[8][4];
    wgmma_fence();
    wg_rows_product<HD>(sc, qb, kt);         // S = Q K^T
    wg_rows_product<HD>(dp, dob, vt);        // dP = dO V^T
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    // dS per row; a masked entry (a key past Skv or, causal, past the
    // row's position) is 0
    const int c0 = t * kWg;
    const bool mask =
        c0 + kWg > Skv || (causal && c0 + kWg - 1 > warp_first_pos);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j / 2, key = c0 + 8 * n + 2 * tig + (j & 1);
        float p = ex2(fmaf(sc[n][j], scale_log2, -l2[i]));
        if (mask && (key >= Skv || (causal && key > pos[i]))) p = 0.f;
        dp[n][j] = p * (dp[n][j] - dd[i]);
      }
    }
    wg_acc_product<HD>(acc, dp, kt);         // dQ += dS K
    if (tid == 0) mbar_arrive(&empty[s]);    // the stage may be refilled
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const int r = r_warp + gid + 8 * i;
    __nv_bfloat16* out =
        dq + (((int64_t)b * Sq + r / G) * H + kvh * G + r % G) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          pack_bf16(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// ------------------------------------------------------ float32, CUDA cores
constexpr int kThreads = 256;

// query rows and keys per f32 tile: 64, and 32 at hd 256 (four padded
// 64-row tiles of hd 256 would need 263 KB of shared memory)
template <int HD>
__host__ __device__ constexpr int f32_tile() {
  return HD <= 128 ? 64 : 32;
}

// rows [r0, r0 + TL) of head h of a (B, S, heads, HD) tensor into a
// (TL, HD + 1) f32 tile; rows past S are zero
template <int HD, int TL>
__device__ __forceinline__ void stage(float* dst, const float* src, int b,
                                      int r0, int S, int heads, int h) {
  for (int i = threadIdx.x; i < TL * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = r0 + r;
    dst[r * (HD + 1) + d] =
        row < S ? src[(((int64_t)b * S + row) * heads + h) * HD + d] : 0.f;
  }
}

// P and dS of one (query tile q0, key tile k0) step.  Thread t computes
// rows ti + 16 a and keys tj + 16 c (a, c in 0 .. TL / 16 - 1; ti = t /
// 16, tj = t % 16).  Masked entries (a key past Skv or, when causal, past
// the row's position; a row past Sq) are 0 in both.  sP may be null (pass
// 3).
template <int HD, int TL>
__device__ __forceinline__ void p_ds_tile(
    const float* sQ, const float* sK, const float* sV, const float* sdO,
    const float* sL, const float* sD, int q0, int k0, int Sq, int Skv,
    int causal, float scale, float* sP, float* sdS) {
  constexpr int LD = HD + 1, LT = TL + 1, NP = TL / 16;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  float s[NP][NP], dp[NP][NP];
#pragma unroll
  for (int a = 0; a < NP; ++a) {
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      s[a][c] = 0.f;
      dp[a][c] = 0.f;
    }
  }
  for (int d = 0; d < HD; ++d) {
    float qa[NP], oa[NP], kc[NP], vc[NP];
#pragma unroll
    for (int a = 0; a < NP; ++a) {
      qa[a] = sQ[(ti + 16 * a) * LD + d];
      oa[a] = sdO[(ti + 16 * a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      kc[c] = sK[(tj + 16 * c) * LD + d];
      vc[c] = sV[(tj + 16 * c) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < NP; ++a) {
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(oa[a], vc[c], dp[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NP; ++a) {
    const int i = ti + 16 * a, row = q0 + i;
    const float li = sL[i], di = sD[i];
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      const int j = tj + 16 * c, key = k0 + j;
      const bool in = row < Sq && key < Skv && (!causal || key <= row);
      const float p = in ? expf(s[a][c] * scale - li) : 0.f;
      if (sP) sP[i * LT + j] = p;
      sdS[i * LT + j] = p * (dp[a][c] - di);
    }
  }
}


// float32 pass 2: dK, dV of one TL-key tile of one KV head.  Thread t owns
// key j = t % TL and the NC = hd * TL / 256 dims starting at (t / TL) * NC.
template <int HD>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
    int KV, int causal, float scale) {
  constexpr int TL = f32_tile<HD>();
  constexpr int LD = HD + 1, LT = TL + 1, NC = HD * TL / kThreads;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + TL * LD;
  float* sQ = sV + TL * LD;
  float* sdO = sQ + TL * LD;
  float* sP = sdO + TL * LD;
  float* sdS = sP + TL * LT;
  float* sL = sdS + TL * LT;
  float* sD = sL + TL;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, k0 = kt * TL;
  const int j = threadIdx.x % TL, c0 = (threadIdx.x / TL) * NC;
  stage<HD, TL>(sK, k, b, k0, Skv, KV, kvh);
  stage<HD, TL>(sV, v, b, k0, Skv, KV, kvh);
  float adk[NC], adv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) adk[c] = adv[c] = 0.f;
  const int nq = (Sq + TL - 1) / TL;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = causal ? kt : 0; qt < nq; ++qt) {
      const int q0 = qt * TL;
      __syncthreads();               // the previous step's tiles are read
      stage<HD, TL>(sQ, q, b, q0, Sq, H, h);
      stage<HD, TL>(sdO, dout, b, q0, Sq, H, h);
      if (threadIdx.x < TL) {
        const int row = q0 + threadIdx.x;
        const int64_t at = ((int64_t)b * H + h) * Sq + row;
        sL[threadIdx.x] = row < Sq ? lse[at] : 0.f;
        sD[threadIdx.x] = row < Sq ? D[at] : 0.f;
      }
      __syncthreads();
      p_ds_tile<HD, TL>(sQ, sK, sV, sdO, sL, sD, q0, k0, Sq, Skv, causal,
                        scale, sP, sdS);
      __syncthreads();
      for (int i = 0; i < TL; ++i) {
        const float p = sP[i * LT + j], ds = sdS[i * LT + j];
        const float* qi = sQ + i * LD + c0;
        const float* gi = sdO + i * LD + c0;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          adv[c] = fmaf(p, gi[c], adv[c]);
          adk[c] = fmaf(ds, qi[c], adk[c]);
        }
      }
    }
  }
  const int key = k0 + j;
  if (key >= Skv) return;
  const int64_t at = (((int64_t)b * Skv + key) * KV + kvh) * HD + c0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    dk[at + c] = adk[c] * scale;
    dv[at + c] = adv[c];
  }
}

// float32 pass 3: dQ of one TL-row query tile of one head.  Thread t owns
// row i = t % TL and the NC = hd * TL / 256 dims starting at (t / TL) *
// NC.
template <int HD>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    float* __restrict__ dq, int Sq, int Skv, int H, int KV, int causal,
    float scale) {
  constexpr int TL = f32_tile<HD>();
  constexpr int LD = HD + 1, LT = TL + 1, NC = HD * TL / kThreads;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + TL * LD;
  float* sK = sdO + TL * LD;
  float* sV = sK + TL * LD;
  float* sdS = sV + TL * LD;
  float* sL = sdS + TL * LT;
  float* sD = sL + TL;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV), q0 = qt * TL;
  const int i = threadIdx.x % TL, c0 = (threadIdx.x / TL) * NC;
  stage<HD, TL>(sQ, q, b, q0, Sq, H, h);
  stage<HD, TL>(sdO, dout, b, q0, Sq, H, h);
  if (threadIdx.x < TL) {
    const int row = q0 + threadIdx.x;
    const int64_t at = ((int64_t)b * H + h) * Sq + row;
    sL[threadIdx.x] = row < Sq ? lse[at] : 0.f;
    sD[threadIdx.x] = row < Sq ? D[at] : 0.f;
  }
  float adq[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) adq[c] = 0.f;
  const int n_kt = causal ? qt + 1 : (Skv + TL - 1) / TL;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TL;
    __syncthreads();                 // the previous step's tiles are read
    stage<HD, TL>(sK, k, b, k0, Skv, KV, kvh);
    stage<HD, TL>(sV, v, b, k0, Skv, KV, kvh);
    __syncthreads();
    p_ds_tile<HD, TL>(sQ, sK, sV, sdO, sL, sD, q0, k0, Sq, Skv, causal,
                      scale, nullptr, sdS);
    __syncthreads();
    for (int jj = 0; jj < TL; ++jj) {
      const float ds = sdS[i * LT + jj];
      const float* kj = sK + jj * LD + c0;
#pragma unroll
      for (int c = 0; c < NC; ++c) adq[c] = fmaf(ds, kj[c], adq[c]);
    }
  }
  const int row = q0 + i;
  if (row >= Sq) return;
  const int64_t at = (((int64_t)b * Sq + row) * H + h) * HD + c0;
#pragma unroll
  for (int c = 0; c < NC; ++c) dq[at + c] = adq[c] * scale;
}


template <typename F>
int allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}


template <int HD, typename T>
int launch_dot(const void* o, const void* dout, float* D, int B, int Sq,
               int H, cudaStream_t st) {
  const int64_t rows = (int64_t)B * Sq * H;
  const int64_t threads = rows * dot_lanes<HD, T>();
  bwd_dot_kernel<HD, T>
      <<<(unsigned)((threads + kDotThreads - 1) / kDotThreads), kDotThreads,
         0, st>>>(static_cast<const T*>(o), static_cast<const T*>(dout), D,
                  rows, Sq, H);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* D, void* dq,
               void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
               int causal, cudaStream_t st) {
  constexpr int TL = f32_tile<HD>(), LD = HD + 1, LT = TL + 1;
  const float scale = 1.0f / sqrtf((float)HD);
  const size_t smem2 = sizeof(float) * (4 * TL * LD + 2 * TL * LT + 2 * TL);
  int e;
  if ((e = allow_smem(bwd_dkdv_kernel<HD>, smem2))) return e;
  bwd_dkdv_kernel<HD><<<dim3((Skv + TL - 1) / TL, KV, B), kThreads, smem2,
                         st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, D,
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, H, KV,
      causal, scale);
  if ((e = (int)cudaGetLastError())) return e;
  const size_t smem3 = sizeof(float) * (4 * TL * LD + TL * LT + 2 * TL);
  if ((e = allow_smem(bwd_dq_kernel<HD>, smem3))) return e;
  bwd_dq_kernel<HD><<<dim3((Sq + TL - 1) / TL, H, B), kThreads, smem3, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, D,
      static_cast<float*>(dq), Sq, Skv, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* D, void* dq,
               void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
               int causal, cudaStream_t st) {
  using T = Tiles<HD>;
  using bf = __nv_bfloat16;
  const float scale = 1.0f / sqrtf((float)HD), scale_log2 = scale * kLog2e;
  const dim3 grid2(KV * B, (Skv + kKeyTile - 1) / kKeyTile);
  int e;
  const size_t smem2 =
      sizeof(bf) * 2 * kKeyTile * T::LD + 2 * (size_t)T::kRingBytes;
  if ((e = allow_smem(bwd_dkdv_mma_kernel<HD>, smem2))) return e;
  bwd_dkdv_mma_kernel<HD><<<grid2, kDkdvThreads, smem2, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, D,
      static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Skv, H, KV, causal,
      scale, scale_log2);
  if ((e = (int)cudaGetLastError())) return e;
  const size_t smem3 = sizeof(bf) * 4 * T::KT * T::LD;
  if ((e = allow_smem(bwd_dq_mma_kernel<HD>, smem3))) return e;
  const int64_t rows = (int64_t)(H / KV) * Sq;
  bwd_dq_mma_kernel<HD>
      <<<dim3(KV * B, (unsigned)((rows + T::RT - 1) / T::RT)),
         kMmaThreads, smem3, st>>>(
          static_cast<const bf*>(q), static_cast<const bf*>(k),
          static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, D,
          static_cast<bf*>(dq), Sq, Skv, H, KV, causal, scale, scale_log2);
  return (int)cudaGetLastError();
}

// Passes 2 and 3 need only pass 1's D, not each other: pass 2 (few,
// long blocks: clusters a key tile) runs on a side stream of the highest
// priority, so that its blocks take the SMs first and pass 3's (many,
// short) fill those it leaves.  One side stream and two events a device,
// made at first use; a lock keeps one call's record and wait together.
struct SideStream {
  cudaStream_t stream;
  cudaEvent_t d_ready, dkdv_done;
};
std::mutex g_side_lock;

cudaError_t side_stream(SideStream* out) {
  static SideStream made[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  SideStream& s = made[dev];
  if (!s.stream) {
    int lo = 0, hi = 0;
    if ((e = cudaDeviceGetStreamPriorityRange(&lo, &hi)) != cudaSuccess ||
        (e = cudaEventCreateWithFlags(&s.d_ready, cudaEventDisableTiming)) !=
            cudaSuccess ||
        (e = cudaEventCreateWithFlags(&s.dkdv_done,
                                      cudaEventDisableTiming)) !=
            cudaSuccess ||
        (e = cudaStreamCreateWithPriority(&s.stream, cudaStreamNonBlocking,
                                          hi)) != cudaSuccess)
      return e;
  }
  *out = s;
  return cudaSuccess;
}

// Passes 2 and 3 at hd 128 and 256 in bf16: the four tensor maps (q and
// dO over (hd, H, Sq, B), k and v over (hd, KV, Skv, B); the wrapper
// hands contiguous tensors), pass 2 over clusters of one block a query
// chunk (flash_bwd_launch_plan in kernels/flash_attention_bwd.py), pass 3
// longest row tiles first.
template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* D,
                 void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
                 int KV, int causal, cudaStream_t st) {
  using bf = __nv_bfloat16;
  using C2 = DkdvCfg<HD>;
  using C3 = DqCfg<HD>;
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      bwd_dkdv_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C2::kSmem);
  static const cudaError_t attr3 = cudaFuncSetAttribute(
      bwd_dq_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C3::kSmem);
  if (attr2 != cudaSuccess) return (int)attr2;
  if (attr3 != cudaSuccess) return (int)attr3;
  const long long hs = HD, qs = (long long)H * HD, ks = (long long)KV * HD;
  CUtensorMap tq, tdo, tk, tv;
  if (!rows_map(&tq, q, HD, H, Sq, B, qs * Sq, qs, hs) ||
      !rows_map(&tdo, dout, HD, H, Sq, B, qs * Sq, qs, hs) ||
      !rows_map(&tk, k, HD, KV, Skv, B, ks * Skv, ks, hs) ||
      !rows_map(&tv, v, HD, KV, Skv, B, ks * Skv, ks, hs))
    return (int)cudaErrorInvalidValue;
  float scale = 1.0f / sqrtf((float)HD), scale_log2 = scale * kLog2e;
  const int chunk = query_chunk(Sq, H / KV, causal);
  const int n = (Sq + chunk - 1) / chunk;
  bf* dk_ = static_cast<bf*>(dk);
  bf* dv_ = static_cast<bf*>(dv);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * KV, B, (Skv + C2::kKeys - 1) / C2::kKeys);
  cfg.blockDim = dim3(C2::kThreads, 1, 1);
  cfg.dynamicSmemBytes = C2::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = n;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  void* params[] = {&tq,  &tdo, &tk, &tv,     &lse,   &D,
                    &dk_, &dv_, &Sq, &Skv,    &H,     &KV,
                    &causal, &scale, &scale_log2};
  // pass 2 on the side stream, once pass 1 is done; pass 3 on the
  // caller's beside it; the caller's stream then waits for pass 2
  std::lock_guard<std::mutex> hold(g_side_lock);
  SideStream side;
  cudaError_t e = side_stream(&side);
  if (e != cudaSuccess) return (int)e;
  cfg.stream = side.stream;
  if ((e = cudaEventRecord(side.d_ready, st)) != cudaSuccess ||
      (e = cudaStreamWaitEvent(side.stream, side.d_ready, 0)) != cudaSuccess)
    return (int)e;
  auto kern = bwd_dkdv_wgmma_kernel<HD>;
  if ((e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern),
                               params)) != cudaSuccess ||
      (e = cudaGetLastError()) != cudaSuccess ||
      (e = cudaEventRecord(side.dkdv_done, side.stream)) != cudaSuccess)
    return (int)e;
  const int64_t rows = (int64_t)(H / KV) * Sq;
  bwd_dq_wgmma_kernel<HD>
      <<<dim3(KV * B, (unsigned)((rows + kWg - 1) / kWg)), C3::kThreads,
         C3::kSmem, st>>>(tk, tv, static_cast<const bf*>(q),
                          static_cast<const bf*>(dout), lse, D,
                          static_cast<bf*>(dq), Sq, Skv, H, KV, causal,
                          scale, scale_log2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)cudaStreamWaitEvent(st, side.dkdv_done, 0);
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, float* D,
           void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
           int KV, int causal, cudaStream_t st) {
  int e;
  if (dtype == 0) {
    if ((e = launch_dot<HD, float>(o, dout, D, B, Sq, H, st))) return e;
    return launch_f32<HD>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Skv, H,
                          KV, causal, st);
  }
  if (dtype == 1) {
    if ((e = launch_dot<HD, __nv_bfloat16>(o, dout, D, B, Sq, H, st)))
      return e;
    if constexpr (HD >= 64) {
      return launch_wgmma<HD>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Skv,
                              H, KV, causal, st);
    } else {
      return launch_mma<HD>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Skv,
                            H, KV, causal, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout, dq: (B, Sq, H, hd); k, v,
// dk, dv: (B, Skv, KV, hd); all contiguous in that dtype, starting on
// 16-byte boundaries.  lse and the scratch D: (B, H, Sq) f32 contiguous.
// hd in {16, 32, 64, 128, 256}; causal needs Sq == Skv.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* D, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Skv, int H, int KV, int hd,
    int causal, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || Sq <= 0 || Skv <= 0 ||
      (causal && Sq != Skv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K3B_LAUNCH(HD)                                                      \
  return launch<HD>(dtype, q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, \
                    H, KV, causal, st)
  switch (hd) {
    case 16:
      K3B_LAUNCH(16);
    case 32:
      K3B_LAUNCH(32);
    case 64:
      K3B_LAUNCH(64);
    case 128:
      K3B_LAUNCH(128);
    case 256:
      K3B_LAUNCH(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K3B_LAUNCH
}
