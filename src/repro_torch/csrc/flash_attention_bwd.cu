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
// cores reach either bound.  What bounds this design: it does seven
// products, not five, to stay deterministic (S and dP again in pass 3),
// and it issues them as mma.sync with its B fragments brought by
// ldmatrix, at about the per-FLOP rate of autograd's SDPA backward on
// this card.  Its mma passes hold ~240 registers a thread (the -Xptxas
// -v lines), so the register file lets an SM hold at most one 256-thread
// pass-2 block or two 128-thread pass-3 blocks: 8 warps.  Hypothesis,
// not measured (no stall reason or achieved occupancy has been read on
// the card): what is left is latency, the 8 warps' own phases (products,
// then P and dS, then products) leaving the tensor pipe idle in turn.
//
// bf16 (the training dtype) runs every product on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), fragments through
// ldmatrix from shared memory rows padded by 16 bytes (free of bank
// conflicts), tiles brought by cp.async (16 bytes a thread; lse and D 4
// bytes a thread) into two-stage rings, rows past Sq or Skv zero-filled:
//  * Pass 1 (D): L = min(hd / 8, 32) neighbouring lanes read a row's o
//    and dO, 16 bytes each (hd / 8 / L chunks a lane, in order), and sum
//    their partial dots by a butterfly of shuffles (one fixed order).
//  * Pass 2 (dK, dV): one block per (64-key tile, KV head, batch row),
//    key tile 0 launched first (it walks the most query tiles when
//    causal), warps of 16 keys each.  A warp computes the transposed
//    tiles with its keys as the M rows: S^T = K Q^T and dP^T = V dO^T (K
//    and V the A operands, held in registers for hd <= 64; Q and dO the
//    B operands from the ring), P^T and dS^T per column (query) from lse
//    and D, then dV += P^T dO and dK += dS^T Q with P^T and dS^T turned
//    from accumulator fragments straight into A fragments and Q, dO
//    through ldmatrix.trans.  The block walks the G query heads of the
//    KV head, each over the Sq query tiles that can see the key tile
//    (from the diagonal on when causal), in one fixed order.
//    hd <= 128: two groups of four warps take the walk's steps in turn,
//    each with its own ring and named barrier, so that they drift apart
//    and one group's products overlap the other's P and dS.  dK and dV
//    stay in f32 registers for the whole walk (2 x hd / 2 floats a
//    lane); group 1's sums are added to group 0's, in that order, at the
//    end.  At hd 128 a step takes 32 query rows and reads K and V
//    fragments from shared memory, so that nothing spills.
//    hd 256: dK and dV together would be 256 floats a lane, above the
//    register file.  So the two groups split the roles instead of the
//    steps: the four warps of group 0 hold their keys' dV (128 floats a
//    lane) and compute S^T and P^T only; those of group 1 hold dK and
//    compute S^T, dP^T, P^T and dS^T.  Both walk every step from one
//    shared ring (32 query rows a step, K and V fragments from shared
//    memory, 133 KiB in all) under __syncthreads; S^T is computed twice,
//    the price of no hand-over.  Each group stores its own output.
//    No two blocks write one dK or dV row.
//  * Pass 3 (dQ): the G query heads of a KV head stacked into rows (row
//    r = query r / G, head r % G), one block per (128 stacked rows, KV
//    head, batch row; 64 at hd >= 128), the causal tail's longest row
//    tiles first: each K/V tile is fetched once per group, not G times.
//    A warp holds its 32 rows' (16 at hd >= 128) Q and dO as A fragments
//    (at hd 256 they would be 128 registers a lane: the block's 64 rows
//    of Q and dO sit in shared memory instead, beside the K/V ring, and
//    each k step brings a warp's fragments by ldmatrix), walks 32-key
//    tiles of Skv from tile 0 up to the last one its rows can see, in one
//    fixed order, computes S = Q K^T, dP = dO V^T, dS, and dQ += dS K (K
//    through ldmatrix.trans), each K and V fragment serving both 16-row
//    m-tiles, dQ in f32 registers until its one store.
//  * A step whose tile crosses no row's diagonal and no end of Sq or Skv
//    skips the per-element mask.
//  * Rounding: each product's inputs are bf16 and its sums f32.  P and dS
//    are computed in f32 and rounded to bf16 for the products that
//    consume them (P^T for dV; dS^T for dK; dS for dQ), as the plain
//    version does with round_dtype=torch.bfloat16; dK and dQ are scaled
//    in f32 and every output is rounded to bf16 once, at its store.
//  * No atomics and a fixed walk: two runs give the same bits.  S and dP
//    are recomputed in pass 3: the price of that.
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
// The launcher runs the three passes on the caller's stream, allocates
// nothing (D is a (B, H, Sq) f32 scratch the wrapper passes) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
  static constexpr int LD = HD + 8;      // padded smem row (elements)
  static constexpr int KS = HD / 16;     // k steps over hd
  static constexpr int CH = HD / 8;      // 16-byte chunks of a row
  static constexpr int QT = HD <= 64 ? 64 : 32;   // pass 2's query step
  static constexpr int KT = 32;                   // pass 3's key step
  static constexpr int MT = HD <= 64 ? 2 : 1;      // pass 3's m-tiles a warp
  static constexpr int RT = 16 * MT * kWarps;      // pass 3's rows a block
  static constexpr bool kHoldKV = HD <= 64;       // pass 2's K/V in regs
  // hd 256: pass 2's groups split dV / dK; pass 3's Q and dO in smem
  static constexpr bool kWide = HD > 128;
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

// stacked rows r0 .. r0 + n_rows - 1 (row r = query r / G, head kvh * G
// + r % G) of a (B, Sq, H, HD) bf16 tensor into a padded smem tile by
// cp.async, thread t of NT; rows from n_live on are zero
template <int HD, int NT>
__device__ __forceinline__ void load_stacked(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src, int b,
                                             int r0, int n_rows, int n_live,
                                             int G, int Sq, int H, int kvh,
                                             int t) {
  using T = Tiles<HD>;
  for (int i = t; i < n_rows * T::CH; i += NT) {
    const int j = i / T::CH, c = (i % T::CH) * 8;
    const int r = r0 + j;
    const bool in = r < n_live;
    const int qrow = in ? r / G : 0, h = kvh * G + (in ? r % G : 0);
    cp_async16(dst + j * T::LD + c,
               src + (((int64_t)b * Sq + qrow) * H + h) * HD + c, in);
  }
}

// S^T = K Q^T (and, with kDP, dP^T = V dO^T) for one warp's 16 keys
// against the step's QT query rows (the n axis): ka/va are the keys' A
// fragments
template <int HD, bool kDP = true>
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
    if constexpr (kDP) {
      ldsm_x4(r, tdo + at);
      mma16816(dp[2 * jp], va, r[0], r[1]);
      mma16816(dp[2 * jp + 1], va, r[2], r[3]);
    }
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

// pass 2 at hd <= 128: dK, dV of one 64-key tile of one KV head (grid:
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
  // K and V as A fragments: all of hd held, or one k step at a time
  uint32_t ka[T::kHoldKV ? KS : 1][4], va[T::kHoldKV ? KS : 1][4];
  if constexpr (T::kHoldKV) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(ka[kk], wk + a_at + 16 * kk);
      ldsm_x4(va[kk], wv + a_at + 16 * kk);
    }
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
      for (int kk = 0; kk < KS; ++kk) {
        if constexpr (T::kHoldKV) {
          kq_tile<HD>(s[0], dp[0], ka[kk], va[kk], tq, tdo, kk, lane);
        } else {
          ldsm_x4(ka[0], wk + a_at + 16 * kk);
          ldsm_x4(va[0], wv + a_at + 16 * kk);
          kq_tile<HD>(s[0], dp[0], ka[0], va[0], tq, tdo, kk, lane);
        }
      }
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

// pass 2 at hd 256: dK, dV of one 64-key tile of one KV head (grid: KV *
// B, key tiles; key tile 0 first).  Both groups walk every step from one
// ring: the warps of group 0 (role 0) accumulate their 16 keys' dV from
// P^T, those of group 1 (role 1) their dK from dS^T; each stores its own.
template <int HD>
__global__ void __launch_bounds__(kDkdvThreads) bwd_dkdv_wide_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ D, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H, int KV,
    int causal, float scale, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int LD = T::LD, KS = T::KS, QT = T::QT, NQ = QT / 8;
  static_assert(T::kWide && !T::kHoldKV, "K and V from smem at hd 256");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kKeyTile * LD;
  // the block's ring: Q and dO [2][QT][LD], then lse and D [2][QT]
  __nv_bfloat16* sQ = sV + kKeyTile * LD;
  __nv_bfloat16* sdO = sQ + 2 * QT * LD;
  float* sL = reinterpret_cast<float*>(sdO + 2 * QT * LD);
  float* sD = sL + 2 * QT;

  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int role = warp / kWarps;        // 0: dV, 1: dK
  const int gid = lane >> 2, tig = lane & 3;
  const int G = H / KV, k0 = blockIdx.y * kKeyTile;
  const int kw0 = k0 + 16 * (warp % kWarps);
  const int qt0 = causal ? k0 / QT : 0;
  const int nqt = (Sq + QT - 1) / QT - qt0;
  const int n_steps = G * nqt;

  // step st into ring stage buf (every thread commits one group)
  auto load_step = [&](int st, int buf) {
    const int h = kvh * G + st / nqt, q0 = (qt0 + st % nqt) * QT;
    load_rows<HD, kDkdvThreads>(sQ + buf * QT * LD, q, b, q0, QT, Sq, H, h,
                                tid);
    load_rows<HD, kDkdvThreads>(sdO + buf * QT * LD, dout, b, q0, QT, Sq, H,
                                h, tid);
    if (tid < 2 * QT) {
      const int i = tid % QT, row = q0 + i;
      const bool in = row < Sq;
      const int64_t at = ((int64_t)b * H + h) * Sq + (in ? row : 0);
      if (tid < QT)
        cp_async4(sL + buf * QT + i, lse + at, in);
      else
        cp_async4(sD + buf * QT + i, D + at, in);
    }
    cp_async_commit();
  };

  load_rows<HD, kDkdvThreads>(sK, k, b, k0, kKeyTile, Skv, KV, kvh, tid);
  load_rows<HD, kDkdvThreads>(sV, v, b, k0, kKeyTile, Skv, KV, kvh, tid);
  cp_async_commit();
  load_step(0, 0);
  const __nv_bfloat16* wk = sK + 16 * (warp % kWarps) * LD;
  const __nv_bfloat16* wv = sV + 16 * (warp % kWarps) * LD;
  const int a_at = (lane % 16) * LD + (lane / 16) * 8;

  float acc[1][HD / 8][4];               // dV (role 0) or dK (role 1)
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[0][n][j] = 0.f;
  }
  for (int st = 0; st < n_steps; ++st) {
    if (st + 1 < n_steps) {
      load_step(st + 1, (st + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                     // the step's tiles visible
    const int buf = st & 1;
    const int q0 = (qt0 + st % nqt) * QT;
    if (kw0 < Skv && (!causal || kw0 <= q0 + QT - 1)) {
      const __nv_bfloat16* tq = sQ + buf * QT * LD;
      const __nv_bfloat16* tdo = sdO + buf * QT * LD;
      const float* tl = sL + buf * QT;
      const float* td = sD + buf * QT;
      const bool mask =
          kw0 + 16 > Skv || q0 + QT > Sq || (causal && kw0 + 15 > q0);
      float s[1][NQ][4], dp[1][NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[0][n][j] = dp[0][n][j] = 0.f;
      }
      uint32_t ka[4], va[4];
      if (role == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_x4(ka, wk + a_at + 16 * kk);
          kq_tile<HD, false>(s[0], dp[0], ka, ka, tq, tdo, kk, lane);
        }
        if (mask) {
          p_ds_cols<true, NQ, false>(s[0], dp[0], tl, td, kw0 + gid, q0, tig,
                                     Sq, Skv, causal, scale_log2);
        } else {
          p_ds_cols<false, NQ, false>(s[0], dp[0], tl, td, kw0 + gid, q0,
                                      tig, Sq, Skv, causal, scale_log2);
        }
        acc_product<HD, NQ, 1>(acc, s, tdo, lane);  // dV += P^T dO
      } else {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_x4(ka, wk + a_at + 16 * kk);
          ldsm_x4(va, wv + a_at + 16 * kk);
          kq_tile<HD>(s[0], dp[0], ka, va, tq, tdo, kk, lane);
        }
        if (mask) {
          p_ds_cols<true, NQ>(s[0], dp[0], tl, td, kw0 + gid, q0, tig, Sq,
                              Skv, causal, scale_log2);
        } else {
          p_ds_cols<false, NQ>(s[0], dp[0], tl, td, kw0 + gid, q0, tig, Sq,
                               Skv, causal, scale_log2);
        }
        acc_product<HD, NQ, 1>(acc, dp, tq, lane);  // dK += dS^T Q
      }
    }
    __syncthreads();                     // the ring stage is free again
  }
  __nv_bfloat16* out = role == 0 ? dv : dk;
  const float mul = role == 0 ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw0 + gid + 8 * i;
    if (key >= Skv) continue;
    const int64_t at = (((int64_t)b * Skv + key) * KV + kvh) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + at + 8 * n) =
          pack_bf16(acc[0][n][2 * i] * mul, acc[0][n][2 * i + 1] * mul);
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
  // hd 256: the block's Q and dO rows after them, [RT][LD] each

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
  if constexpr (T::kWide) {              // the block's Q, dO: tile 0's group
    load_stacked<HD, kMmaThreads>(sV + 2 * KT * LD, q, b, r_blk, RT, rows, G,
                                  Sq, H, kvh, tid);
    load_stacked<HD, kMmaThreads>(sV + (2 * KT + RT) * LD, dout, b, r_blk,
                                  RT, rows, G, Sq, H, kvh, tid);
  }
  load_tile(0, 0);                       // in flight while Q, dO load

  // this thread's rows: gid and gid + 8 of each of the warp's m-tiles
  bool live[MT][2];
  int pos[MT][2];
  float l2[MT][2], dd[MT][2];
  __nv_bfloat16* dqp[MT][2];
  // Q and dO as A fragments (hd 256: from smem at each k step)
  constexpr int KH = T::kWide ? 1 : KS;
  uint32_t qa[MT][KH][4], oa[MT][KH][4];
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
      if constexpr (!T::kWide) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int d = 16 * kk + 2 * tig + 8 * hf;
            qa[mt][kk][i + 2 * hf] =
                in ? *reinterpret_cast<const uint32_t*>(q + row_at + d) : 0;
            oa[mt][kk][i + 2 * hf] =
                in ? *reinterpret_cast<const uint32_t*>(dout + row_at + d)
                   : 0;
          }
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
        const int kq = T::kWide ? 0 : kk;
        if constexpr (T::kWide) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const __nv_bfloat16* a =
                sV + 2 * KT * LD + (16 * MT * warp + 16 * mt + lane % 16) * LD +
                (lane / 16) * 8 + 16 * kk;
            ldsm_x4(qa[mt][0], a);
            ldsm_x4(oa[mt][0], a + RT * LD);
          }
        }
#pragma unroll
        for (int jp = 0; jp < KT / 16; ++jp) {
          const int at = (16 * jp + (lane / 16) * 8 + lane % 8) * LD +
                         16 * kk + ((lane / 8) & 1) * 8;
          uint32_t r[4];
          ldsm_x4(r, tk + at);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(s[mt][2 * jp], qa[mt][kq], r[0], r[1]);
            mma16816(s[mt][2 * jp + 1], qa[mt][kq], r[2], r[3]);
          }
          ldsm_x4(r, tv + at);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(dp[mt][2 * jp], oa[mt][kq], r[0], r[1]);
            mma16816(dp[mt][2 * jp + 1], oa[mt][kq], r[2], r[3]);
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
  if constexpr (T::kWide) {              // one ring shared by both roles
    const size_t smem2 =
        sizeof(bf) * 2 * kKeyTile * T::LD + (size_t)T::kRingBytes;
    if ((e = allow_smem(bwd_dkdv_wide_kernel<HD>, smem2))) return e;
    bwd_dkdv_wide_kernel<HD><<<grid2, kDkdvThreads, smem2, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, D,
        static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Skv, H, KV, causal,
        scale, scale_log2);
  } else {
    const size_t smem2 =
        sizeof(bf) * 2 * kKeyTile * T::LD + 2 * (size_t)T::kRingBytes;
    if ((e = allow_smem(bwd_dkdv_mma_kernel<HD>, smem2))) return e;
    bwd_dkdv_mma_kernel<HD><<<grid2, kDkdvThreads, smem2, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, D,
        static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Skv, H, KV, causal,
        scale, scale_log2);
  }
  if ((e = (int)cudaGetLastError())) return e;
  const size_t smem3 =
      sizeof(bf) * (4 * T::KT + (T::kWide ? 2 * T::RT : 0)) * T::LD;
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
    return launch_mma<HD>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Skv, H,
                          KV, causal, st);
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
