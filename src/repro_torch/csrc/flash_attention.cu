// K3: causal (or full) flash attention for the bucketed prefill and the
// extend prefill of a prefix hit.
//
// Replaces the Pallas TPU kernel flash_attention_kernel / _flash_kernel
// (src/repro/kernels/flash_attention.py).  Same function: softmax(q k^T *
// hd^-0.5) v per query head, GQA through kv head = h / G, running max /
// sum / accumulator in f32.  Beyond the Pallas kernel, the Sq query rows
// may sit at absolute positions q_offset .. q_offset + Sq - 1 of a longer
// key buffer (Skv >= q_offset + Sq when causal): the extend prefill of
// models/attention.py, a suffix appended to a cached prefix.
//
// What bounds it on an H100: operations, at long prompts.  A causal
// prefill of S tokens does 2 * 2 * H * hd * S(S+1)/2 FLOPs on
// (H + 2 KV) * S * hd elements, about S/2 FLOPs per byte in bf16, so it
// crosses the ~295 FLOP/byte ridge only near S 600; at the serving
// buckets (16..512, H 15, KV 5, hd 64) the bound is bytes and well under
// a microsecond, and what a call costs is its chain of dependent tile
// steps and how many SMs it reaches.
//
// bf16 (the serving dtype) runs on the tensor cores:
//  * GQA rows stacked into M: the G query heads of one KV head and the Sq
//    query rows form G * Sq stacked rows (row r = query row r / G, head
//    r % G), cut into 64-row tiles, one block per (row tile, KV head,
//    batch row).  Every K/V tile is read once per group instead of G
//    times, and the 16- and 32-token buckets (48 and 96 stacked rows)
//    fill most of a 64-row tile.  B 1, S 512 is 24 row tiles x 5 KV heads
//    = 120 blocks on 132 SMs.
//  * Two key groups of 4 warps (16 rows each): a ring stage holds 128
//    keys, group k takes the stage's k-th 64 keys with its own online
//    softmax, and group 1 hands its partial to group 0 through shared
//    memory at the end.  This halves the chain of tile steps of the last
//    row tile, which walks every key tile of a causal prefill; a third
//    group bought nothing at S 512 and slowed the small buckets, as the
//    SM's issue slots, not the chain, then set the pace.
//  * A tile that crosses no row's diagonal and no end of the keys skips
//    the per-element mask (the same arithmetic on every unmasked score).
//  * QK^T and PV with mma.sync.m16n8k16 (bf16 in, f32 accumulate), K and
//    V fragments through ldmatrix (V transposed), P kept in registers and
//    rounded to bf16 between the two products.  mma.sync rather than
//    wgmma: its 16-row granularity lets each warp skip the key tiles past
//    its own rows' diagonal and leaves no warpgroup idle at the 16-token
//    bucket, and its fragments need no shared-memory descriptors; at these
//    sizes the kernel is latency- not tensor-throughput-bound.
//  * K/V stages of 128 keys brought by cp.async (16 bytes a thread) into
//    a two-stage ring in shared memory, rows padded by 16 bytes so that
//    ldmatrix is free of bank conflicts; keys past Skv are zero-filled.
//  * Head width 256 (gemma3-4b-edge) cannot keep that shape: the 128-key
//    two-stage ring would need 270 KB of shared memory, and q's A
//    fragments (64 registers), the accumulator (128) and the scores (32)
//    would pass 255 registers a thread.  So MmaCfg<256> runs one key
//    group of 4 warps (128 threads) over 64-key stages (a 135 KB ring)
//    and keeps the block's 64 stacked q rows in shared memory (33 KB,
//    brought by cp.async with the first stage), from where each k-step
//    of QK^T reads its A fragment by ldmatrix: 247 registers a thread
//    by ptxas, no spill.
//    The mask, the softmax and the P V product are the narrow widths'.
//  * Extend rows equal cold-prefill rows bit for bit: key tiles start at
//    absolute key 0, belong to a key group by their absolute index and
//    run in the same order for every row; a tile that is fully masked for
//    a row leaves its (m, l, acc) bitwise unchanged (alpha is exp2(0) = 1,
//    every p is 0), and so does folding in an empty group partial; and a
//    row's arithmetic reads only its own q, the tile and its own state
//    (each mma output element is its own dot product), never the other
//    rows of its tile.
//
// float32 stays on CUDA cores in full f32 (TF32 would break the 1e-4
// bar): kSplit threads per query row (1 up to hd 64, hd / 64 past it: at
// hd 256 one thread would need 512 registers for q and the accumulator) keep
// their share of the row's q and accumulator in registers, dimension d
// in thread d % kSplit (neighbouring threads on neighbouring banks), and
// sum a score's partial dot products by shuffles within the row's
// threads; K/V tiles of 64 keys are staged in shared memory as f32,
// causal rows skip keys past their position and walk kv tiles from
// absolute tile 0 (so extend rows equal cold rows there too).
//
// Both: q, k, v and o are read and written in place in model layout
// (B, S, H|KV, hd) through their strides: no transposed copies; a ragged
// S (the 96-slot bucket) is masked here, not asserted away.  The
// launcher allocates nothing and returns cudaGetLastError().
//
// Training asks for each query row's log-sum-exp as well (``lse``, (B, H,
// Sq) f32, m + log(l) in natural units): the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from it.  Serving
// passes a null ``lse``; the store is then skipped and nothing else
// changes, so o keeps its bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, s, h;
};

// ----------------------------------------------------------- bf16, mma.sync
constexpr int kRowWarps = 4;             // warps along the stacked rows
constexpr int kMRows = 16 * kRowWarps;   // stacked rows per block
constexpr int kKeys = 64;                // keys per warp tile

// The block's shape by head width: up to 128, two key groups (warps
// along the keys) over 128-key stages with q's A fragments in registers;
// past 128, one key group over 64-key stages with q in shared memory.
template <int HD>
struct MmaCfg {
  static constexpr bool kWide = HD > 128;
  static constexpr int kKeyGroups = kWide ? 1 : 2;
  static constexpr int kThreads = 32 * kRowWarps * kKeyGroups;
  static constexpr int kStageKeys = kKeys * kKeyGroups;   // keys a stage
  static constexpr int LD = HD + 8;      // padded smem row (elements)
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) *
      (2 * 2 * kStageKeys * LD + (kWide ? kMRows * LD : 0));
};

// One 64-key tile of the online softmax for the thread's two rows: scale
// the scores s into log2 units, mask (kMask: the tile crosses a row's
// diagonal or the end of the keys), update (m, l) and rescale acc; s
// leaves as the weights p.  Unmasked scores take the same arithmetic on
// either path, so a row's result does not depend on which path ran.
// Maxima and sums are trees over the thread's 16 scores of a row.
template <bool kMask, int HD>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kKeys / 8][4], float (&acc)[HD / 8][4], float (&m)[2],
    float (&l)[2], int c0, int tig, const int (&pos)[2], int Skv,
    int causal, float scale_log2) {
  constexpr int NT = kKeys / 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[n][2 * i + e] * scale_log2;
        if (kMask) {
          const int key = c0 + 8 * n + 2 * tig + e;
          if (key >= Skv || (causal && key > pos[i])) x = kNegInf;
        }
        s[n][2 * i + e] = x;
      }
      t[n] = fmaxf(s[n][2 * i], s[n][2 * i + 1]);
    }
#pragma unroll
    for (int w = NT / 2; w > 0; w /= 2)
#pragma unroll
      for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
    float mx = fmaxf(m[i], t[0]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = ex2(m[i] - mx);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = ex2(s[n][2 * i + e] - mx);
        if (kMask && s[n][2 * i + e] == kNegInf) p = 0.f;
        s[n][2 * i + e] = p;
      }
      t[n] = s[n][2 * i] + s[n][2 * i + 1];
    }
#pragma unroll
    for (int w = NT / 2; w > 0; w /= 2)
#pragma unroll
      for (int n = 0; n < w; ++n) t[n] += t[n + w];
    m[i] = mx;
    l[i] = fmaf(l[i], alpha, t[0]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][2 * i] *= alpha;
      acc[n][2 * i + 1] *= alpha;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(MmaCfg<HD>::kThreads, 1) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Skv, int q_offset, int G,
    int causal, Strides qs, Strides ks_, Strides vs_, Strides os,
    float scale_log2) {
  using Cfg = MmaCfg<HD>;
  constexpr int kKeyGroups = Cfg::kKeyGroups;
  constexpr int kThreads = Cfg::kThreads;
  constexpr int kStageKeys = Cfg::kStageKeys;
  constexpr int LD = Cfg::LD;
  constexpr int KS = HD / 16;            // k steps of QK^T
  constexpr int CH = HD / 8;             // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + 2 * kStageKeys * LD;   // [2][kStageKeys][LD]
  __nv_bfloat16* sq = sv + 2 * kStageKeys * LD;   // wide: [kMRows][LD]

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % kRowWarps, kg = warp / kRowWarps;
  const int gid = lane >> 2, tig = lane & 3;
  const int rows = G * Sq;
  const int r_blk = blockIdx.x * kMRows;
  const int r_warp = r_blk + wr * 16;

  // this thread's two stacked rows: gid and gid + 8 of the warp's 16
  bool live[2];
  int pos[2];
  float* lp[2];                          // this row's lse, or null
  const __nv_bfloat16* qp[2];
  __nv_bfloat16* op[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_warp + gid + 8 * i;
    live[i] = r < rows;
    const int qrow = live[i] ? r / G : 0, g = live[i] ? r % G : 0;
    pos[i] = q_offset + qrow;
    qp[i] = q + b * qs.b + (int64_t)qrow * qs.s +
            (int64_t)(kvh * G + g) * qs.h;
    op[i] = o + b * os.b + (int64_t)qrow * os.s +
            (int64_t)(kvh * G + g) * os.h;
    lp[i] = lse ? lse + ((int64_t)b * gridDim.y * G + kvh * G + g) * Sq +
                      qrow
                : nullptr;
  }
  // q as A fragments: in registers (narrow), or, wide, the block's
  // stacked rows in shared memory (4-byte copies, dead rows zero-filled;
  // they complete with the first stage's group)
  uint32_t qa[Cfg::kWide ? 1 : KS][4];
  if constexpr (Cfg::kWide) {
    for (int i = tid; i < kMRows * (HD / 2); i += kThreads) {
      const int j = i / (HD / 2), c = (i % (HD / 2)) * 2;
      const int r = r_blk + j;
      const bool in = r < rows;
      const int qrow = in ? r / G : 0, g = in ? r % G : 0;
      cp_async4(sq + j * LD + c,
                q + b * qs.b + (int64_t)qrow * qs.s +
                    (int64_t)(kvh * G + g) * qs.h + c,
                in);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d = 16 * kk + 2 * tig;
      qa[kk][0] =
          live[0] ? *reinterpret_cast<const uint32_t*>(qp[0] + d) : 0;
      qa[kk][1] =
          live[1] ? *reinterpret_cast<const uint32_t*>(qp[1] + d) : 0;
      qa[kk][2] =
          live[0] ? *reinterpret_cast<const uint32_t*>(qp[0] + d + 8) : 0;
      qa[kk][3] =
          live[1] ? *reinterpret_cast<const uint32_t*>(qp[1] + d + 8) : 0;
    }
  }

  const __nv_bfloat16* kb = k + b * ks_.b + (int64_t)kvh * ks_.h;
  const __nv_bfloat16* vb = v + b * vs_.b + (int64_t)kvh * vs_.h;
  // causal: up to the stage of the block's last live row's position
  const int r_last = min(r_blk + kMRows, rows) - 1;
  const int n_stages = causal ? (q_offset + r_last / G) / kStageKeys + 1
                              : (Skv + kStageKeys - 1) / kStageKeys;
  const bool warp_live = r_warp < rows;
  const int warp_first_pos = q_offset + r_warp / G;
  const int warp_last_pos = q_offset + (min(r_warp + 16, rows) - 1) / G;

  auto load_stage = [&](int st, int buf) {
    const int c0 = st * kStageKeys;
    __nv_bfloat16* dk = sk + buf * kStageKeys * LD;
    __nv_bfloat16* dv = sv + buf * kStageKeys * LD;
    for (int i = tid; i < kStageKeys * CH; i += kThreads) {
      const int j = i / CH, c = (i % CH) * 8;
      const bool in = c0 + j < Skv;
      const int64_t jj = in ? c0 + j : 0;
      cp_async16(dk + j * LD + c, kb + jj * ks_.s + c, in);
      cp_async16(dv + j * LD + c, vb + jj * vs_.s + c, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  load_stage(0, 0);
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      load_stage(st + 1, (st + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();                     // stage's K/V visible to all warps
    // key group kg takes the stage's keys [c0, c0 + 64)
    const int c0 = st * kStageKeys + kg * kKeys;
    if (warp_live && c0 < Skv && (!causal || c0 <= warp_last_pos)) {
      const __nv_bfloat16* tk = sk + ((st & 1) * kStageKeys + kg * kKeys) * LD;
      const __nv_bfloat16* tv = sv + ((st & 1) * kStageKeys + kg * kKeys) * LD;
      float s[kKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      // S = Q K^T: ldmatrix x4 gives b0/b1 of two 8-key n-tiles
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t (&a)[4] = qa[Cfg::kWide ? 0 : kk];
        if constexpr (Cfg::kWide) {
          ldsm_x4(a, sq + (wr * 16 + lane % 16) * LD + 16 * kk +
                         (lane / 16) * 8);
        }
#pragma unroll
        for (int jp = 0; jp < kKeys / 16; ++jp) {
          uint32_t r[4];
          ldsm_x4(r, tk + (16 * jp + (lane / 16) * 8 + lane % 8) * LD +
                         16 * kk + ((lane / 8) & 1) * 8);
          mma16816(s[2 * jp], a, r[0], r[1]);
          mma16816(s[2 * jp + 1], a, r[2], r[3]);
        }
      }
      if (c0 + kKeys > Skv || (causal && c0 + kKeys - 1 > warp_first_pos))
        softmax_tile<true, HD>(s, acc, m, l, c0, tig, pos, Skv, causal,
                               scale_log2);
      else
        softmax_tile<false, HD>(s, acc, m, l, c0, tig, pos, Skv, causal,
                                scale_log2);
      // O += P V: P from the S fragments, V through ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < kKeys / 16; ++kc) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                                pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                                pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t r[4];
          ldsm_x4_t(r, tv + (16 * kc + ((lane / 8) & 1) * 8 + lane % 8) * LD +
                           16 * dp + (lane / 16) * 8);
          mma16816(acc[2 * dp], pa, r[0], r[1]);
          mma16816(acc[2 * dp + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();                     // stage free for the next load
  }
  // key groups 1.. hand their partials to group 0 through the free ring,
  // laid out [group][value][row-warp thread] so that the stores are
  // conflict-free; group 0 folds them in group order
  constexpr int kPart = 4 + HD / 2;      // m, l (2 rows each), acc
  constexpr int kPT = 32 * kRowWarps;    // threads of one key group
  static_assert((kKeyGroups - 1) * kPart * kPT * sizeof(float) <=
                    2 * 2 * kStageKeys * LD * sizeof(__nv_bfloat16),
                "the ring holds the hand-over");
  static_assert(Cfg::kSmem <= 232448, "the block fits in shared memory");
  const int pt = wr * 32 + lane;
  if (kg > 0) {
    float* part = reinterpret_cast<float*>(smem_raw) + (kg - 1) * kPart * kPT;
    part[0 * kPT + pt] = m[0];
    part[1 * kPT + pt] = m[1];
    part[2 * kPT + pt] = l[0];
    part[3 * kPT + pt] = l[1];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[(4 + 4 * n + j) * kPT + pt] = acc[n][j];
  }
  __syncthreads();
  if (kg > 0 || !warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* part = reinterpret_cast<const float*>(smem_raw);
    float mx = m[i];
#pragma unroll
    for (int k = 0; k < kKeyGroups - 1; ++k)
      mx = fmaxf(mx, part[k * kPart * kPT + i * kPT + pt]);
    float e[kKeyGroups];
    e[0] = ex2(m[i] - mx);
    float li = l[i] * e[0];
#pragma unroll
    for (int k = 1; k < kKeyGroups; ++k) {
      const float* pk = part + (k - 1) * kPart * kPT;
      e[k] = ex2(pk[i * kPT + pt] - mx);
      li += pk[(2 + i) * kPT + pt] * e[k];
    }
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (!live[i]) continue;
    if (lp[i] && tig == 0) *lp[i] = (mx + log2f(li)) * (1.f / kLog2e);
    const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      float a0 = acc[n][2 * i] * e[0], a1 = acc[n][2 * i + 1] * e[0];
#pragma unroll
      for (int k = 1; k < kKeyGroups; ++k) {
        const float* pk = part + (k - 1) * kPart * kPT;
        a0 += pk[(4 + 4 * n + 2 * i) * kPT + pt] * e[k];
        a1 += pk[(4 + 4 * n + 2 * i + 1) * kPT + pt] * e[k];
      }
      *reinterpret_cast<uint32_t*>(op[i] + 8 * n + 2 * tig) =
          pack_bf16(a0 * inv, a1 * inv);
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int q_offset, int KV,
               int G, int causal,
               Strides qs, Strides ks, Strides vs, Strides os,
               cudaStream_t stream) {
  const size_t smem = MmaCfg<HD>::kSmem;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((G * Sq + kMRows - 1) / kMRows, KV, B);
  flash_mma_kernel<HD><<<grid, MmaCfg<HD>::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Sq, Skv, q_offset, G, causal, qs, ks, vs, os,
      kLog2e / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ float32, CUDA cores
constexpr int kRows = 64;          // query rows per block
constexpr int kCols = 64;          // keys per staged tile
constexpr int kChunk = 16;         // keys scored per online-softmax step

// Threads per query row: one up to hd 64 (a row's q and accumulator in
// 2 * hd registers), then hd / 64 (2 * 64 registers each; one thread of
// an hd-128 row spilled 804 bytes).
template <int HD>
constexpr int kF32Split = HD > 64 ? HD / 64 : 1;

template <int HD>
__global__ void __launch_bounds__(kRows * kF32Split<HD>) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int Sq, int Skv, int q_offset, int G,
    int causal, Strides qs, Strides ks_, Strides vs_, Strides os,
    float scale) {
  constexpr int kSplit = kF32Split<HD>;
  constexpr int DS = HD / kSplit;    // dimensions a thread holds
  constexpr int kBlock = kRows * kSplit;
  extern __shared__ float smem[];
  float* kt = smem;                  // (kCols, HD)
  float* vt = kt + kCols * HD;       // (kCols, HD)
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / kSplit, part = tid % kSplit;
  // the row's kSplit neighbouring lanes, which shuffle among themselves
  const unsigned gmask =
      kSplit == 1 ? 1u << (tid % 32)
                  : ((1u << kSplit) - 1) << ((tid % 32) & ~(kSplit - 1));
  const int row = qt * kRows + r;      // query row in q
  const bool live = row < Sq;
  const int pos = q_offset + row;       // its absolute key position
  const int kvh = h / G;

  float qr[DS], acc[DS];                // dimension part + kSplit * i
  const float* qp = q + b * qs.b + (int64_t)row * qs.s + (int64_t)h * qs.h;
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    qr[i] = live ? qp[part + kSplit * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const float* kb = k + b * ks_.b + (int64_t)kvh * ks_.h;
  const float* vb = v + b * vs_.b + (int64_t)kvh * vs_.h;
  // causal: up to the tile of the block's last live row's position
  const int last = q_offset + min(qt * kRows + kRows, Sq) - 1;
  const int n_tiles = causal ? last / kCols + 1 : (Skv + kCols - 1) / kCols;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * kCols;
    __syncthreads();                 // previous tile fully consumed
    for (int i = tid; i < kCols * HD; i += kBlock) {
      const int j = i / HD, d = i % HD;
      const bool in = c0 + j < Skv;
      kt[i] = in ? kb[(int64_t)(c0 + j) * ks_.s + d] : 0.f;
      vt[i] = in ? vb[(int64_t)(c0 + j) * vs_.s + d] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    int n_keys = min(kCols, Skv - c0);
    if (causal) n_keys = min(n_keys, pos - c0 + 1);   // <= 0: skip tile
    for (int j0 = 0; j0 < n_keys; j0 += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        s[jj] = kNegInf;
        if (j < n_keys) {
          const float* kj = kt + j * HD + part;
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < DS; ++i) dot = fmaf(qr[i], kj[kSplit * i], dot);
#pragma unroll
          for (int w = 1; w < kSplit; w <<= 1)
            dot += __shfl_xor_sync(gmask, dot, w);
          s[jj] = dot * scale;
          cmax = fmaxf(cmax, s[jj]);
        }
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DS; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        if (j < n_keys) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float* vj = vt + j * HD + part;
#pragma unroll
          for (int i = 0; i < DS; ++i) acc[i] = fmaf(p, vj[kSplit * i], acc[i]);
        }
      }
      m = m_new;
    }
  }
  if (live) {
    float* op = o + b * os.b + (int64_t)row * os.s + (int64_t)h * os.h;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DS; ++i) op[part + kSplit * i] = acc[i] * inv;
    if (lse && part == 0)
      lse[((int64_t)b * gridDim.y + h) * Sq + row] = m + logf(l);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int q_offset, int H,
               int G, int causal,
               Strides qs, Strides ks, Strides vs, Strides os,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kCols * HD;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_f32_kernel<HD><<<grid, kRows * kF32Split<HD>, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv,
      q_offset, G, causal, qs, ks, vs, os, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int Sq, int Skv, int q_offset, int H, int KV,
           int causal,
           Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<HD>(q, k, v, o, lse, B, Sq, Skv, q_offset, H, H / KV,
                          causal, qs, ks, vs, os, st);
  if (dtype == 1)
    return launch_mma<HD>(q, k, v, o, lse, B, Sq, Skv, q_offset, KV, H / KV,
                          causal, qs, ks, vs, os, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o: (B, Sq, H, hd), k/v: (B, Skv,
// KV, hd), strides in elements for the batch, sequence and head axes; the
// head_dim axis must be contiguous, and in bf16 every row of k and v
// starts on a 16-byte boundary and every row of q and o on a 4-byte one.
// hd in {16, 32, 64, 128, 256}.  Query row r sits at absolute position
// q_offset + r; causal calls need q_offset + Sq <= Skv.  ``lse`` is null,
// or (B, H, Sq) f32 contiguous for each row's log-sum-exp.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int q_offset, int H, int KV, int hd, int causal,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    void* stream, float* lse) {
  if (KV <= 0 || H % KV != 0 || q_offset < 0 ||
      (causal && q_offset + Sq > Skv))
    return (int)cudaErrorInvalidValue;
  Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K3_LAUNCH(HD)                                                     \
  return launch<HD>(dtype, q, k, v, o, lse, B, Sq, Skv, q_offset, H, KV,   \
                    causal,                                               \
                    qs, ks, vs, os, st)
  switch (hd) {
    case 16:
      K3_LAUNCH(16);
    case 32:
      K3_LAUNCH(32);
    case 64:
      K3_LAUNCH(64);
    case 128:
      K3_LAUNCH(128);
    case 256:
      K3_LAUNCH(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K3_LAUNCH
}
