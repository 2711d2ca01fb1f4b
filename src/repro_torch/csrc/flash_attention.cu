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
// bf16 (the serving dtype) runs on the tensor cores, by one of two
// designs.  Both stack GQA rows into M: the G query heads of one KV head
// and the Sq query rows form G * Sq stacked rows (row r = query row r / G,
// head r % G), cut into 64-row tiles, one block per (row tile, KV head,
// batch row), so every K/V tile is read once per group instead of G times
// and the 16- and 32-token buckets fill most of a tile.  Both skip the
// per-element mask on a tile that crosses no row's diagonal and no end of
// the keys (the same arithmetic on every unmasked score), keep P in
// registers rounded to bf16 between the two products, and give extend
// rows equal to cold-prefill rows bit for bit: key tiles start at
// absolute key 0 and run in the same order for every row; a tile fully
// masked for a row leaves its (m, l, acc) bitwise unchanged (alpha is
// exp2(0) = 1, every p is 0), and so does folding in an empty partial;
// and a row's arithmetic reads only its own q, the tile and its own
// state (each product's output element is its own dot product).
//
// Up to head width 64 (smollm, musicgen): mma.sync.
//  * Two key groups of 4 warps (16 rows each): a ring stage holds 128
//    keys, group k takes the stage's k-th 64 keys with its own online
//    softmax, and group 1 hands its partial to group 0 through shared
//    memory at the end.  This halves the chain of tile steps of the last
//    row tile, which walks every key tile of a causal prefill; a third
//    group bought nothing at S 512 and slowed the small buckets, as the
//    SM's issue slots, not the chain, then set the pace.
//  * QK^T and PV with mma.sync.m16n8k16 (bf16 in, f32 accumulate), K and
//    V fragments through ldmatrix (V transposed).  Its 16-row granularity
//    lets each warp skip the key tiles past its own rows' diagonal.
//  * K/V stages of 128 keys brought by cp.async (16 bytes a thread) into
//    a two-stage ring in shared memory, rows padded by 16 bytes so that
//    ldmatrix is free of bank conflicts; keys past Skv are zero-filled.
//
// Head widths 128 and 256 (jamba, llama-3.2-vision, gemma3): wgmma.  The
// mma.sync shape, stretched there, lost 1.5-2.5x to SDPA: at hd 128 the
// two key groups' q fragments, accumulators and scores filled the
// registers of one block an SM, and at hd 256 one key group re-read q by
// ldmatrix every k-step at 247 registers.  What bounds these calls is
// latency, not the card's rates (at S 512 the 1.1-4.3 GFLOP take 1-4 us
// at the bf16 peak): a tile step is a chain of dependent products and a
// softmax, and a block pays a fixed start (barriers, q and the first K/V
// tiles from memory: ~3-4 us measured) before its first step.
//  * A producer warp and one or two consumer warpgroups (4 warps, 16
//    stacked rows each, 64 rows a warpgroup) a block.  Each warpgroup
//    stages its q tile once (cp.async, any G and stride) into the
//    128-byte-swizzled layout wgmma reads; K and V tiles of 64 keys
//    arrive by TMA (a 4-d tensor map over k or v in model layout:
//    64-column boxes, as a swizzled row holds 128 bytes; keys past Skv
//    come as zeros) into an mbarrier ring that the producer keeps full.
//  * S = Q K^T with wgmma.m64n64k16 from shared-memory descriptors (both
//    K-major), f32 accumulators; the online softmax in f32 as below; O +=
//    P V with wgmma.m64n{hd}k16, P from the score registers (the
//    accumulator's layout is the A operand's) and V MN-major through the
//    transpose bit.  An accumulator of 64 x 256 is 128 registers a
//    thread: hd 256 takes 255, one block an SM (setmaxnreg has nothing to
//    move there); hd 128 takes ~168.
//  * hd 128 takes two consumer warpgroups over one ring (128 rows a
//    block: half the K/V loads and half the block starts) once 64-row
//    blocks would outnumber the SMs, else one, two such blocks an SM
//    (112 KB of shared memory each).  Both share every tile step of the
//    block; a tile past a warpgroup's rows' diagonal leaves them as they
//    were.  Pipelining a warpgroup's walk by one tile (tile i's softmax
//    beside tile i-1's P V, FA3's way) measured slower here and spilled.
//  * The keys split by absolute index (kernels/flash_attention.py
//    key_chunks, flash_launch_plan): chunk c = keys [256 c, 256 (c + 1)),
//    each walked from a fresh (m, l, acc) and folded in chunk order by
//    fold_partial, whose pinned operations give the same bits wherever
//    the partials sit.  When a row tile's keys take 2..8 chunks and the
//    split grid still runs at once, its walk is split over a
//    thread-block cluster, rank r walking chunk r alone, and rank 0
//    folds the others' partials from their shared memory (mbarriers in
//    cluster scope; no second launch, no global scratch, no atomics);
//    otherwise one block walks every chunk and keeps the running fold in
//    shared memory.  Either way each row folds the same partials in the
//    same order: extend == cold and a row alone == the row in a batch
//    hold whatever the split and the block shape.
//  * Causal row tiles are launched longest first (grid z reversed), so
//    the tiles that walk every key do not wait for a last wave.
//  * The launcher builds the two tensor maps on the host each call
//    (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: the library
//    links no -lcuda).
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, s, h;
};

// ----------------------------------------------------------- bf16, mma.sync
constexpr int kRowWarps = 4;             // warps along the stacked rows
constexpr int kMRows = 16 * kRowWarps;   // stacked rows per block
constexpr int kKeys = 64;                // keys per warp tile

// The block's shape (hd up to 64): two key groups (warps along the keys)
// over 128-key stages, q's A fragments in registers.
template <int HD>
struct MmaCfg {
  static constexpr int kKeyGroups = 2;
  static constexpr int kThreads = 32 * kRowWarps * kKeyGroups;
  static constexpr int kStageKeys = kKeys * kKeyGroups;   // keys a stage
  static constexpr int LD = HD + 8;      // padded smem row (elements)
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * 2 * 2 * kStageKeys * LD;
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
  // q as A fragments, in registers
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int d = 16 * kk + 2 * tig;
    qa[kk][0] = live[0] ? *reinterpret_cast<const uint32_t*>(qp[0] + d) : 0;
    qa[kk][1] = live[1] ? *reinterpret_cast<const uint32_t*>(qp[1] + d) : 0;
    qa[kk][2] =
        live[0] ? *reinterpret_cast<const uint32_t*>(qp[0] + d + 8) : 0;
    qa[kk][3] =
        live[1] ? *reinterpret_cast<const uint32_t*>(qp[1] + d + 8) : 0;
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
        const uint32_t (&a)[4] = qa[kk];
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

// ------------------------------------------- bf16 at hd 128 and 256, wgmma
constexpr int kWgKeys = 64;           // keys of a tile
constexpr int kKeyChunk = 256;        // keys of a partial (KEY_CHUNK)
constexpr int kChunkTiles = kKeyChunk / kWgKeys;
constexpr int kMaxSplits = 8;         // the portable cluster size
constexpr int kSlab = 64 * 128;       // 64 rows of 128 bytes: one swizzled slab

// Shared memory of one block, in bytes from a 1024-byte aligned base: the
// consumers' stacked q tiles, the K and V rings (kSlabs slabs of 64 rows x
// 64 columns a tile, each brought by one TMA box) and the barriers; then,
// only when one block walks several chunks, a chunk partial per consumer
// thread (the running fold).  A split rank hands its partials to rank 0
// from its ring, free once its walk is done.
template <int HD, int C>
struct WgCfg {
  // C consumer warpgroups, each with its own 64 stacked rows, over one
  // ring; one (C 1, hd 128) block takes 112 KB of shared memory and two
  // fit an SM, unless it walks several chunks
  static constexpr int kConsumers = C;
  static constexpr int kRows = 64 * C;       // stacked rows a block
  static constexpr int kThreads = 128 * C + 32;
  static constexpr int kBlocksPerSM = HD == 128 && C == 1 ? 2 : 1;
  static constexpr int kSlabs = HD / 64;
  static constexpr int kTile = kSlabs * kSlab;
  static constexpr int kStages = HD > 128 ? 2 : 3;
  static constexpr int kPart = HD / 8 + 1;   // float4 a thread: (m, l), acc
  static constexpr int kPartBytes = 128 * kPart * 16;   // one warpgroup's
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + C * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kT = kBar + 1024;
  static constexpr int kSmem = kBar + (2 * kStages + 2) * 8;
  static constexpr int kSmemFold = kT + C * kPartBytes;
  static_assert(kSmemFold <= 232448, "the block fits in shared memory");
  static_assert(C * kPartBytes <= 2 * kStages * kTile,
                "the ring holds a split rank's partials");
  static_assert(kBlocksPerSM == 1 || 2 * (kSmem + 1024) <= 233472,
                "two blocks fit an SM");
};

struct WgArgs {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  float* lse;
  int Sq, Skv, q_offset, G, KV, causal;
  Strides qs, os;
  float scale_log2;
};

// One chunk partial folded into another in chunk order: (m, l, acc) of the
// earlier chunks (T) and of the next one (p) give max(mT, mp), lT * a +
// lp * b and accT * a + accp * b with a = 2^(mT - m), b = 2^(mp - m).  The
// operations are pinned (no contraction), so a fold gives the same bits
// wherever its operands come from: registers, this block's shared memory
// or another block's.  An empty partial (m -1e30, l 0, acc 0) folds in on
// either side as the identity.  kRegsT: the registers hold T, `load`
// gives p; else `load` gives T and the registers p.  The result is left
// in the registers.
template <int HD, bool kRegsT, class Load>
__device__ __forceinline__ void fold_partial(float (&acc)[HD / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             Load load) {
  const float4 ml = load(0);
  const float om[2] = {ml.x, ml.y}, ol[2] = {ml.z, ml.w};
  float wa[2], wb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mt = kRegsT ? m[i] : om[i], mp = kRegsT ? om[i] : m[i];
    const float lt = kRegsT ? l[i] : ol[i], lq = kRegsT ? ol[i] : l[i];
    const float mx = fmaxf(mt, mp);
    wa[i] = ex2(mt - mx);
    wb[i] = ex2(mp - mx);
    l[i] = __fmaf_rn(lt, wa[i], __fmul_rn(lq, wb[i]));
    m[i] = mx;
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const float4 x = load(1 + n);
    const float ov[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float t = kRegsT ? acc[n][e] : ov[e], p = kRegsT ? ov[e] : acc[n][e];
      acc[n][e] = __fmaf_rn(t, wa[e / 2], __fmul_rn(p, wb[e / 2]));
    }
  }
}

template <int HD>
__device__ __forceinline__ void empty_partial(float (&acc)[HD / 8][4],
                                              float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;
}

// the thread's partial into its slots of `part` ([kPart][128] float4)
template <int HD>
__device__ __forceinline__ void store_partial(float4* part, int tid,
                                              const float (&acc)[HD / 8][4],
                                              const float (&m)[2],
                                              const float (&l)[2]) {
  part[tid] = make_float4(m[0], m[1], l[0], l[1]);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    part[(1 + n) * 128 + tid] =
        make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
}

template <int HD, int C>
__global__ void __launch_bounds__(WgCfg<HD, C>::kThreads,
                                  WgCfg<HD, C>::kBlocksPerSM)
    flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const WgArgs a) {
  using Cfg = WgCfg<HD, C>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* smem = wg_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* ready = empty + kStages;     // rank 0: the split ranks' partials
  uint64_t* done = ready + 1;            // rank > 0: rank 0 has read it
  constexpr int kC = Cfg::kConsumers;
  const int n_split = (int)cluster_size(), rank = (int)cluster_rank();
  // grid (n_split x KV, B, row tiles); causal: the longest row tiles,
  // which walk the most keys, are launched first
  const int kvh = blockIdx.x / n_split, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, rows = G * a.Sq;
  const int r_blk =
      (a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * Cfg::kRows;
  // the tiles of keys the block's rows attend: causal, up to the tile of
  // its last live row's position; the chunk of tile it is it / kChunkTiles
  const int key_tiles = (a.Skv + kWgKeys - 1) / kWgKeys;
  const int r_last = min(r_blk + Cfg::kRows, rows) - 1;
  const int n_tiles =
      a.causal ? min(key_tiles, (a.q_offset + r_last / G) / kWgKeys + 1)
               : key_tiles;
  const int n_chunks = (n_tiles + kChunkTiles - 1) / kChunkTiles;
  // split: rank r walks chunk r alone (the launcher keeps every row
  // tile's chunks within the cluster); else the block walks them all
  const int active = n_split > 1 ? n_chunks : 1;
  const int t_lo = n_split > 1 ? rank * kChunkTiles : 0;
  const int t_hi = n_split > 1 ? min(n_tiles, t_lo + kChunkTiles) : n_tiles;

  if (tid == 0) {
    if ((__cvta_generic_to_shared(smem) & 1023) != 0) __trap();
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kC);
    }
    mbar_init(ready, active > 1 ? (active - 1) * kC : 1);
    mbar_init(done, kC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every barrier is initialised before any block of the cluster uses it
  if (n_split > 1) {
    cluster_sync_all();
  } else {
    __syncthreads();
  }
  if (rank >= active) return;            // no chunk of this row tile

  if (warp == 4 * kC) {
    // producer: one thread keeps the ring's TMA loads in flight
    if (lane == 0) {
      for (int i = 0, it = t_lo; it < t_hi; ++i, ++it) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect(&full[s], 2 * Cfg::kTile);
#pragma unroll
        for (int sl = 0; sl < Cfg::kSlabs; ++sl) {
          tma_load_4d(smem + Cfg::kK + s * Cfg::kTile + sl * kSlab, &tk,
                      64 * sl, kvh, it * kWgKeys, b, &full[s]);
          tma_load_4d(smem + Cfg::kV + s * Cfg::kTile + sl * kSlab, &tv,
                      64 * sl, kvh, it * kWgKeys, b, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg holds stacked rows 64 wg .. 64 wg + 63 of the
  // block, its warp w rows 16w .. 16w + 15 of those; every warpgroup walks
  // every tile of the block (a tile past its rows' diagonal leaves them
  // unchanged)
  const int wg = tid / 128, ctid = tid % 128;
  const int bar_id = 1 + wg;             // the warpgroup's named barrier
  const int gid = lane >> 2, tig = lane & 3;
  const int r_wg = r_blk + 64 * wg;
  const int r_warp = r_wg + (warp % 4) * 16;
  // the running fold (one block, several chunks) or a split rank's
  // partial (in its ring), this warpgroup's slots
  float4* part = reinterpret_cast<float4*>(
      smem + (n_split > 1 ? Cfg::kK : Cfg::kT) + wg * Cfg::kPartBytes);
  // this thread's two stacked rows, gid and gid + 8 of its warp's 16, at
  // their key positions (dead rows at q_offset)
  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_warp + gid + 8 * i;
    pos[i] = a.q_offset + (r < rows ? r / G : 0);
  }
  // the warpgroup's stacked q tile, once, into the 128-byte swizzled
  // layout the descriptors read (16-byte chunk c of row j of a slab at
  // c ^ (j % 8)); dead rows are zero-filled
  unsigned char* sq = smem + Cfg::kQ + wg * Cfg::kTile;
  for (int i = ctid; i < 64 * (HD / 8); i += 128) {
    const int j = i / (HD / 8), c = i % (HD / 8);
    const int r = r_wg + j;
    const bool in = r < rows;
    const int qrow = in ? r / G : 0, g = in ? r % G : 0;
    cp_async16(sq + (c / 8) * kSlab + j * 128 + (((c % 8) ^ (j & 7)) << 4),
               a.q + b * a.qs.b + (int64_t)qrow * a.qs.s +
                   (int64_t)(kvh * G + g) * a.qs.h + c * 8,
               in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_sync(bar_id, 128);
  const uint32_t q_base = smem_u32(sq);
  const int warp_first_pos = a.q_offset + r_warp / G;

  float acc[HD / 8][4];
  float m[2], l[2];
  empty_partial<HD>(acc, m, l);
  auto load_t = [&](int g) { return part[g * 128 + ctid]; };
  for (int i = 0, it = t_lo; it < t_hi; ++i, ++it) {
    if (it != t_lo && it % kChunkTiles == 0) {
      // a chunk ends: fold it into the running partial in shared memory
      // (the block's first chunk is stored as it is: empty (+) p == p)
      if (it != t_lo + kChunkTiles)
        fold_partial<HD, false>(acc, m, l, load_t);
      store_partial<HD>(part, ctid, acc, m, l);
      empty_partial<HD>(acc, m, l);
    }
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t kb = smem_u32(smem + Cfg::kK + s * Cfg::kTile);
    const uint32_t vb = smem_u32(smem + Cfg::kV + s * Cfg::kTile);
    // S = Q K^T: both K-major, 16 columns (32 bytes) of a slab a step
    float sc[kWgKeys / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(q_base + off, 16, 1024),
                   sw128_desc(kb + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    const int c0 = it * kWgKeys;
    if (c0 + kWgKeys > a.Skv ||
        (a.causal && c0 + kWgKeys - 1 > warp_first_pos))
      softmax_tile<true, HD>(sc, acc, m, l, c0, tig, pos, a.Skv, a.causal,
                             a.scale_log2);
    else
      softmax_tile<false, HD>(sc, acc, m, l, c0, tig, pos, a.Skv, a.causal,
                              a.scale_log2);
    // O += P V: P from the score registers (the accumulator's layout is
    // the A operand's), V MN-major through the transpose bit: 16 keys
    // (2048 bytes) a step, the slabs 8192 bytes apart along hd.  A
    // product's A registers stay untouched until it has landed; at hd
    // 256 the four steps go in two groups of two, which keeps 8 of them
    // live instead of 16 beside the 128 of the accumulator.
    constexpr int kGroups = HD > 128 ? 2 : 1;
    constexpr int kSteps = kWgKeys / 16 / kGroups;
#pragma unroll
    for (int grp = 0; grp < kGroups; ++grp) {
      uint32_t pa[kSteps][4];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int kc = grp * kSteps + j;
        pa[j][0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
        pa[j][1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
        pa[j][2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
        pa[j][3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
      }
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int kc = grp * kSteps + j;
        const uint64_t dv = sw128_desc(vb + kc * 2048, kSlab, 1024);
        if constexpr (HD == 128) {
          wgmma_rs_n128(acc, pa[j], dv);
        } else {
          wgmma_rs_n256(acc, pa[j], dv);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
    }
    if (ctid == 0) mbar_arrive(&empty[s]);  // the stage may be refilled
  }

  if (n_split > 1 && rank > 0) {
    // hand the chunk's partials to rank 0 from the ring, once every
    // consumer of the block is done with it, and stay until it has been
    // read
    named_sync(kC + 1, 128 * kC);
    fence_proxy_async();
    store_partial<HD>(part, ctid, acc, m, l);
    named_sync(bar_id, 128);
    if (ctid == 0) {
      mbar_arrive_remote(ready, 0);
      mbar_wait(done, 0);
    }
    return;
  }
  if (n_split > 1) {
    // rank 0 folds the other ranks' chunks in chunk order
    if (active > 1) mbar_wait_cluster(ready, 0);
    for (int c = 1; c < active; ++c) {
      const float4* rp = cg::this_cluster().map_shared_rank(part, c) + ctid;
      fold_partial<HD, true>(acc, m, l, [&](int g) { return rp[g * 128]; });
    }
    named_sync(bar_id, 128);
    if (ctid == 0)
      for (int c = 1; c < active; ++c) mbar_arrive_remote(done, c);
  } else if (n_tiles > t_lo + kChunkTiles) {
    fold_partial<HD, false>(acc, m, l, load_t);   // the last chunk
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = r_warp + gid + 8 * i;
    if (r >= rows) continue;
    const int qrow = r / G, g = r % G;
    if (a.lse && tig == 0)
      a.lse[((int64_t)b * a.KV * G + kvh * G + g) * a.Sq + qrow] =
          (m[i] + log2f(li)) * (1.f / kLog2e);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    __nv_bfloat16* op = a.o + b * a.os.b + (int64_t)qrow * a.os.s +
                        (int64_t)(kvh * G + g) * a.os.h + 2 * tig;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(op + 8 * n) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime: the library is
// linked without -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The (hd, KV, Skv, B) tensor of k or v in model layout, read in boxes of
// 64 columns x 1 head x 64 keys x 1 batch row with the 128-byte swizzle;
// keys past Skv come as zeros.  A dimension of extent 1 is never stepped,
// so it takes the packed stride (its own may be any value).
bool kv_map(CUtensorMap* map, const void* base, int HD, int KV, int Skv,
            int B, Strides st) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const int keys = Skv > 0 ? Skv : 1;
  cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)KV, (cuuint64_t)keys,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                           (cuuint64_t)st.b * 2};
  if (KV == 1) strides[0] = (cuuint64_t)HD * 2;
  if (keys == 1) strides[1] = strides[0] * KV;
  if (B == 1) strides[2] = strides[1] * keys;
  const cuuint32_t box[4] = {64, 1, kWgKeys, 1}, one[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Consumer warpgroups a block (wgmma_consumers) and blocks of the
// cluster that one row tile's key walk is split over (wgmma_split), as
// flash_launch_plan in kernels/flash_attention.py states them.  At hd 128
// a block takes two warpgroups (128 stacked rows over one K/V ring:
// half the loads and the per-block start-up) once 64-row blocks would
// outnumber the SMs, else one; hd 256 takes one.  A row tile's walk is
// split, one chunk a block, when its keys take 2 .. kMaxSplits chunks and
// the split grid still runs at once (two 64-row blocks an SM at hd 128);
// else one block walks every chunk (on a full card the split's cluster
// barrier and fold cost more than they save).  The result depends on
// neither.
int wgmma_consumers(int HD, long long rows64, int sms) {
  return HD == 128 && rows64 > sms ? 2 : 1;
}

int wgmma_split(long long blocks, int per_sm, int Sq, int Skv, int q_offset,
                int causal, int sms) {
  const int keys = causal ? q_offset + Sq : Skv;
  const int chunks = (keys + kKeyChunk - 1) / kKeyChunk;
  return chunks >= 2 && chunks <= kMaxSplits &&
                 blocks * chunks <= (long long)per_sm * sms
             ? chunks
             : 1;
}

template <int HD, int C>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Skv, int q_offset, int KV,
                 int G, int causal, Strides qs, Strides ks, Strides vs,
                 Strides os, int sms, cudaStream_t stream) {
  using Cfg = WgCfg<HD, C>;
  auto kern = flash_wgmma_kernel<HD, C>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemFold);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tk, tv;
  if (!kv_map(&tk, k, HD, KV, Skv, B, ks) ||
      !kv_map(&tv, v, HD, KV, Skv, B, vs))
    return (int)cudaErrorInvalidValue;
  const int row_tiles = (G * Sq + Cfg::kRows - 1) / Cfg::kRows;
  const int n = wgmma_split((long long)row_tiles * KV * B, Cfg::kBlocksPerSM,
                            Sq, Skv, q_offset, causal, sms);
  const int keys = causal ? q_offset + Sq : Skv;
  // the running fold's region only where one block walks several chunks
  const bool fold = n == 1 && keys > kKeyChunk;
  WgArgs args{static_cast<const __nv_bfloat16*>(q),
              static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, q_offset, G, KV,
              causal, qs, os, kLog2e / sqrtf((float)HD)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * KV, B, row_tiles);
  cfg.blockDim = dim3(Cfg::kThreads, 1, 1);
  cfg.dynamicSmemBytes = fold ? Cfg::kSmemFold : Cfg::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = n;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  void* params[] = {&tk, &tv, &args};
  cudaError_t e =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern), params);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Skv, int q_offset, int KV,
                 int G, int causal, Strides qs, Strides ks, Strides vs,
                 Strides os, cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long rows64 = (long long)(G * Sq + 63) / 64 * KV * B;
  if constexpr (HD == 128) {
    if (wgmma_consumers(HD, rows64, sms) == 2)
      return launch_wgmma<HD, 2>(q, k, v, o, lse, B, Sq, Skv, q_offset, KV,
                                 G, causal, qs, ks, vs, os, sms, stream);
  }
  return launch_wgmma<HD, 1>(q, k, v, o, lse, B, Sq, Skv, q_offset, KV, G,
                             causal, qs, ks, vs, os, sms, stream);
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
  if (dtype == 1) {
    if constexpr (HD >= 128) {
      return launch_wgmma<HD>(q, k, v, o, lse, B, Sq, Skv, q_offset, KV,
                              H / KV, causal, qs, ks, vs, os, st);
    } else {
      return launch_mma<HD>(q, k, v, o, lse, B, Sq, Skv, q_offset, KV,
                            H / KV, causal, qs, ks, vs, os, st);
    }
  }
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
