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
// Shapes are the training ones: Sq == Skv == S, query row i at key
// position i, q/o/dO/dq (B, S, H, hd) and k/v/dk/dv (B, S, KV, hd), all
// contiguous, GQA through kv head = h / G; lse and D are (B, H, S) f32.
// bf16 and f32 in, the input dtype out, every sum in f32.
//
// What bounds it on an H100: operations.  A causal backward does five
// S x S x hd products per head over half the (q, k) plane, about
// 5 * 2 * H * hd * S^2 / 2 FLOPs on 4 H S hd + 4 KV S hd elements; at S
// 512, H 15, hd 64 that is ~S FLOPs a byte, past the bf16 ridge.  This
// first version runs them on the CUDA cores in f32 from tiles staged in
// shared memory (the tensor-core version is queued work): simple, and
// right.
//
// Design:
//  * Pass 2 (dK, dV): one block per (64-key tile, KV head, batch row).
//    It keeps its K and V tile in shared memory and walks, in a fixed
//    order, the G query heads of its KV head and, for each, the 64-row
//    query tiles that can see the tile (from the diagonal on when
//    causal).  The G heads' contributions sum inside the block, so no
//    two blocks write one dK or dV row.
//  * Pass 3 (dQ): one block per (64-row query tile, head, batch row),
//    walking the key tiles up to the diagonal.
//  * Each (query tile, key tile) step recomputes S = q k^T and
//    dP = dO v^T for its 64 x 64 tile (256 threads, a 4 x 4 patch each),
//    turns them into P and dS in shared memory, and then every thread
//    updates the hd / 4 accumulator entries of the one key (pass 2) or
//    query row (pass 3) it owns.
//  * No atomics and a fixed walk: two runs give the same bits.
//  * Shared-memory rows are padded by one float, so the column walks of
//    the products are free of bank conflicts.
//
// The launcher runs the three passes on the caller's stream, allocates
// nothing (D is a (B, H, S) f32 scratch the wrapper passes) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kLdT = kTile + 1;    // padded row of a P / dS tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [r0, r0 + 64) of head h of a (B, S, heads, HD) tensor into a
// (64, HD + 1) f32 tile; rows past S are zero
template <int HD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int b, int r0,
                                      int S, int heads, int h) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = r0 + r;
    dst[r * (HD + 1) + d] =
        row < S ? to_f32(src[(((int64_t)b * S + row) * heads + h) * HD + d])
                : 0.f;
  }
}

// P and dS of one (query tile q0, key tile k0) step.  Thread t computes
// rows ti + 16 a and keys tj + 16 c (a, c in 0..3; ti = t / 16, tj =
// t % 16).  Masked entries (a key past S or, when causal, past the row's
// position; a row past S) are 0 in both.  sP may be null (pass 3).
template <int HD>
__device__ __forceinline__ void p_ds_tile(
    const float* sQ, const float* sK, const float* sV, const float* sdO,
    const float* sL, const float* sD, int q0, int k0, int S, int causal,
    float scale, float* sP, float* sdS) {
  constexpr int LD = HD + 1;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[a][c] = 0.f;
      dp[a][c] = 0.f;
    }
  }
  for (int d = 0; d < HD; ++d) {
    float qa[4], oa[4], kc[4], vc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sQ[(ti + 16 * a) * LD + d];
      oa[a] = sdO[(ti + 16 * a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = sK[(tj + 16 * c) * LD + d];
      vc[c] = sV[(tj + 16 * c) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(oa[a], vc[c], dp[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti + 16 * a, row = q0 + i;
    const float li = sL[i], di = sD[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tj + 16 * c, key = k0 + j;
      const bool in = row < S && key < S && (!causal || key <= row);
      const float p = in ? expf(s[a][c] * scale - li) : 0.f;
      if (sP) sP[i * kLdT + j] = p;
      sdS[i * kLdT + j] = p * (dp[a][c] - di);
    }
  }
}

// pass 1: D[b, h, i] = sum_d dO[b, i, h, d] * o[b, i, h, d], one thread a
// row
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ D, int B, int S, int H) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= (int64_t)B * S * H) return;
  const int h = r % H;
  const int64_t bs = r / H;
  const int i = bs % S, b = bs / S;
  const T* op = o + r * HD;
  const T* gp = dout + r * HD;
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) acc = fmaf(to_f32(gp[d]), to_f32(op[d]), acc);
  D[((int64_t)b * H + h) * S + i] = acc;
}

// pass 2: dK, dV of one 64-key tile of one KV head.  Thread t owns key
// j = t % 64 and the hd / 4 dims starting at (t / 64) * hd / 4.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV,
    int causal, float scale) {
  constexpr int LD = HD + 1, NC = HD / 4;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sdO = sQ + kTile * LD;
  float* sP = sdO + kTile * LD;
  float* sdS = sP + kTile * kLdT;
  float* sL = sdS + kTile * kLdT;
  float* sD = sL + kTile;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, k0 = kt * kTile;
  const int j = threadIdx.x % kTile, c0 = (threadIdx.x / kTile) * NC;
  stage<HD>(sK, k, b, k0, S, KV, kvh);
  stage<HD>(sV, v, b, k0, S, KV, kvh);
  float adk[NC], adv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) adk[c] = adv[c] = 0.f;
  const int nq = (S + kTile - 1) / kTile;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = causal ? kt : 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();               // the previous step's tiles are read
      stage<HD>(sQ, q, b, q0, S, H, h);
      stage<HD>(sdO, dout, b, q0, S, H, h);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const int64_t at = ((int64_t)b * H + h) * S + row;
        sL[threadIdx.x] = row < S ? lse[at] : 0.f;
        sD[threadIdx.x] = row < S ? D[at] : 0.f;
      }
      __syncthreads();
      p_ds_tile<HD>(sQ, sK, sV, sdO, sL, sD, q0, k0, S, causal, scale, sP,
                    sdS);
      __syncthreads();
      for (int i = 0; i < kTile; ++i) {
        const float p = sP[i * kLdT + j], ds = sdS[i * kLdT + j];
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
  if (key >= S) return;
  const int64_t at = (((int64_t)b * S + key) * KV + kvh) * HD + c0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    dk[at + c] = from_f32<T>(adk[c] * scale);
    dv[at + c] = from_f32<T>(adv[c]);
  }
}

// pass 3: dQ of one 64-row query tile of one head.  Thread t owns row
// i = t % 64 and the hd / 4 dims starting at (t / 64) * hd / 4.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dq, int S, int H, int KV, int causal, float scale) {
  constexpr int LD = HD + 1, NC = HD / 4;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * LD;
  float* sK = sdO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sdS = sV + kTile * LD;
  float* sL = sdS + kTile * kLdT;
  float* sD = sL + kTile;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV), q0 = qt * kTile;
  const int i = threadIdx.x % kTile, c0 = (threadIdx.x / kTile) * NC;
  stage<HD>(sQ, q, b, q0, S, H, h);
  stage<HD>(sdO, dout, b, q0, S, H, h);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    const int64_t at = ((int64_t)b * H + h) * S + row;
    sL[threadIdx.x] = row < S ? lse[at] : 0.f;
    sD[threadIdx.x] = row < S ? D[at] : 0.f;
  }
  float adq[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) adq[c] = 0.f;
  const int n_kt = causal ? qt + 1 : (S + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                 // the previous step's tiles are read
    stage<HD>(sK, k, b, k0, S, KV, kvh);
    stage<HD>(sV, v, b, k0, S, KV, kvh);
    __syncthreads();
    p_ds_tile<HD>(sQ, sK, sV, sdO, sL, sD, q0, k0, S, causal, scale,
                  nullptr, sdS);
    __syncthreads();
    for (int jj = 0; jj < kTile; ++jj) {
      const float ds = sdS[i * kLdT + jj];
      const float* kj = sK + jj * LD + c0;
#pragma unroll
      for (int c = 0; c < NC; ++c) adq[c] = fmaf(ds, kj[c], adq[c]);
    }
  }
  const int row = q0 + i;
  if (row >= S) return;
  const int64_t at = (((int64_t)b * S + row) * H + h) * HD + c0;
#pragma unroll
  for (int c = 0; c < NC; ++c) dq[at + c] = from_f32<T>(adq[c] * scale);
}

template <typename F>
int allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int S, int H, int KV, int causal,
           cudaStream_t st) {
  constexpr int LD = HD + 1;
  const float scale = 1.0f / sqrtf((float)HD);
  const int64_t rows = (int64_t)B * S * H;
  bwd_dot_kernel<HD, T><<<(unsigned)((rows + kThreads - 1) / kThreads),
                          kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), D, B, S, H);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const int nt = (S + kTile - 1) / kTile;
  const size_t smem2 =
      sizeof(float) * (4 * kTile * LD + 2 * kTile * kLdT + 2 * kTile);
  if ((e = allow_smem(bwd_dkdv_kernel<HD, T>, smem2))) return e;
  bwd_dkdv_kernel<HD, T><<<dim3(nt, KV, B), kThreads, smem2, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, D,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, causal, scale);
  if ((e = (int)cudaGetLastError())) return e;
  const size_t smem3 =
      sizeof(float) * (4 * kTile * LD + kTile * kLdT + 2 * kTile);
  if ((e = allow_smem(bwd_dq_kernel<HD, T>, smem3))) return e;
  bwd_dq_kernel<HD, T><<<dim3(nt, H, B), kThreads, smem3, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, D,
      static_cast<T*>(dq), S, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse, float* D,
                 void* dq, void* dk, void* dv, int B, int S, int H, int KV,
                 int causal, cudaStream_t st) {
  if (dtype == 0)
    return launch<HD, float>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, H,
                             KV, causal, st);
  if (dtype == 1)
    return launch<HD, __nv_bfloat16>(q, k, v, o, dout, lse, D, dq, dk, dv, B,
                                     S, H, KV, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout, dq: (B, S, H, hd); k, v,
// dk, dv: (B, S, KV, hd); all contiguous in that dtype.  lse and the
// scratch D: (B, H, S) f32 contiguous.  hd in {16, 32, 64, 128}.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* D, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int H, int KV, int hd, int causal,
    void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_dtype<16>(dtype, q, k, v, o, dout, lse, D, dq, dk, dv, B,
                              S, H, KV, causal, st);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, o, dout, lse, D, dq, dk, dv, B,
                              S, H, KV, causal, st);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, dout, lse, D, dq, dk, dv, B,
                              S, H, KV, causal, st);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, dout, lse, D, dq, dk, dv,
                               B, S, H, KV, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
