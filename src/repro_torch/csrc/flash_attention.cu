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
// a microsecond, and the kernel is limited by its own arithmetic on CUDA
// cores (no tensor cores yet) and by launch latency.  wgmma with TMA
// tiles is the later fix.
//
// Design:
//  * one block per (64-row q tile, head, batch row), one thread per query
//    row; the thread keeps its q row and f32 accumulator in registers;
//  * K/V tiles of 64 keys are staged in shared memory as f32 and read by
//    every row of the tile (broadcast reads);
//  * q, k, v and o are read and written in place in model layout
//    (B, S, H|KV, hd) through their strides: no transposed copies;
//  * causal: kv tiles run from tile 0 up to the diagonal only, keys past
//    the diagonal are skipped rather than masked, and tile 0 always holds
//    key 0, a live key of every row, so the running max is finite from
//    the first chunk on (a masked -1e30 never meets a row with no live
//    key);
//  * extend (q_offset > 0): each query row still runs its kv tiles from
//    absolute tile 0 in the same order and chunks, and skips every key
//    past its own absolute position, so a suffix row does exactly the
//    arithmetic that row does in a cold prefill of prefix + suffix (the
//    JAX contract of attention.py's extend branch);
//  * a ragged S (the 96-slot bucket) is masked here, not asserted away:
//    rows >= Sq compute nothing and keys >= Skv are never read.
// The launcher allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;          // query rows per block (= threads)
constexpr int kCols = 64;          // keys per staged tile
constexpr int kChunk = 16;         // keys scored per online-softmax step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  int64_t b, s, h;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kRows) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
    int q_offset, int G, int causal, Strides qs, Strides ks_, Strides vs_,
    Strides os, float scale) {
  extern __shared__ float smem[];
  float* kt = smem;                  // (kCols, HD)
  float* vt = kt + kCols * HD;       // (kCols, HD)
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x;
  const int row = qt * kRows + r;      // query row in q
  const bool live = row < Sq;
  const int pos = q_offset + row;       // its absolute key position
  const int kvh = h / G;

  float qr[HD], acc[HD];
  const T* qp = q + b * qs.b + (int64_t)row * qs.s + (int64_t)h * qs.h;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = live ? to_f32(qp[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const T* kb = k + b * ks_.b + (int64_t)kvh * ks_.h;
  const T* vb = v + b * vs_.b + (int64_t)kvh * vs_.h;
  // causal: up to the tile of the block's last live row's position
  const int last = q_offset + min(qt * kRows + kRows, Sq) - 1;
  const int n_tiles = causal ? last / kCols + 1 : (Skv + kCols - 1) / kCols;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * kCols;
    __syncthreads();                 // previous tile fully consumed
    for (int i = r; i < kCols * HD; i += kRows) {
      const int j = i / HD, d = i % HD;
      const bool in = c0 + j < Skv;
      kt[i] = in ? to_f32(kb[(int64_t)(c0 + j) * ks_.s + d]) : 0.f;
      vt[i] = in ? to_f32(vb[(int64_t)(c0 + j) * vs_.s + d]) : 0.f;
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
          const float* kj = kt + j * HD;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kj[d], dot);
          s[jj] = dot * scale;
          cmax = fmaxf(cmax, s[jj]);
        }
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        if (j < n_keys) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float* vj = vt + j * HD;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vj[d], acc[d]);
        }
      }
      m = m_new;
    }
  }
  if (live) {
    T* op = o + b * os.b + (int64_t)row * os.s + (int64_t)h * os.h;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int q_offset, int H, int G, int causal,
           Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kCols * HD;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)HD);
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_kernel<T, HD><<<grid, kRows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, q_offset, G,
      causal, qs, ks, vs, os, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Skv, int q_offset, int H, int G,
                int causal, Strides qs, Strides ks, Strides vs, Strides os,
                cudaStream_t st) {
#define K3_LAUNCH(HD)                                                     \
  return launch<T, HD>(q, k, v, o, B, Sq, Skv, q_offset, H, G, causal, qs, \
                       ks, vs, os, st)
  switch (hd) {
    case 16:
      K3_LAUNCH(16);
    case 32:
      K3_LAUNCH(32);
    case 64:
      K3_LAUNCH(64);
    case 128:
      K3_LAUNCH(128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K3_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o: (B, Sq, H, hd), k/v: (B, Skv,
// KV, hd), strides in elements for the batch, sequence and head axes; the
// head_dim axis must be contiguous.  hd in {16, 32, 64, 128}.  Query row
// r sits at absolute position q_offset + r; causal calls need
// q_offset + Sq <= Skv.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int q_offset, int H, int KV, int hd, int causal,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    void* stream) {
  if (KV <= 0 || H % KV != 0 || q_offset < 0 ||
      (causal && q_offset + Sq > Skv))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, Sq, Skv, q_offset, H, G,
                              causal, qs, ks, vs, os, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, q_offset,
                                      H, G, causal, qs, ks, vs, os, st);
  return (int)cudaErrorInvalidValue;
}
