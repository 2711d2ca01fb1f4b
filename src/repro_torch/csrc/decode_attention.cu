// K1: one-token GQA decode attention over the ring-buffer KV cache.
//
// Replaces the Pallas TPU kernel decode_attention_kernel / _decode_kernel
// (src/repro/kernels/decode_attention.py).  Same function: the G query heads
// of one KV head attend cache slots s <= t (every slot once the ring has
// wrapped, t >= S) with an online softmax kept in f32.
//
// What bounds it on an H100: bytes.  Each decoded token reads the live
// part of the cache once (2 * min(S, t+1) * KV * hd elements per layer)
// and does 4 FLOPs per element read, far below the ~295 FLOP/byte at which
// bf16 tensor-core work would be the limit.  At the serving shapes
// (B 1, KV 5, hd 64, S 512, bf16) that is at most 655 KB per layer, a
// fraction of a microsecond at 3.35 TB/s, so in practice the kernel is
// bound by launch latency and by parallelism: one block per (batch,
// KV head) is only 5 blocks on 132 SMs.  Splitting S across blocks
// (flash-decoding) is the later fix.
//
// Design:
//  * one block per (kv head, batch row); the K/V tile of the cache is
//    staged in shared memory once and reused by all G query heads of the
//    group (the G-fold read saving the TPU kernel had);
//  * the cache is read in place in the engine's layout (B, S, KV, hd)
//    through its strides: no transposed copy of the cache per call;
//  * the fill level t is read from device memory, so the host never
//    synchronises per decode step; the loop covers min(S, t+1) slots
//    only, instead of masking the whole buffer;
//  * q is read and the output written in model layout (B, 1, H, hd).
// The launcher allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;           // cache slots staged per step
constexpr float kNegInf = -1e30f;   // the reference's finite mask value

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

size_t smem_bytes(int G, int hd) {
  // q (G,hd) + K tile (kTile, hd+1) + V tile (kTile, hd) + p (G, kTile)
  // + acc (G, hd) + m, l, alpha (G each)
  return sizeof(float) * (2 * G * hd + kTile * (2 * hd + 1) + G * kTile +
                          3 * G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ t_ptr,
    T* __restrict__ o, int S, int G, int hd, int64_t q_sb, int64_t q_sh,
    int64_t c_sb, int64_t c_ss, int64_t c_sh, int64_t o_sb, int64_t o_sh,
    float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ld = hd + 1;             // padded K rows: conflict-free dots
  float* qs = smem;                  // (G, hd)
  float* ks = qs + G * hd;           // (kTile, ld)
  float* vs = ks + kTile * ld;       // (kTile, hd)
  float* ps = vs + kTile * hd;       // (G, kTile) scores, then weights
  float* acc = ps + G * kTile;       // (G, hd)
  float* m = acc + G * hd;           // (G) running max
  float* l = m + G;                  // (G) running sum
  float* alpha = l + G;              // (G) rescale of this step

  const int t = *t_ptr;
  const int n_valid = t + 1 < S ? t + 1 : S;

  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    qs[i] = to_f32(q[b * q_sb + (int64_t)(kvh * G + g) * q_sh + d]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m[tid] = kNegInf;
    l[tid] = 0.f;
  }
  const T* kb = k + b * c_sb + kvh * c_sh;
  const T* vb = v + b * c_sb + kvh * c_sh;
  __syncthreads();

  for (int s0 = 0; s0 < n_valid; s0 += kTile) {
    const int n = min(kTile, n_valid - s0);
    for (int i = tid; i < n * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const int64_t off = (int64_t)(s0 + j) * c_ss + d;
      ks[j * ld + d] = to_f32(kb[off]);
      vs[j * hd + d] = to_f32(vb[off]);
    }
    __syncthreads();
    for (int i = tid; i < G * n; i += kThreads) {
      const int g = i / n, j = i % n;
      const float* qg = qs + g * hd;
      const float* kj = ks + j * ld;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qg[d], kj[d], s);
      ps[g * kTile + j] = s * scale;
    }
    __syncthreads();
    if (tid < G) {                    // online-softmax step for head tid
      float* p = ps + tid * kTile;
      const float m_prev = m[tid];
      float m_new = m_prev;
      for (int j = 0; j < n; ++j) m_new = fmaxf(m_new, p[j]);
      float sum = 0.f;
      for (int j = 0; j < n; ++j) {
        const float e = expf(p[j] - m_new);
        p[j] = e;
        sum += e;
      }
      const float a = expf(m_prev - m_new);
      m[tid] = m_new;
      l[tid] = l[tid] * a + sum;
      alpha[tid] = a;
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i % hd;
      const float* p = ps + g * kTile;
      float a = acc[i] * alpha[g];
      for (int j = 0; j < n; ++j) a = fmaf(p[j], vs[j * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    o[b * o_sb + (int64_t)(kvh * G + g) * o_sh + d] =
        from_f32<T>(acc[i] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* t,
           void* o, int B, int S, int KV, int G, int hd, int64_t q_sb,
           int64_t q_sh, int64_t c_sb, int64_t c_ss, int64_t c_sh,
           int64_t o_sb, int64_t o_sh, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  decode_kernel<T><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(t),
      static_cast<T*>(o), S, G, hd, q_sb, q_sh, c_sb, c_ss, c_sh, o_sb, o_sh,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// (head_dim) axis of q, the caches and o must be contiguous.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* t, void* o,
    int dtype, int B, int S, int KV, int G, int hd, long long q_sb,
    long long q_sh, long long c_sb, long long c_ss, long long c_sh,
    long long o_sb, long long o_sh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, t, o, B, S, KV, G, hd, q_sb, q_sh, c_sb,
                         c_ss, c_sh, o_sb, o_sh, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, t, o, B, S, KV, G, hd, q_sb, q_sh,
                                 c_sb, c_ss, c_sh, o_sb, o_sh, st);
  return (int)cudaErrorInvalidValue;
}
