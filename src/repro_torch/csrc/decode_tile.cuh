// The one-token GQA decode body shared by K1 (ring cache,
// decode_attention.cu) and K2 (block-paged pool,
// paged_decode_attention.cu).
//
// Both kernels run this same template and differ only in where the K/V
// row of logical slot s lives: ring slot s of the lane's buffer, or
// in-page slot s % page of physical page bt[b, s / page].  The tile size,
// the slot order and every float32 operation are shared, so on the same
// logical contents the paged kernel's output is bitwise equal to the ring
// kernel's (paged lanes and ring lanes then decode the same tokens).
//
// One block per (kv head, lane).  The block stages kTile slots of K and V
// in shared memory as f32 and all G query heads of the group read them
// (the G-fold read saving of the TPU kernels); an online softmax per head
// keeps the running max, sum and accumulator in f32.  The fill level is
// read on the device, one shared value (t_stride 0) or one per lane
// (t_stride 1), and the loop covers min(S, t + 1) slots only: a ring that
// has wrapped attends every slot, and a lane whose t has run past its
// window (a stopped lane still stepping until its segment ends) stays
// finite.  The launcher allocates nothing and returns cudaGetLastError().

#pragma once

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
  int t_stride;             // 0: one shared t, 1: t[b]
  int page, P;              // paged only
  int64_t q_sb, q_sh, o_sb, o_sh;
  int64_t c_sb;             // ring: lane stride
  int64_t c_sp;             // paged: page stride
  int64_t c_ss, c_sh;       // slot stride (ring axis | in-page), head stride
  int64_t bt_sb;            // paged: block-table row stride
  float scale;
};

inline size_t smem_bytes(const DecodeArgs& a, bool paged) {
  // q (G,hd) + K tile (kTile, hd+1) + V tile (kTile, hd) + p (G, kTile)
  // + acc (G, hd) + m, l, alpha (G each) [+ the block-table row (P)]
  return sizeof(float) * (2 * a.G * a.hd + kTile * (2 * a.hd + 1) +
                          a.G * kTile + 3 * a.G) +
         (paged ? sizeof(int32_t) * a.P : 0);
}

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = a.G, hd = a.hd;
  const int ld = hd + 1;             // padded K rows: conflict-free dots
  float* qs = smem;                  // (G, hd)
  float* ks = qs + G * hd;           // (kTile, ld)
  float* vs = ks + kTile * ld;       // (kTile, hd)
  float* ps = vs + kTile * hd;       // (G, kTile) scores, then weights
  float* acc = ps + G * kTile;       // (G, hd)
  float* m = acc + G * hd;           // (G) running max
  float* l = m + G;                  // (G) running sum
  float* alpha = l + G;              // (G) rescale of this step
  int32_t* row = reinterpret_cast<int32_t*>(alpha + G);   // (P) paged

  const T* q = static_cast<const T*>(a.q);
  const T* kb = static_cast<const T*>(a.k) + kvh * a.c_sh;
  const T* vb = static_cast<const T*>(a.v) + kvh * a.c_sh;
  if (!kPaged) {
    kb += b * a.c_sb;
    vb += b * a.c_sb;
  }
  const int t = a.t[b * a.t_stride];
  const int n_valid = t + 1 < a.S ? t + 1 : a.S;

  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    qs[i] = to_f32(q[b * a.q_sb + (int64_t)(kvh * G + g) * a.q_sh + d]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m[tid] = kNegInf;
    l[tid] = 0.f;
  }
  if (kPaged) {                      // no scalar prefetch: load the row
    for (int i = tid; i < a.P; i += kThreads) row[i] = a.bt[b * a.bt_sb + i];
  }
  __syncthreads();

  for (int s0 = 0; s0 < n_valid; s0 += kTile) {
    const int n = min(kTile, n_valid - s0);
    for (int i = tid; i < n * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const int s = s0 + j;
      const int64_t off =
          kPaged ? (int64_t)row[s / a.page] * a.c_sp +
                       (int64_t)(s % a.page) * a.c_ss + d
                 : (int64_t)s * a.c_ss + d;
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
      ps[g * kTile + j] = s * a.scale;
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
      const float al = expf(m_prev - m_new);
      m[tid] = m_new;
      l[tid] = fmaf(l[tid], al, sum);
      alpha[tid] = al;
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i % hd;
      const float* p = ps + g * kTile;
      float acc_i = acc[i] * alpha[g];
      for (int j = 0; j < n; ++j) acc_i = fmaf(p[j], vs[j * hd + d], acc_i);
      acc[i] = acc_i;
    }
    __syncthreads();
  }
  T* o = static_cast<T*>(a.o);
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    o[b * a.o_sb + (int64_t)(kvh * G + g) * a.o_sh + d] =
        from_f32<T>(acc[i] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T, bool kPaged>
int launch_decode(const DecodeArgs& a, int B, int KV, cudaStream_t stream) {
  const size_t smem = smem_bytes(a, kPaged);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_kernel<T, kPaged><<<dim3(KV, B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kPaged>
int dispatch_dtype(int dtype, const DecodeArgs& a, int B, int KV,
                   cudaStream_t stream) {
  if (dtype == 0) return launch_decode<float, kPaged>(a, B, KV, stream);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16, kPaged>(a, B, KV, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
