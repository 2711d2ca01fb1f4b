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
// What bounds it on an H100: latency, not bytes or operations.  An
// admission batch reads B * F features and at most depth + 1 nodes of
// each tree per sample; the whole ensemble (T 180, N 127: about 275 KB)
// stays in the 50 MB L2 across blocks.  Each level of a walk is a
// dependent load, so a walk is depth (6) L2 round trips long, and the
// time is that chain plus the launch.
//
// Design (both kernels):
//  * one block per sample; the sample's features sit in shared memory and
//    the block's threads stride over the trees, walking at most depth
//    levels each, and write each tree's leaf value to shared memory;
//  * a fixed-order per-class reduction follows: thread c sums trees
//    c, c+K, c+2K, ... in tree order.  No float atomics: P(Long) sets the
//    SJF dispatch order, so the margins must not change from run to run.
// K5 reads four (T, M) arrays instead of three (T, N): per step one more
// dependent load (child), but M <= N and no leaf test, and its walks are
// all exactly `depth` steps, so the warp's threads never diverge on a
// leaf.  Its class sums run in the same order as K4's, so on the same
// ensemble the two give the same margins bit for bit.
// The launchers allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) gbdt_kernel(
    const float* __restrict__ X, const int32_t* __restrict__ feature,
    const float* __restrict__ threshold, const float* __restrict__ value,
    float* __restrict__ out, int F, int T, int N, int K, int depth) {
  extern __shared__ float smem[];
  float* xs = smem;                  // (F) this sample's features
  float* leaf = xs + F;              // (T) leaf value reached in each tree
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < F; i += kThreads) xs[i] = X[(int64_t)b * F + i];
  __syncthreads();
  for (int tr = tid; tr < T; tr += kThreads) {
    const int64_t base = (int64_t)tr * N;
    int idx = 0;
    for (int level = 0; level < depth; ++level) {
      const int f = feature[base + idx];
      if (f < 0) break;              // leaf: the walk stays here
      idx = xs[f] < threshold[base + idx] ? 2 * idx + 1 : 2 * idx + 2;
    }
    leaf[tr] = value[base + idx];
  }
  __syncthreads();
  if (tid < K) {
    float s = 0.f;
    for (int tr = tid; tr < T; tr += K) s += leaf[tr];
    out[(int64_t)b * K + tid] = s;
  }
}

__global__ void __launch_bounds__(kThreads) gbdt_packed_kernel(
    const float* __restrict__ X, const int32_t* __restrict__ feat,
    const float* __restrict__ thr, const int32_t* __restrict__ child,
    const float* __restrict__ value, float* __restrict__ out, int F, int T,
    int M, int K, int depth, float base_score) {
  extern __shared__ float smem[];
  float* xs = smem;                  // (F) this sample's features
  float* leaf = xs + F;              // (T) leaf value reached in each tree
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < F; i += kThreads) xs[i] = X[(int64_t)b * F + i];
  __syncthreads();
  for (int tr = tid; tr < T; tr += kThreads) {
    const int64_t base = (int64_t)tr * M;
    int idx = 0;
    for (int step = 0; step < depth; ++step) {
      const int64_t n = base + idx;
      idx = child[n] + (xs[feat[n]] < thr[n] ? 0 : 1);
    }
    leaf[tr] = value[base + idx];
  }
  __syncthreads();
  if (tid < K) {
    float s = 0.f;
    for (int tr = tid; tr < T; tr += K) s += leaf[tr];
    out[(int64_t)b * K + tid] = s + base_score;
  }
}

cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// X: (B, F) f32; feature: (T, N) int32; threshold, value: (T, N) f32;
// out: (B, K) f32; all contiguous.  depth = log2(N + 1) - 1.
extern "C" int gbdt_margins_launch(const void* X, const void* feature,
                                   const void* threshold, const void* value,
                                   void* out, int B, int F, int T, int N,
                                   int K, int depth, void* stream) {
  if (K <= 0 || K > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(F + T);
  cudaError_t e = set_smem((const void*)gbdt_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  gbdt_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const int32_t*>(feature),
      static_cast<const float*>(threshold), static_cast<const float*>(value),
      static_cast<float*>(out), F, T, N, K, depth);
  return (int)cudaGetLastError();
}

// X: (B, F) f32; feat, child: (T, M) int32; thr, value: (T, M) f32; out:
// (B, K) f32; all contiguous.  Every feat entry is < F, and for finite
// features every walk from slot 0 stays inside its tree's M slots
// (core/ensemble_pack.py builds them so; the wrapper checks F).
extern "C" int gbdt_margins_packed_launch(const void* X, const void* feat,
                                          const void* thr, const void* child,
                                          const void* value, void* out, int B,
                                          int F, int T, int M, int K,
                                          int depth, float base_score,
                                          void* stream) {
  if (K <= 0 || K > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(F + T);
  cudaError_t e = set_smem((const void*)gbdt_packed_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  gbdt_packed_kernel<<<B, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const int32_t*>(feat),
      static_cast<const float*>(thr), static_cast<const int32_t*>(child),
      static_cast<const float*>(value), static_cast<float*>(out), F, T, M, K,
      depth, base_score);
  return (int)cudaGetLastError();
}
