// K4: batched GBDT ensemble scoring (the Clairvoyant predictor).
//
// Replaces the Pallas TPU kernel gbdt_margins_kernel / _gbdt_dense_kernel
// (src/repro/kernels/gbdt_infer.py).  Same function: every sample walks
// every complete binary tree (T, N) -- feature < 0 marks a leaf, go left
// iff x < threshold, children of node i at 2i+1 / 2i+2 -- and tree t adds
// its leaf value to class t % K.
//
// What bounds it on an H100: latency, not bytes or operations.  An
// admission batch reads B * F features and at most depth + 1 nodes of
// each tree per sample; the whole ensemble (T 180, N 127: about 275 KB)
// stays in the 50 MB L2 across blocks.  Each level of a walk is a
// dependent load, so a walk is depth (6) L2 round trips long, and the
// time is that chain plus the launch.
//
// Design:
//  * one block per sample; the sample's features sit in shared memory and
//    the block's threads stride over the trees, walking at most depth
//    levels each, and write each tree's leaf value to shared memory;
//  * a fixed-order per-class reduction follows: thread c sums trees
//    c, c+K, c+2K, ... in tree order.  No float atomics: P(Long) sets the
//    SJF dispatch order, so the margins must not change from run to run.
// The launcher allocates nothing and returns cudaGetLastError().

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

}  // namespace

// X: (B, F) f32; feature: (T, N) int32; threshold, value: (T, N) f32;
// out: (B, K) f32; all contiguous.  depth = log2(N + 1) - 1.
extern "C" int gbdt_margins_launch(const void* X, const void* feature,
                                   const void* threshold, const void* value,
                                   void* out, int B, int F, int T, int N,
                                   int K, int depth, void* stream) {
  if (K <= 0 || K > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(F + T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gbdt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gbdt_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const int32_t*>(feature),
      static_cast<const float*>(threshold), static_cast<const float*>(value),
      static_cast<float*>(out), F, T, N, K, depth);
  return (int)cudaGetLastError();
}
