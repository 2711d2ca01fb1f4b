// K1: one-token GQA decode attention over the ring-buffer KV cache.
//
// Replaces the Pallas TPU kernel decode_attention_kernel / _decode_kernel
// (src/repro/kernels/decode_attention.py).  Same function: the G query heads
// of one KV head attend cache slots s <= t (every slot once the ring has
// wrapped, t >= S) with an online softmax kept in f32.  The fill level is
// one value shared by the batch (the serial engine) or one per lane (the
// decode lanes, whose sequences sit at different lengths).
//
// What bounds it on an H100: latency.  Each decoded token reads the live
// part of the cache once (2 * min(S, t+1) * KV * hd elements per layer)
// and does 4 FLOPs per element read, far below the ~295 FLOP/byte at
// which bf16 tensor-core work would be the limit.  At the serving shapes
// (B 1-4, KV 5, hd 64, S 128-512, bf16) that is at most 655 KB per lane
// and layer (gemma3-4b-edge, KV 4 and hd 256: 1.05 MB), a fraction of a
// microsecond at 3.35 TB/s, so the time of a call is its chain of
// dependent steps and the number of SMs it reaches.
//
// Design (the body is decode_tile.cuh, shared with K2; its note has the
// details):
//  * one launch per call over a grid of (n_split, KV, B) blocks, launched
//    with cudaLaunchKernelEx as clusters of n_split = split_plan(S) <= 8
//    blocks, one cluster per (lane, KV head); each block attends a
//    contiguous range of the lane's live slots, and the ranks merge the
//    blocks' partials through distributed shared memory, each rank its
//    share of the head_dim columns;
//  * warps own slots, 16-byte loads, scores by warp shuffles, an online
//    softmax per row group in registers: no barrier inside the slot loop;
//  * the cache is read in place in the engine's layout (B, S, KV, hd)
//    through its strides: no transposed copy of the cache per call;
//  * the fill level t is read from device memory (t[0] for all lanes, or
//    t[b] per lane), so the host never synchronises per decode step; the
//    blocks cover min(S, t[b]+1) slots only, instead of masking the buffer;
//  * q is read and the output written in model layout (B, 1, H, hd).

#include "decode_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// (head_dim) axis of q, the caches and o must be contiguous.  t_stride is
// 0 (one fill level for every lane) or 1 (t holds B levels).  n_split is
// the cluster size of kernels/decode_attention.py's split_plan(S); hd is
// a multiple of 8, at most 256, and every pointer and stride but the
// last axis's is a multiple of 16 bytes.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* t, void* o,
    int dtype, int B, int S, int KV, int G, int hd, int t_stride,
    long long q_sb, long long q_sh, long long c_sb, long long c_ss,
    long long c_sh, long long o_sb, long long o_sh, int n_split,
    void* stream) {
  if (t_stride != 0 && t_stride != 1) return (int)cudaErrorInvalidValue;
  DecodeArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.t = static_cast<const int32_t*>(t);
  a.bt = nullptr;
  a.o = o;
  a.S = S;
  a.G = G;
  a.hd = hd;
  a.t_stride = t_stride;
  a.page = 1;
  a.P = 0;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.c_sb = c_sb;
  a.c_sp = 0;
  a.c_ss = c_ss;
  a.c_sh = c_sh;
  a.bt_sb = 0;
  return dispatch_dtype<false>(dtype, a, B, KV, n_split,
                               static_cast<cudaStream_t>(stream));
}
