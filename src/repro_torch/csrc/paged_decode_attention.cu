// K2: one-token GQA decode attention through a block table into the
// block-paged KV pool.
//
// Replaces the Pallas TPU kernel paged_decode_attention_kernel /
// _paged_decode_kernel (src/repro/kernels/decode_attention.py).  Same
// function: lane b's logical slot s lives at in-page slot s % page of
// physical page bt[b, s / page]; the G query heads of one KV head attend
// logical slots s <= t[b] with an online softmax kept in f32.  Physical
// page 0 is the trash page: unallocated table entries point at it, and the
// fill-level bound keeps whatever it holds out of every live lane's sum.
//
// What bounds it on an H100: latency, as for K1 (the same 4 FLOPs per
// K/V element read).  At the serving shapes (4 lanes, KV 5, hd 64, page
// 16, 8-32 pages per lane, bf16) a call moves at most ~1.3 MB, well under
// a microsecond at 3.35 TB/s: the chain of dependent steps and the
// number of SMs reached set its time.
//
// Design (the body is decode_tile.cuh, shared with K1):
//  * the same cluster split as K1: split_plan(P * page) blocks per (lane,
//    KV head), contiguous slot ranges of the lane's logical window, one
//    launch, the ranks merging by column through distributed shared
//    memory.  On the
//    same logical window K2 runs K1's plan, slot order and arithmetic, so
//    its output is bitwise equal to K1's;
//  * the pool is read in place in the engine's layout
//    (n_pages, page, KV, hd) through its strides; the Pallas kernel wants
//    (n_pages, KV, page, hd), and the JAX engine instead gathers
//    pool[bt] into a dense window per step.  Nothing is gathered here;
//  * Hopper has no scalar prefetch: each block loads its lane's
//    block-table row into shared memory before its slot loop and maps
//    slot s to bt[b, s / page] * page_stride + (s % page) * slot_stride,
//    one division per 16-byte load;
//  * the blocks cover min(t[b] + 1, P * page) slots, so a lane whose t has
//    run past its window (a stopped lane stepping to its segment's end,
//    whose table points at the trash page) stays finite;
//  * any page size works: a block's range crosses page boundaries freely.

#include "decode_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: p_sp, p_ss,
// p_sh are the pool's page, in-page slot and KV-head strides; the head_dim
// axis of q, the pools and o must be contiguous.  bt is (B, P) int32 with
// row stride bt_sb; t is (B,) int32.  n_split is split_plan(P * page);
// hd and the alignment as for K1.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* bt,
    const void* t, void* o, int dtype, int B, int P, int page, int KV,
    int G, int hd, long long q_sb, long long q_sh, long long p_sp,
    long long p_ss, long long p_sh, long long bt_sb, long long o_sb,
    long long o_sh, int n_split, void* stream) {
  if (page < 1 || P < 1) return (int)cudaErrorInvalidValue;
  DecodeArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.t = static_cast<const int32_t*>(t);
  a.bt = static_cast<const int32_t*>(bt);
  a.o = o;
  a.S = P * page;
  a.G = G;
  a.hd = hd;
  a.t_stride = 1;
  a.page = page;
  a.P = P;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.c_sb = 0;
  a.c_sp = p_sp;
  a.c_ss = p_ss;
  a.c_sh = p_sh;
  a.bt_sb = bt_sb;
  return dispatch_dtype<true>(dtype, a, B, KV, n_split,
                              static_cast<cudaStream_t>(stream));
}
