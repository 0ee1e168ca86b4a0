// The int8 tensor-core tile shared by kernels 1 and 3: mma.sync m16n8k32
// with s8 x s8 -> s32 operands read from shared memory, the asynchronous
// copies that fill it (cp.async of 16 bytes a thread, and the bulk copies of
// whole rows that complete on an mbarrier), and the L2 evict-first hint.
//
// Fragments (PTX ISA, mma.m16n8k32 .s8): A is 16 x 32 bytes, row-major in
// shared memory at `stride` bytes a row; ldmatrix.x4 loads it as four 8 x 16
// byte matrices (rows 0-7 / 8-15, bytes 0-15 / 16-31), which is exactly the
// a0..a3 register layout. B is 32 x 8 "col": b0 holds bytes tg*4..+3 and b1
// bytes 16+tg*4..+3 of column g (g = lane / 4, tg = lane % 4), i.e. 4
// consecutive bytes of row g of an [n][k] tile. C holds c0, c1 at (g,
// 2tg), (g, 2tg+1) and c2, c3 at (g+8, ...). A row stride of 16 mod 128
// bytes keeps every 8-row access on distinct banks. Integer sums are exact,
// so the tile gives the same int32 products as __dp4a in any order.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The A fragment of the 16 x 32 byte tile at `tile` (rows at `stride`).
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const int8_t* tile,
                                            int stride, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  const int8_t* p = tile + ((mi & 1) * 8 + r) * stride + (mi >> 1) * 16;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// The B fragments of two n8 tiles: rows 0-7 and 8-15 of the [n][k] tile at
// `tile`, bytes 0..31: b[0], b[1] of the first, b[2], b[3] of the second.
__device__ __forceinline__ void load_b_frag2(uint32_t (&b)[4], const int8_t* tile,
                                             int stride, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  const int8_t* p = tile + ((mi >> 1) * 8 + r) * stride + (mi & 1) * 16;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores (exact int32).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- mbarriers and bulk copies (sm_90) ---------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive once, expecting `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Wait until the phase of parity `parity` has completed. A copy that never
// lands traps after a second instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 1000000000ull) __trap();
}

// The L2 policy of the bulk copies: stream (evict_first).
__device__ __forceinline__ uint64_t l2_policy_stream() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}
