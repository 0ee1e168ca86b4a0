// Shared pieces of the port's flash-attention kernels (kernels 2, 4, 6, 7):
// constants, strides, the cp.async / ldmatrix / mma.sync helpers of the
// bf16 tensor-core route, and that route's causal forward,
// `flash_fwd_tc_kernel`, which is kernel 6 (flash_train.cu) without the
// pad mask and kernel 2's bf16 route (flash_prefill.cu) with it.
//
// Fragment layout of m16n8k16 (lane = 4 * gr + tq): an A fragment holds
// rows gr and gr + 8, columns 2tq, 2tq + 1 and 2tq + 8, 2tq + 9 of a 16 x
// 16 tile; a C fragment c[0..3] holds (gr, 2tq), (gr, 2tq + 1),
// (gr + 8, 2tq), (gr + 8, 2tq + 1) of a 16 x 8 tile. A warp's 16 x 64
// product is 8 C fragments, acc[n] for columns 8n .. 8n + 7.
#pragma once

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kD = 64;       // head dim
constexpr int kBQ = 64;      // query rows per tile
constexpr int kBK = 64;      // keys per tile
constexpr int kChunk = 16;   // keys per online-softmax update (fp32 routes)
constexpr float kNegInf = -0.7f * FLT_MAX;

struct Strides {
  long long b, h, s;  // element strides of dims 0, 1, 2; dim 3 is contiguous
};

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;          // 4 warps x 16 rows of a 64-row tile
constexpr int kLd = kD + 8;            // shared row stride: 144 bytes
constexpr int kTile = kBQ * kLd;       // elements of one shared tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero where !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every copy this thread committed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Waits for all but the n most recent groups of copies this thread committed.
template <int n>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Rows r0 .. r0 + 63 of one (batch, head) plane (row stride rs elements)
// into a shared tile, by the block's 128 threads; rows past seq are zeros.
__device__ __forceinline__ void tile_async(bf16* sm, const bf16* g, long long rs,
                                           int r0, int seq) {
#pragma unroll
  for (int i = 0; i < kBQ * kD / 8 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e >> 3, c = (e & 7) * 8;
    const bool ok = r0 + r < seq;
    cp_async16(sm + r * kLd + c, g + (long long)(ok ? r0 + r : 0) * rs + c, ok);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: a 16 x 16, b 16 x 8, bf16; c fp32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction; results below FLT_MIN flush to 0, which a
// probability against a row sum >= 1 can afford.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// A fragments of rows row0 .. row0 + 15 of a shared tile, over its 64
// columns (4 k-steps of 16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile,
                                       int row0, int lane) {
  const bf16* p = tile + (row0 + (lane & 15)) * kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm4(a[kk], p + kk * 16);
}

// c = a * tile^T: a is 16 x 64 (A fragments), tile 64 x 64 in shared
// memory; c[n] holds the products with tile rows 8n .. 8n + 7, computed for
// n_lo <= n < n_hi (warp-uniform; the rest stay 0).
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* tile, int lane, int n_lo = 0,
                                        int n_hi = 8) {
  zero(c);
  const bf16* p = tile + (lane & 7) * kLd + (lane >> 3) * 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n < n_lo || n >= n_hi) continue;
#pragma unroll
    for (int kk = 0; kk < 4; kk += 2) {
      uint32_t b[4];
      ldsm4(b, p + n * 8 * kLd + kk * 16);
      mma(c[n], a[kk], b[0], b[1]);
      mma(c[n], a[kk + 1], b[2], b[3]);
    }
  }
}

// c += a * tile: a is 16 x 64 (A fragments over the tile's 64 rows), tile
// 64 x 64 in shared memory; c[n] holds columns 8n .. 8n + 7. Only the
// k-steps kk_lo <= kk < kk_hi (tile rows 16kk .. 16kk + 15; warp-uniform)
// are summed: on a diagonal tile the others multiply zeros.
__device__ __forceinline__ void mma_ab(float (&c)[8][4], const uint32_t (&a)[4][4],
                                       const bf16* tile, int lane, int kk_lo = 0,
                                       int kk_hi = 4) {
  const bf16* p = tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < kk_lo || kk >= kk_hi) continue;
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      ldsm4_trans(b, p + kk * 16 * kLd + n * 8);
      mma(c[n], a[kk], b[0], b[1]);
      mma(c[n + 1], a[kk], b[2], b[3]);
    }
  }
}

// The C fragments of a 16 x 64 product as bf16 A fragments over its 64
// columns: the first product's output is the second's operand.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Writes a warp's 16 x 64 C fragments, row gr scaled by f0 and row gr + 8
// by f1, as bf16 rows r0 .. r0 + 15 of the contiguous (rows, 64) plane at
// `out` (rows >= seq skipped). `stage` is the warp's own 16 rows of a
// shared tile, which it no longer reads; 16-byte stores.
__device__ __forceinline__ void store_rows(bf16* out, int r0, int seq, bf16* stage,
                                           const float (&c)[8][4], float f0,
                                           float f1, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(stage + gr * kLd + n * 8 + 2 * tq) =
        __floats2bfloat162_rn(c[n][0] * f0, c[n][1] * f0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (gr + 8) * kLd + n * 8 + 2 * tq) =
        __floats2bfloat162_rn(c[n][2] * f1, c[n][3] * f1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = lane + 32 * i;
    const int r = e >> 3, col = (e & 7) * 8;
    if (r0 + r < seq)
      *reinterpret_cast<uint4*>(out + (long long)(r0 + r) * kD + col) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + col);
  }
}

// Causal flash attention forward on the tensor cores: one block per (head,
// batch, q tile); the key tiles up to the diagonal stream through.
//
// kPad = false is kernel 6: every key j <= i, and the fp32 natural-log
// logsumexp goes to `lse`. kPad = true is kernel 2's bf16 route: key j is
// valid iff pad_len[b] <= j <= i, and there is no lse (`lse` is unused).
// With the pad, a block starts at the key tile holding pad_len[b] (the
// tiles wholly below it hold no valid key for any of its rows), masks the
// keys below the pad on that tile as on the diagonal, and a q tile wholly
// below the pad visits no tile at all. A row i < pad_len[b] has no valid
// key: the kernel writes zeros for it, a finite value that no valid row
// ever attends to (the next layer weighs its K/V by exp(NEG_INF - m) = 0).
// Its softmax is never normalised: with every logit NEG_INF its shifted
// exponent is the rounding error of NEG_INF * scale, which may be huge.
template <bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, const long long* __restrict__ pad_len,
                    Strides qs, Strides ks, Strides vs, int n_heads, int group,
                    int seq, float scale) {
  __shared__ __align__(16) bf16 sq[kTile];
  __shared__ __align__(16) bf16 sk[2][kTile];
  __shared__ __align__(16) bf16 sv[2][kTile];

  // grid = (H, B, tiles): the slowest dimension runs the longest tiles first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * kBQ;
  const bf16* kb = k + b * ks.b + (h / group) * ks.h;
  const bf16* vb = v + b * vs.b + (h / group) * vs.h;
  const long long plane = ((long long)b * n_heads + h) * seq;
  int pad = 0, t_lo = 0;  // the first key tile with a valid key
  if constexpr (kPad) {
    pad = (int)pad_len[b];
    if (q0 + kBQ <= pad) {  // no row of this tile has a valid key
      const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < kBQ * kD / 8 / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int r = q0 + (e >> 3);
        if (r < seq)
          *reinterpret_cast<uint4*>(out + (plane + r) * kD + (e & 7) * 8) = z;
      }
      return;
    }
    t_lo = pad / kBK;
  }

  tile_async(sq, q + b * qs.b + h * qs.h, qs.s, q0, seq);
  tile_async(sk[t_lo & 1], kb, ks.s, t_lo * kBK, seq);
  tile_async(sv[t_lo & 1], vb, vs.s, t_lo * kBK, seq);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  const int row = q0 + warp * 16 + (lane >> 2);  // c[.][0..1]; +8 for [2..3]
  const int col = 2 * (lane & 3);
  uint32_t qf[4][4];
  float acc[8][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = t_lo; t <= qt; ++t) {  // key tiles up to the diagonal
    // Tile t has landed and every warp is past tile t - 1, whose buffer
    // then takes tile t + 1 while tile t computes: one barrier a tile.
    cp_async_wait_all();
    __syncthreads();
    if (t < qt) {
      tile_async(sk[(t + 1) & 1], kb, ks.s, (t + 1) * kBK, seq);
      tile_async(sv[(t + 1) & 1], vb, vs.s, (t + 1) * kBK, seq);
      cp_async_commit();
    }
    if (t == t_lo) load_a(qf, sq, warp * 16, lane);

    // on the diagonal tile, warp w's rows see keys 0 .. 16w + 15 only
    const bool diag = t == qt;
    float s[8][4];
    mma_abt(s, qf, sk[t & 1], lane, 0, diag ? 2 * warp + 2 : 8);
    // masked: the diagonal tile (and the S tail), key > row; with the pad
    // also the tile that holds it, key < pad
    if (diag || (kPad && t * kBK < pad)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t * kBK + n * 8 + col + (e & 1);
          if (key > row + (e >> 1) * 8 || (kPad && key < pad)) s[n][e] = kNegInf;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = ex2((m[r] - m_new) * sl2);
      const float shift = -m_new * sl2;
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
        s[n][2 * r] = ex2(fmaf(s[n][2 * r], sl2, shift));
        s[n][2 * r + 1] = ex2(fmaf(s[n][2 * r + 1], sl2, shift));
        l[r] += s[n][2 * r] + s[n][2 * r + 1];
      }
    }
    uint32_t pf[4][4];
    c_to_a(pf, s);
    mma_ab(acc, pf, sv[t & 1], lane, 0, diag ? warp + 1 : 4);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // l >= 1: the row max contributes exp2(0)
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float f[2] = {1.f / l[0], 1.f / l[1]};
  if constexpr (kPad) {  // rows below the pad: zeros (see above)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row + 8 * r >= pad) continue;
      f[r] = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][2 * r] = acc[n][2 * r + 1] = 0.f;
    }
  }
  store_rows(out + plane * kD, q0 + warp * 16, seq, sq + warp * 16 * kLd, acc,
             f[0], f[1], lane);
  if constexpr (!kPad) {
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row + 8 * r < seq) lse[plane + row + 8 * r] = m[r] * scale + logf(l[r]);
    }
  }
}

// The bf16 route's 16-byte copies need 16-byte aligned rows.
inline bool misaligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 || s.b % 8 || s.h % 8 || s.s % 8;
}

// Launches flash_fwd_tc_kernel<kPad> over (B, H, S).
template <bool kPad>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* out,
                  void* lse, const long long* pad_len, Strides qs, Strides ks,
                  Strides vs, int batch, int n_heads, int n_kv, int seq,
                  float scale, cudaStream_t st) {
  const dim3 grid(n_heads, batch, (seq + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<kPad><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), pad_len, qs, ks, vs, n_heads, n_heads / n_kv,
      seq, scale);
  return (int)cudaGetLastError();
}

}  // namespace
