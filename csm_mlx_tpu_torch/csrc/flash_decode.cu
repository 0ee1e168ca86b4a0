// Flash decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_decode_sdpa` in csm_mlx_tpu/ops/attention.py:
// attention of ONE query position (a backbone decode step) over a whole KV
// cache with grouped-query heads, where key j of batch row b is valid iff
// pad_len[b] <= j <= index (`index` is the slot this step just wrote), with
// an fp32 softmax and no logits written to device memory.
//
// What bounds it on the H100: the K/V bytes. Each key is used by the G
// query heads of its group only, so the kernel does ~4*G flops per K/V
// element read, far below what would make it compute-bound. One block of
// kWarps warps serves one (batch row, kv head) and its G query heads; the
// warps take 32-key tiles in turn. In a tile each lane owns one key: it
// reads the key's row (16-byte loads) and dots it with the G queries (kept
// in shared memory), and the warp runs an online-softmax update per head.
// For P.V each lane owns 2 of the 64 dims and walks the tile's keys, their
// probabilities broadcast by shuffles, so every V row is read coalesced.
// Logits, probabilities and the per-warp partial sums stay in registers and
// shared memory; at the end the warps' (max, sum, acc) merge in shared
// memory. Only the keys in [pad, index] are read: tiles outside cannot
// change the result (see below). At B=8 and 8 kv heads that is 64 blocks
// on 132 SMs; splitting the cache across blocks (flash-decoding) is later
// work.
//
// Masking follows the JAX package: an in-range key that fails the mask gets
// the finite NEG_INF = -0.7 * FLT_MAX, not -inf, so a row with no valid key
// at all (pad > index, never seen in generation) averages all `cap` V rows,
// as the masked softmax does; the kernel then walks the whole cache. A key
// past the walked range contributes nothing (-inf, p = 0).
//
// q, k and v are read through the strides the wrapper passes (the innermost
// dimension must be contiguous, rows 16-byte aligned), so the cache's layer
// buffers and the transposed query projection are read in place.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kD = 64;      // head dim
constexpr int kWarps = 4;   // warps per block
constexpr int kTile = 32;   // keys per warp tile (one per lane)
constexpr float kNegInf = -0.7f * FLT_MAX;

struct Strides {
  long long b, h, s;  // element strides of dims 0, 1, 2; dim 3 is contiguous
};

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int G>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pad_len,
                    T* __restrict__ out, long long qsb, long long qsh,
                    Strides ks, Strides vs, int n_heads, int cap, int index,
                    float scale) {
  __shared__ float q_s[G][kD];
  __shared__ float m_s[kWarps][G], l_s[kWarps][G];
  __shared__ float acc_s[kWarps][G][kD];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < G * kD; e += kWarps * 32) {
    const int h = e / kD, d = e % kD;
    q_s[h][d] = to_f32(q[b * qsb + (long long)(kvh * G + h) * qsh + d]);
  }
  __syncthreads();

  const int pad = pad_len[b];
  int lo = pad, hi = index;
  if (lo > hi) {  // no valid key: every logit is NEG_INF, a uniform average
    lo = 0;
    hi = cap - 1;
  }
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  float m[G], l[G], acc[G][2];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
    acc[h][0] = acc[h][1] = 0.f;
  }

  for (int t0 = lo + warp * kTile; t0 <= hi; t0 += kWarps * kTile) {
    const int j = t0 + lane;
    float p[G];
    if (j <= hi) {
      float dot[G];
#pragma unroll
      for (int h = 0; h < G; ++h) dot[h] = 0.f;
      const T* kr = kb + (long long)j * ks.s;
#pragma unroll
      for (int c = 0; c < kD; c += 8) {
        float kf[8];
        load8(kr + c, kf);
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int e = 0; e < 8; ++e) dot[h] = fmaf(q_s[h][c + e], kf[e], dot[h]);
      }
      const bool ok = j >= pad && j <= index;
#pragma unroll
      for (int h = 0; h < G; ++h) p[h] = ok ? dot[h] * scale : kNegInf;
    } else {
#pragma unroll
      for (int h = 0; h < G; ++h) p[h] = -INFINITY;
    }
    // online softmax over the tile; lane 0's key is in range, so the tile
    // max is finite
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mt = p[h];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[h], mt);
      const float alpha = expf(m[h] - m_new);
      p[h] = expf(p[h] - m_new);
      float ps = p[h];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[h] = l[h] * alpha + ps;
      acc[h][0] *= alpha;
      acc[h][1] *= alpha;
      m[h] = m_new;
    }
    const int n = min(kTile, hi - t0 + 1);
    for (int jj = 0; jj < n; ++jj) {
      const float2 vv = load2(vb + (long long)(t0 + jj) * vs.s + 2 * lane);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float pj = __shfl_sync(0xffffffffu, p[h], jj);
        acc[h][0] = fmaf(pj, vv.x, acc[h][0]);
        acc[h][1] = fmaf(pj, vv.y, acc[h][1]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (lane == 0) {
      m_s[warp][h] = m[h];
      l_s[warp][h] = l[h];
    }
    acc_s[warp][h][2 * lane] = acc[h][0];
    acc_s[warp][h][2 * lane + 1] = acc[h][1];
  }
  __syncthreads();

  // merge the warps' partials; a warp that saw no key has m = -inf, weight 0
  for (int e = threadIdx.x; e < G * kD; e += kWarps * 32) {
    const int h = e / kD, d = e % kD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][h]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w][h] - mx);
      sum = fmaf(l_s[w][h], f, sum);
      o = fmaf(acc_s[w][h][d], f, o);
    }
    out[((long long)b * n_heads + kvh * G + h) * kD + d] = from_f32<T>(o / sum);
  }
}

template <typename T, int G>
void launch(const void* q, const void* k, const void* v, const int* pad,
            void* out, long long qsb, long long qsh, Strides ks, Strides vs,
            int batch, int n_heads, int n_kv, int cap, int index, float scale,
            cudaStream_t stream) {
  dim3 grid(n_kv, batch);
  flash_decode_kernel<T, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pad, static_cast<T*>(out), qsb, qsh, ks, vs,
      n_heads, cap, index, scale);
}

template <typename T>
int run(const void* q, const void* k, const void* v, const int* pad,
        void* out, long long qsb, long long qsh, Strides ks, Strides vs,
        int batch, int n_heads, int n_kv, int cap, int index, float scale,
        cudaStream_t st) {
  switch (n_heads / n_kv) {
    case 1: launch<T, 1>(q, k, v, pad, out, qsb, qsh, ks, vs, batch, n_heads, n_kv, cap, index, scale, st); break;
    case 2: launch<T, 2>(q, k, v, pad, out, qsb, qsh, ks, vs, batch, n_heads, n_kv, cap, index, scale, st); break;
    case 4: launch<T, 4>(q, k, v, pad, out, qsb, qsh, ks, vs, batch, n_heads, n_kv, cap, index, scale, st); break;
    case 8: launch<T, 8>(q, k, v, pad, out, qsb, qsh, ks, vs, batch, n_heads, n_kv, cap, index, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// q: (B, H, 1, 64) with element strides qsb, qsh; k/v: (B, n_kv, cap, 64)
// with the given element strides (innermost contiguous, rows 16-byte
// aligned); pad_len: (B,) int32; out: (B, H, 1, 64) contiguous. H / n_kv in
// {1, 2, 4, 8}, 0 <= index < cap (checked by the wrapper). Returns
// cudaGetLastError().
extern "C" int csm_flash_decode(const void* q, const void* k, const void* v,
                                const void* pad_len, void* out,
                                long long qsb, long long qsh,
                                long long ksb, long long ksh, long long kss,
                                long long vsb, long long vsh, long long vss,
                                int batch, int n_heads, int n_kv, int cap,
                                int index, int head_dim, float scale,
                                int dtype, void* stream) {
  if (head_dim != kD || n_kv <= 0 || n_heads % n_kv != 0 || index < 0 ||
      index >= cap)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  const int* pl = static_cast<const int*>(pad_len);
  int code;
  if (dtype == kF32)
    code = run<float>(q, k, v, pl, out, qsb, qsh, ks, vs, batch, n_heads,
                      n_kv, cap, index, scale, st);
  else if (dtype == kBF16)
    code = run<__nv_bfloat16>(q, k, v, pl, out, qsb, qsh, ks, vs, batch,
                              n_heads, n_kv, cap, index, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  if (code != 0) return code;
  return (int)cudaGetLastError();
}
