// Flash prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_prefill_sdpa` in csm_mlx_tpu/ops/attention.py:
// grouped-query prefill attention in which query i of batch row b sees key j
// iff pad_len[b] <= j <= i, with an fp32 softmax and no (S, S) logits
// written to device memory.
//
// What bounds it on the H100: at the prompt lengths of the main path
// (S = 256..2048, D = 64) the K/V bytes are small (S*D*2 bytes per kv head)
// and the work is the causal pairs' products and exponentials: at (B=2,
// S=2048) bf16 4*H*D*pairs = 34 GFLOP, 35 us at 989 TFLOP/s, against 3 us
// of bytes. So the products belong on the tensor cores.
//
// bf16 route: the causal forward of kernel 6, `flash_fwd_tc_kernel<true>`
// of flash_common.cuh (mma.sync m16n8k16, ldmatrix, cp.async double
// buffers, ex2.approx), instantiated with the left-pad mask: a block skips
// the key tiles wholly below pad_len[b], masks keys below it on the tile
// that holds it, and writes zeros, a finite value, for the rows i < pad_len[b]
// that have no valid key (see the kernel's comment). P is rounded to bf16
// as the operand of P.V, as the plain version's masked sdpa does.
//
// fp32 route: the CUDA cores, since TF32 cannot meet the fp32 gate (1e-4):
// one block of 64 threads per (batch row, query head, 64-row query tile),
// one thread per query row holding its query and its output accumulator in
// registers. K and V stream through shared memory in 64-key tiles,
// converted to fp32 once per tile, and the online softmax runs over chunks
// of 16 keys. Key tiles entirely past the query tile's last row are causally
// masked for every row of the tile and are skipped.
//
// Masking uses the finite NEG_INF = -0.7 * FLT_MAX of the JAX package, not
// -inf. On the fp32 route a row i < pad_len[b] then averages the V rows it
// saw and stays finite (the JAX kernel averages all S rows; no output of
// such a row is ever attended to); a masked key that precedes the first
// valid key is weighted exp(NEG_INF - m) = 0 once m is real.
//
// q, k and v are read through the strides the wrapper passes (the innermost
// dimension must be contiguous, rows 16-byte aligned), so k[:, :, :S]
// slices of a KV cache and the transposed query projection are read in
// place without a copy.

#include "flash_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kBQ)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const long long* __restrict__ pad_len,
                     T* __restrict__ out, Strides qs, Strides ks, Strides vs,
                     int n_heads, int group, int seq, float scale) {
  __shared__ float k_tile[kBK][kD];
  __shared__ float v_tile[kBK][kD];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int i = qt * kBQ + threadIdx.x;  // this thread's query row
  const int pad = (int)pad_len[b];

  float qr[kD], acc[kD];
  const T* qp = q + b * qs.b + h * qs.h + (long long)i * qs.s;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = to_f32(qp[d]);
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const int last_row = qt * kBQ + kBQ - 1;
  for (int t0 = 0; t0 <= last_row; t0 += kBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * kD; e += kBQ) {
      const int j = e / kD, d = e % kD;
      k_tile[j][d] = to_f32(kb[(long long)(t0 + j) * ks.s + d]);
      v_tile[j][d] = to_f32(vb[(long long)(t0 + j) * vs.s + d]);
    }
    __syncthreads();
    for (int c0 = 0; c0 < kBK; c0 += kChunk) {
      float sc[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = t0 + c0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) dot = fmaf(qr[d], k_tile[c0 + jj][d], dot);
        const bool ok = (j <= i) && (j >= pad);
        sc[jj] = ok ? dot * scale : kNegInf;
        cmax = fmaxf(cmax, sc[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(sc[jj] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, v_tile[c0 + jj][d], acc[d]);
      }
      m = m_new;
    }
  }

  const float inv = 1.f / l;  // l >= 1: the row max contributes exp(0)
  T* op = out + (((long long)b * n_heads + h) * seq + i) * kD;
#pragma unroll
  for (int d = 0; d < kD; ++d) op[d] = from_f32<T>(acc[d] * inv);
}

}  // namespace

// q: (B, H, S, 64), k/v: (B, n_kv, S, 64) with the given element strides
// (innermost contiguous, rows 16-byte aligned); pad_len: (B,) int64; out:
// (B, H, S, 64) contiguous. S % 64 == 0 (checked by the wrapper). Returns
// cudaGetLastError().
extern "C" int csm_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* pad_len, void* out,
                                 long long qsb, long long qsh, long long qss,
                                 long long ksb, long long ksh, long long kss,
                                 long long vsb, long long vsh, long long vss,
                                 int batch, int n_heads, int n_kv, int seq,
                                 int head_dim, float scale, int dtype,
                                 void* stream) {
  if (head_dim != kD || seq % kBQ != 0 || n_kv <= 0 || n_heads % n_kv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  const int group = n_heads / n_kv;
  const long long* pl = static_cast<const long long*>(pad_len);
  if (dtype == kBF16) {
    if (misaligned(q, qs) || misaligned(k, ks) || misaligned(v, vs))
      return (int)cudaErrorMisalignedAddress;
    return launch_fwd_tc<true>(q, k, v, out, nullptr, pl, qs, ks, vs, batch,
                               n_heads, n_kv, seq, scale, st);
  }
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  const dim3 grid(seq / kBQ, n_heads, batch);
  flash_prefill_kernel<float><<<grid, kBQ, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pl, static_cast<float*>(out), qs, ks, vs,
      n_heads, group, seq, scale);
  return (int)cudaGetLastError();
}
