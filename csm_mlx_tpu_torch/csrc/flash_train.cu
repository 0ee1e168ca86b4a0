// Causal grouped-query flash attention for training, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels `_fwd_impl` and `_bwd_impl` of
// csm_mlx_tpu/ops/flash_train.py: query i attends key j iff j <= i, with an
// fp32 softmax, and no (S, S) logits or probabilities written to device
// memory in either pass. GQA is implicit: query heads g*group .. g*group +
// group - 1 share kv head g.
//
// The TPU kernels walk a sequential grid and carry dk/dv in VMEM from one
// q block to the next; here blocks run in parallel and in no order, so the
// design is FlashAttention-2's:
// - forward: one block per (batch, head, 64-row q tile), one thread per
//   query row, online softmax over 64-key tiles staged in shared memory;
//   tiles above the diagonal are skipped, the diagonal tile and the S tail
//   are masked. It writes O and the fp32 logsumexp (B, H, S). (The JAX
//   kernel saves no logsumexp and recomputes it; the outputs are the same.)
// - backward, three launches and no float atomics (deterministic):
//   delta = rowsum(dO * O); a dk/dv kernel with one block per (batch, kv
//   head, 64-key tile) that loops over the `group` query heads and the q
//   tiles on or below the diagonal, accumulating dk/dv in fp32 registers;
//   a dq kernel with one block per (batch, head, 64-row q tile) that loops
//   over the key tiles up to the diagonal. Both recompute the probabilities
//   as exp(s - lse). In the backward kernels two threads share a row: each
//   holds the interleaved half of D (dims 2t + half) and a shuffle joins
//   their partial dot products, which keeps 128 fp32 values per thread.
//
// What bounds it on the H100: the work is 2*S*S*D multiply-adds per head
// forward (causal half) and 2.5x that backward, against a few MB of
// inputs: operations. This first version computes in fp32 on the CUDA
// cores (67 TFLOP/s peak), not on the tensor cores; wgmma and TMA are for a
// later version.
//
// Masking uses the finite NEG_INF = -0.7 * FLT_MAX of the JAX package,
// never -inf. Every real row sees key 0, so no row is fully masked.
//
// q, k, v and dO are read through the strides the wrapper passes (the
// innermost dimension contiguous): they arrive as transposed views of the
// projections and are not copied. O, lse, delta, dq, dk and dv are
// contiguous. head_dim must be 64 (checked; the wrapper raises first).

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kD = 64;       // head dim
constexpr int kHalf = kD / 2;
constexpr int kBQ = 64;      // query rows per tile
constexpr int kBK = 64;      // keys per tile
constexpr int kChunk = 16;   // keys per online-softmax update (forward)
constexpr float kNegInf = -0.7f * FLT_MAX;

struct Strides {
  long long b, h, s;  // element strides of dims 0, 1, 2; dim 3 is contiguous
};

template <typename T>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                 int n_heads, int group, int seq, float scale) {
  __shared__ float k_tile[kBK][kD];
  __shared__ float v_tile[kBK][kD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int i = qt * kBQ + threadIdx.x;  // this thread's query row
  const bool row_ok = i < seq;

  float qr[kD], acc[kD];
  const T* qp = q + b * qs.b + h * qs.h + (long long)(row_ok ? i : 0) * qs.s;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = row_ok ? to_f32(qp[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const int last_row = min(qt * kBQ + kBQ - 1, seq - 1);
  for (int t0 = 0; t0 <= last_row; t0 += kBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * kD; e += kBQ) {
      const int j = e / kD, d = e % kD;
      const bool ok = t0 + j < seq;
      k_tile[j][d] = ok ? to_f32(kb[(long long)(t0 + j) * ks.s + d]) : 0.f;
      v_tile[j][d] = ok ? to_f32(vb[(long long)(t0 + j) * vs.s + d]) : 0.f;
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
        sc[jj] = (j <= i) ? dot * scale : kNegInf;
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

  if (!row_ok) return;
  const float inv = 1.f / l;  // l >= 1: the row max contributes exp(0)
  const long long row = ((long long)b * n_heads + h) * seq + i;
  T* op = out + row * kD;
#pragma unroll
  for (int d = 0; d < kD; ++d) op[d] = from_f32<T>(acc[d] * inv);
  lse[row] = m + logf(l);
}

// delta[b, h, i] = sum_d dO[b, h, i, d] * O[b, h, i, d], in fp32.
template <typename T>
__global__ void flash_delta_kernel(const T* __restrict__ o,
                                   const T* __restrict__ dout,
                                   float* __restrict__ delta, Strides dos,
                                   int n_heads, int seq, long long rows) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int i = (int)(r % seq);
  const long long bh = r / seq;
  const int h = (int)(bh % n_heads), b = (int)(bh / n_heads);
  const T* op = o + r * kD;
  const T* dp = dout + b * dos.b + h * dos.h + (long long)i * dos.s;
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) s = fmaf(to_f32(dp[d]), to_f32(op[d]), s);
  delta[r] = s;
}

// Loads rows r0 .. r0 + 63 of one (batch, head) plane into a shared fp32
// tile (rows past seq as zeros), with `nthreads` threads.
template <typename T>
__device__ __forceinline__ void load_tile(float (*tile)[kD], const T* base,
                                          long long row_stride, int r0,
                                          int seq, int nthreads) {
  for (int e = threadIdx.x; e < kBQ * kD; e += nthreads) {
    const int r = e / kD, d = e % kD;
    tile[r][d] = (r0 + r < seq) ? to_f32(base[(long long)(r0 + r) * row_stride + d])
                                : 0.f;
  }
}

// dk/dv: one block per (key tile, kv head, batch), two threads per key.
template <typename T>
__global__ void __launch_bounds__(2 * kBK)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                      Strides dos, int n_heads, int n_kv, int group, int seq,
                      float scale) {
  __shared__ float q_tile[kBQ][kD];
  __shared__ float do_tile[kBQ][kD];
  __shared__ float lse_t[kBQ];
  __shared__ float delta_t[kBQ];

  const int kt = blockIdx.x;  // key tile 0 has the most q tiles: first
  const int g = blockIdx.y, b = blockIdx.z;
  const int jl = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int j = kt * kBK + jl;
  const bool key_ok = j < seq;
  const int n_q_tiles = (seq + kBQ - 1) / kBQ;

  float kr[kHalf], vr[kHalf], dk_acc[kHalf], dv_acc[kHalf];
  const T* kp = k + b * ks.b + g * ks.h + (long long)(key_ok ? j : 0) * ks.s;
  const T* vp = v + b * vs.b + g * vs.h + (long long)(key_ok ? j : 0) * vs.s;
#pragma unroll
  for (int t = 0; t < kHalf; ++t) {
    kr[t] = key_ok ? to_f32(kp[2 * t + half]) : 0.f;
    vr[t] = key_ok ? to_f32(vp[2 * t + half]) : 0.f;
    dk_acc[t] = 0.f;
    dv_acc[t] = 0.f;
  }

  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const long long lrow = ((long long)b * n_heads + h) * seq;
    for (int qt = kt; qt < n_q_tiles; ++qt) {
      const int r0 = qt * kBQ;
      __syncthreads();
      load_tile(q_tile, qb, qs.s, r0, seq, 2 * kBK);
      load_tile(do_tile, dob, dos.s, r0, seq, 2 * kBK);
      const int r = threadIdx.x;
      if (r < kBQ) {
        const bool ok = r0 + r < seq;
        lse_t[r] = ok ? lse[lrow + r0 + r] : 0.f;
        delta_t[r] = ok ? delta[lrow + r0 + r] : 0.f;
      }
      __syncthreads();
      const int n_rows = min(kBQ, seq - r0);  // the same for every thread
      for (int il = 0; il < n_rows; ++il) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int t = 0; t < kHalf; ++t) {
          s = fmaf(q_tile[il][2 * t + half], kr[t], s);
          dp = fmaf(do_tile[il][2 * t + half], vr[t], dp);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        const bool ok = r0 + il >= j;  // causal: query row i >= key j
        const float p = ok ? expf(s * scale - lse_t[il]) : 0.f;
        const float ds = p * (dp - delta_t[il]) * scale;
#pragma unroll
        for (int t = 0; t < kHalf; ++t) {
          dv_acc[t] = fmaf(p, do_tile[il][2 * t + half], dv_acc[t]);
          dk_acc[t] = fmaf(ds, q_tile[il][2 * t + half], dk_acc[t]);
        }
      }
    }
  }

  if (!key_ok) return;
  const long long row = ((long long)b * n_kv + g) * seq + j;
#pragma unroll
  for (int t = 0; t < kHalf; ++t) {
    dk[row * kD + 2 * t + half] = from_f32<T>(dk_acc[t]);
    dv[row * kD + 2 * t + half] = from_f32<T>(dv_acc[t]);
  }
}

// dq: one block per (q tile, head, batch), two threads per query row.
template <typename T>
__global__ void __launch_bounds__(2 * kBQ)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    int n_heads, int group, int seq, float scale) {
  __shared__ float k_tile[kBK][kD];
  __shared__ float v_tile[kBK][kD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int il = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int i = qt * kBQ + il;
  const bool row_ok = i < seq;
  const long long row = ((long long)b * n_heads + h) * seq + (row_ok ? i : 0);

  float qr[kHalf], dor[kHalf], acc[kHalf];
  const T* qp = q + b * qs.b + h * qs.h + (long long)(row_ok ? i : 0) * qs.s;
  const T* dop = dout + b * dos.b + h * dos.h + (long long)(row_ok ? i : 0) * dos.s;
#pragma unroll
  for (int t = 0; t < kHalf; ++t) {
    qr[t] = row_ok ? to_f32(qp[2 * t + half]) : 0.f;
    dor[t] = row_ok ? to_f32(dop[2 * t + half]) : 0.f;
    acc[t] = 0.f;
  }
  const float lse_i = row_ok ? lse[row] : 0.f;
  const float delta_i = row_ok ? delta[row] : 0.f;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const int last_row = min(qt * kBQ + kBQ - 1, seq - 1);
  for (int t0 = 0; t0 <= last_row; t0 += kBK) {
    __syncthreads();
    load_tile(k_tile, kb, ks.s, t0, seq, 2 * kBQ);
    load_tile(v_tile, vb, vs.s, t0, seq, 2 * kBQ);
    __syncthreads();
    const int n_keys = min(kBK, seq - t0);  // the same for every thread
    for (int jj = 0; jj < n_keys; ++jj) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < kHalf; ++t) {
        s = fmaf(qr[t], k_tile[jj][2 * t + half], s);
        dp = fmaf(dor[t], v_tile[jj][2 * t + half], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const bool ok = t0 + jj <= i;
      const float p = ok ? expf(s * scale - lse_i) : 0.f;
      const float ds = p * (dp - delta_i) * scale;
#pragma unroll
      for (int t = 0; t < kHalf; ++t)
        acc[t] = fmaf(ds, k_tile[jj][2 * t + half], acc[t]);
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int t = 0; t < kHalf; ++t) dq[row * kD + 2 * t + half] = from_f32<T>(acc[t]);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, Strides qs, Strides ks, Strides vs, int batch,
               int n_heads, int n_kv, int seq, float scale, cudaStream_t st) {
  const dim3 grid((seq + kBQ - 1) / kBQ, n_heads, batch);
  flash_fwd_kernel<T><<<grid, kBQ, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      qs, ks, vs, n_heads, n_heads / n_kv, seq, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* delta, void* dq,
               void* dk, void* dv, Strides qs, Strides ks, Strides vs,
               Strides dos, int batch, int n_heads, int n_kv, int seq,
               float scale, cudaStream_t st) {
  const int group = n_heads / n_kv;
  const long long rows = (long long)batch * n_heads * seq;
  flash_delta_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), dos, n_heads, seq, rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 kgrid((seq + kBK - 1) / kBK, n_kv, batch);
  flash_bwd_dkdv_kernel<T><<<kgrid, 2 * kBK, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), qs, ks, vs, dos, n_heads,
      n_kv, group, seq, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 qgrid((seq + kBQ - 1) / kBQ, n_heads, batch);
  flash_bwd_dq_kernel<T><<<qgrid, 2 * kBQ, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), qs, ks, vs, dos, n_heads, group, seq, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int head_dim, int seq, int n_heads, int n_kv) {
  return head_dim != kD || seq < 1 || n_kv < 1 || n_heads % n_kv != 0;
}

}  // namespace

// q: (B, H, S, 64), k/v: (B, n_kv, S, 64) with the given element strides
// (innermost contiguous); out: (B, H, S, 64) and lse: (B, H, S) fp32, both
// contiguous. Returns cudaGetLastError().
extern "C" int csm_flash_train_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, long long qsb,
                                   long long qsh, long long qss, long long ksb,
                                   long long ksh, long long kss, long long vsb,
                                   long long vsh, long long vss, int batch,
                                   int n_heads, int n_kv, int seq,
                                   int head_dim, float scale, int dtype,
                                   void* stream) {
  if (bad_shape(head_dim, seq, n_heads, n_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  if (dtype == kF32)
    return launch_fwd<float>(q, k, v, out, lse, qs, ks, vs, batch, n_heads,
                             n_kv, seq, scale, st);
  if (dtype == kBF16)
    return launch_fwd<__nv_bfloat16>(q, k, v, out, lse, qs, ks, vs, batch,
                                     n_heads, n_kv, seq, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of csm_flash_train_fwd: q/k/v/dout strided as above; o and
// lse as the forward wrote them; delta: (B, H, S) fp32 scratch; dq
// (B, H, S, 64), dk/dv (B, n_kv, S, 64), contiguous, in the input type.
// Three launches on `stream`. Returns cudaGetLastError().
extern "C" int csm_flash_train_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long dsb, long long dsh, long long dss, int batch, int n_heads,
    int n_kv, int seq, int head_dim, float scale, int dtype, void* stream) {
  if (bad_shape(head_dim, seq, n_heads, n_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      dos{dsb, dsh, dss};
  if (dtype == kF32)
    return launch_bwd<float>(q, k, v, o, lse, dout, delta, dq, dk, dv, qs, ks,
                             vs, dos, batch, n_heads, n_kv, seq, scale, st);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(q, k, v, o, lse, dout, delta, dq, dk, dv,
                                     qs, ks, vs, dos, batch, n_heads, n_kv,
                                     seq, scale, st);
  return (int)cudaErrorInvalidValue;
}
