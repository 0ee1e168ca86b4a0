// Causal grouped-query flash attention for training, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels `_fwd_impl` (csm_mlx_tpu/ops/flash_train.py:88)
// and `_bwd_impl` (:126): query i attends key j iff j <= i, with an fp32
// softmax, and no (S, S) logits or probabilities written to device memory
// in either pass. GQA is implicit: query heads g*group .. g*group + group
// - 1 share kv head g. The forward writes O and the fp32 natural-log
// logsumexp (B, H, S); the backward recomputes the probabilities from it.
// (The JAX kernel saves no logsumexp and recomputes it; the outputs are
// the same.)
//
// What bounds it on the H100. At the training shape (B=2, S=575, H=32,
// n_kv=8, D=64, bf16) the forward moves 11.9 MB (3.56 us at 3.35 TB/s)
// for 2.7 GFLOP of causal products (2.74 us at 989 TFLOP/s), the backward
// 23.6 MB (7.07 us) for 6.8 GFLOP (6.85 us): both sit on the ridge. At
// (B=1, S=2048) the forward's 17.2 GFLOP take 17.4 us and the backward's
// 42.9 GFLOP 43.4 us: operations. So the products belong on the tensor
// cores, and every tile load has to overlap them.
//
// The design: FlashAttention-2's register layout on `mma.sync` (m16n8k16,
// bf16 operands, fp32 accumulators). A block is 4 warps; a warp owns 16
// rows of its 64-row tile and keeps its operand of the first product in
// registers. (Warps of 32 rows, which share each B fragment between two
// products, measured slower: fewer warps an SM to hide latency.) The other
// operand, 64-row bf16 tiles in shared memory (rows padded to 144 bytes,
// so `ldmatrix` is free of bank conflicts), is double-buffered by 16-byte
// `cp.async` copies: tile t+1 loads while tile t computes, one barrier a
// tile. The C fragments of a first product are the A fragments of the
// second (rounded to bf16 in registers), so P and dS never leave the
// registers. Softmax sums, row maxima and every accumulator stay fp32; the
// exponentials are one ex2.approx each, with scale * log2(e) folded in.
// Masking happens only on the diagonal tile and on the S tail, with the
// finite NEG_INF = -0.7 * FLT_MAX of the JAX package, never -inf; every
// real row sees key 0. On a diagonal tile a warp skips the fragments that
// lie wholly above the diagonal. The tile index is the grid's slowest
// dimension, so the blocks with the longest loops start first.
// - forward: one block per (head, batch, 64-row q tile); the key tiles up
//   to the diagonal stream through (flash_fwd_tc_kernel<false> in
//   flash_common.cuh; its pad instantiation is kernel 2's bf16 route).
// - backward, three launches, no float atomics, each output element
//   written by one block and summed in a fixed order (deterministic:
//   bit-equal repeats): delta = rowsum(dO * O), 8 lanes a row; then one
//   launch of two kinds of block, ordered by the length of their loops:
//   dk/dv blocks, one per (query head, batch, 64-key tile),
//   holding K and V as fragments while the head's q tiles on or below the
//   diagonal stream through (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
//   dK += dS^T Q), and dq blocks, one per (head, batch, q tile), streaming
//   the key tiles (S = Q K^T, dP = dO V^T, dQ += dS K); last, a pass sums
//   the dk/dv blocks' fp32 partials over the query group in head order
//   (with a group of 1, a cast to bf16). Splitting dk/dv over the
//   query heads rather than looping over them in one block cuts the
//   longest chain of tile steps by the group size (36 to 9 at the training
//   shape, where the loop left 144 blocks for 132 SMs); the partials cost
//   2 * B * H * S * 64 fp32 values, written once and read once.
//
// fp32 keeps the first version's kernels on the CUDA cores (67 TFLOP/s
// peak): the tensor cores take fp32 only as TF32, whose 10-bit mantissa
// cannot meet the fp32 route's 2e-5 / 1e-4 gates. The training path runs
// bf16.
//
// q, k, v and dO are read through the strides the wrapper passes (the
// innermost dimension contiguous; on the bf16 route rows 16-byte aligned):
// they arrive as transposed views of the projections and are not copied.
// O, lse, delta, dq, dk and dv are contiguous. head_dim must be 64
// (checked; the wrapper raises first).

#include "flash_common.cuh"

namespace {

constexpr int kHalf = kD / 2;

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores, one thread (forward) or two (backward) per row.

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

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync m16n8k16), tiles staged by cp.async.
// The helpers and the forward (flash_fwd_tc_kernel<false>) are in
// flash_common.cuh.

// delta[b, h, i] = sum_d dO[b, h, i, d] * O[b, h, i, d] in fp32, for the
// bf16 route: 8 lanes a row, 16 bytes each, joined by shuffles in a fixed
// order (coalesced, where flash_delta_kernel reads a row per thread).
__global__ void __launch_bounds__(256)
flash_delta_tc_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      float* __restrict__ delta, Strides dos, int n_heads,
                      int seq, long long rows) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  float s = 0.f;
  if (r < rows) {
    const int i = (int)(r % seq);
    const long long bh = r / seq;
    const int h = (int)(bh % n_heads), b = (int)(bh / n_heads);
    float x[8], y[8];
    load8(dout + b * dos.b + h * dos.h + (long long)i * dos.s + part * 8, x);
    load8(o + r * kD + part * 8, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(x[e], y[e], s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (r < rows && part == 0) delta[r] = s;
}

// Tensor-core dk/dv of one (key tile kt, query head h, batch b): warp w
// owns keys 16w .. 16w + 15 of the tile and holds their K and V as A
// fragments, while head h's q tiles kt .. last stream through,
// double-buffered. It writes fp32 partials (B, H, S, 64) of dk (scaled)
// and dv, which flash_dkdv_reduce_kernel sums over the group in a fixed
// order.
__device__ __forceinline__ void dkdv_block(
    bf16 (*sq)[kTile], bf16 (*sdo)[kTile], float (*slse)[kBQ],
    float (*sdelta)[kBQ], const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ partial, const Strides& qs, const Strides& ks,
    const Strides& vs, const Strides& dos, int n_heads, int group, int seq,
    float scale, int kt, int h, int b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_it = (seq + kBQ - 1) / kBQ - kt;  // q tiles kt .. last
  const int g = h / group;
  const long long plane = (long long)b * n_heads + h;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;

  // Q, dO, lse and delta rows of q tile kt + it into buffer `buf`.
  auto fetch = [&](int it, int buf) {
    const int r0 = (kt + it) * kBQ;
    tile_async(sq[buf], qb, qs.s, r0, seq);
    tile_async(sdo[buf], dob, dos.s, r0, seq);
    const int r = threadIdx.x & (kBQ - 1);
    const bool ok = r0 + r < seq;
    const long long at = plane * seq + (ok ? r0 + r : 0);
    if (threadIdx.x < kBQ)
      cp_async4(&slse[buf][r], lse + at, ok);
    else
      cp_async4(&sdelta[buf][r], delta + at, ok);
  };

  // K and V pass through buffer 1 on their way to the registers.
  const int k0 = kt * kBK;
  tile_async(sq[1], k + b * ks.b + g * ks.h, ks.s, k0, seq);
  tile_async(sdo[1], v + b * vs.b + g * vs.h, vs.s, k0, seq);
  fetch(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  load_a(kf, sq[1], warp * 16, lane);
  load_a(vf, sdo[1], warp * 16, lane);

  const float sl2 = scale * kLog2e;
  const int key = k0 + warp * 16 + (lane >> 2);  // c[.][0..1]; +8 for [2..3]
  const int col = 2 * (lane & 3);
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < n_it; ++it) {
    // q tile it has landed and every warp is past the previous one (and
    // past reading K and V), whose buffer then takes q tile it + 1
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) {
      fetch(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const int cur = it & 1;
    const int r0 = (kt + it) * kBQ;
    // the diagonal tile masks key > row, the last tile the rows past seq
    const bool masked = it == 0 || r0 + kBQ > seq;
    // on the diagonal tile, warp w's keys are seen by rows 16w .. 63 only
    const int lo = it == 0 ? warp : 0;

    float st[8][4], dpt[8][4];  // S^T and dP^T: 16 keys x 64 query rows
    mma_abt(st, kf, sq[cur], lane, 2 * lo);
    mma_abt(dpt, vf, sdo[cur], lane, 2 * lo);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + col + (e & 1);
        float p = ex2(fmaf(st[n][e], sl2, -slse[cur][c] * kLog2e));
        if (masked && (key + (e >> 1) * 8 > r0 + c || r0 + c >= seq)) p = 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - sdelta[cur][c]);  // dS^T / scale
      }
    }
    uint32_t pf[4][4], dsf[4][4];
    c_to_a(pf, st);
    c_to_a(dsf, dpt);
    mma_ab(dv_acc, pf, sdo[cur], lane, lo);  // dV += P^T dO
    mma_ab(dk_acc, dsf, sq[cur], lane, lo);  // dK += dS^T Q
  }

  // fp32 partials straight from the fragments: each quad writes 32 bytes
  const long long part = (long long)gridDim.y * n_heads * seq * kD;
  float* pk = partial + plane * seq * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key + 8 * r;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* at = pk + (long long)row * kD + n * 8 + col;
      *reinterpret_cast<float2*>(at) =
          make_float2(dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(at + part) =
          make_float2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// Tensor-core dq of one (q tile qt, head h, batch b): warp w owns rows
// 16w .. 16w + 15 and holds their Q and dO as A fragments, while the key
// tiles up to the diagonal stream through, double-buffered.
__device__ __forceinline__ void dq_block(
    bf16 (*sk)[kTile], bf16 (*sv)[kTile], const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, const Strides& qs,
    const Strides& ks, const Strides& vs, const Strides& dos, int n_heads,
    int group, int seq, float scale, int qt, int h, int b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * kBQ;
  const bf16* kb = k + b * ks.b + (h / group) * ks.h;
  const bf16* vb = v + b * vs.b + (h / group) * vs.h;

  // Q and dO pass through buffer 1 on their way to the registers.
  tile_async(sk[1], q + b * qs.b + h * qs.h, qs.s, q0, seq);
  tile_async(sv[1], dout + b * dos.b + h * dos.h, dos.s, q0, seq);
  tile_async(sk[0], kb, ks.s, 0, seq);
  tile_async(sv[0], vb, vs.s, 0, seq);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];
  load_a(qf, sk[1], warp * 16, lane);
  load_a(dof, sv[1], warp * 16, lane);

  const float sl2 = scale * kLog2e;
  const int row = q0 + warp * 16 + (lane >> 2);  // c[.][0..1]; +8 for [2..3]
  const int col = 2 * (lane & 3);
  const long long plane = ((long long)b * n_heads + h) * seq;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row + 8 * r < seq;
    lse2[r] = ok ? lse[plane + row + 8 * r] * kLog2e : 0.f;
    dl[r] = ok ? delta[plane + row + 8 * r] : 0.f;
  }
  float acc[8][4];
  zero(acc);

  for (int t = 0; t <= qt; ++t) {  // key tiles up to the diagonal
    // tile t has landed and every warp is past tile t - 1 (and past
    // reading Q and dO), whose buffer then takes tile t + 1
    cp_async_wait_all();
    __syncthreads();
    if (t < qt) {
      tile_async(sk[(t + 1) & 1], kb, ks.s, (t + 1) * kBK, seq);
      tile_async(sv[(t + 1) & 1], vb, vs.s, (t + 1) * kBK, seq);
      cp_async_commit();
    }

    // on the diagonal tile, warp w's rows see keys 0 .. 16w + 15 only
    const int hi = t == qt ? warp + 1 : 4;
    float s[8][4], dp[8][4];  // S and dP: 16 rows x 64 keys
    mma_abt(s, qf, sk[t & 1], lane, 0, 2 * hi);
    mma_abt(dp, dof, sv[t & 1], lane, 0, 2 * hi);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2(fmaf(s[n][e], sl2, -lse2[r]));
        if (t == qt && t * kBK + n * 8 + col + (e & 1) > row + 8 * r) p = 0.f;
        s[n][e] = p * (dp[n][e] - dl[r]);  // dS / scale
      }
    }
    uint32_t dsf[4][4];
    c_to_a(dsf, s);
    mma_ab(acc, dsf, sk[t & 1], lane, 0, hi);  // dQ += dS K
  }

  __syncthreads();  // every warp is done with the tiles it stages through
  store_rows(dq + plane * kD, q0 + warp * 16, seq, sk[0] + warp * 16 * kLd, acc,
             scale, scale, lane);
}

// Kernel 7's dk/dv and dq blocks in one launch. grid = (H, B, 2 * tiles):
// blockIdx.z = 2 * level + role; at each level the dk/dv block (key tile
// `level`) and the dq block (q tile tiles - 1 - level) walk tiles - level
// tiles, and the levels run longest first.
// 3 blocks an SM: ptxas then spills ~112 bytes a thread, which the extra
// warps more than pay for (measured 6-9% faster than 2 blocks, unspilled).
__global__ void __launch_bounds__(kThreads, 3)
flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, float* __restrict__ partial,
                    Strides qs, Strides ks, Strides vs, Strides dos, int n_heads,
                    int group, int seq, float scale) {
  __shared__ __align__(16) bf16 sa[2][kTile];  // dk/dv: Q; dq: K
  __shared__ __align__(16) bf16 sb[2][kTile];  // dk/dv: dO; dq: V
  __shared__ float slse[2][kBQ];
  __shared__ float sdelta[2][kBQ];
  const int level = blockIdx.z >> 1, h = blockIdx.x, b = blockIdx.y;
  if (blockIdx.z & 1)
    dq_block(sa, sb, q, k, v, dout, lse, delta, dq, qs, ks, vs, dos, n_heads,
             group, seq, scale, gridDim.z / 2 - 1 - level, h, b);
  else
    dkdv_block(sa, sb, slse, sdelta, q, k, v, dout, lse, delta, partial, qs, ks,
               vs, dos, n_heads, group, seq, scale, level, h, b);
}

// dk[b, g] = sum over hh < group of the partials of head g * group + hh,
// in that order (and dv likewise); 4 elements a thread.
__global__ void flash_dkdv_reduce_kernel(const float* __restrict__ partial,
                                         bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, int n_kv,
                                         int group, long long plane,
                                         long long n_out) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * n_out) return;
  const bool is_v = i >= n_out;
  const long long e = is_v ? i - n_out : i;  // element of (B, n_kv, S, 64)
  const long long bg = e / plane;
  const float* src = partial + (is_v ? n_out * group : 0) +
                     (bg * group) * plane + e % plane;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int hh = 1; hh < group; ++hh) {
    const float4 x = *reinterpret_cast<const float4*>(src + hh * plane);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat162 out[2] = {__floats2bfloat162_rn(acc.x, acc.y),
                           __floats2bfloat162_rn(acc.z, acc.w)};
  *reinterpret_cast<uint2*>((is_v ? dv : dk) + e) = *reinterpret_cast<uint2*>(out);
}

// ---------------------------------------------------------------------------

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

int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                  const void* lse, const void* dout, void* delta, void* partial,
                  void* dq, void* dk, void* dv, Strides qs, Strides ks,
                  Strides vs, Strides dos, int batch, int n_heads, int n_kv,
                  int seq, float scale, cudaStream_t st) {
  const int group = n_heads / n_kv;
  const long long rows = (long long)batch * n_heads * seq;
  flash_delta_tc_kernel<<<(unsigned)((rows * 8 + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), dos, n_heads, seq, rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int tiles = (seq + kBQ - 1) / kBQ;
  flash_bwd_tc_kernel<<<dim3(n_heads, batch, 2 * tiles), kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<float*>(partial), qs, ks, vs, dos,
      n_heads, group, seq, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long n_out = (long long)batch * n_kv * seq * kD;
  flash_dkdv_reduce_kernel<<<(unsigned)((2 * n_out / 4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n_kv, group, (long long)seq * kD, n_out);
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
  if (dtype == kBF16) {
    if (misaligned(q, qs) || misaligned(k, ks) || misaligned(v, vs))
      return (int)cudaErrorMisalignedAddress;
    return launch_fwd_tc<false>(q, k, v, out, lse, nullptr, qs, ks, vs, batch,
                                n_heads, n_kv, seq, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward of csm_flash_train_fwd: q/k/v/dout strided as above; o and
// lse as the forward wrote them; delta: (B, H, S) fp32 scratch; partial:
// (2, B, H, S, 64) fp32 scratch of the bf16 route (fp32 may pass null);
// dq (B, H, S, 64), dk/dv (B, n_kv, S, 64), contiguous, in the input type.
// Three launches on `stream`. Returns cudaGetLastError().
extern "C" int csm_flash_train_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* partial, void* dq,
    void* dk, void* dv, long long qsb, long long qsh, long long qss, long long ksb,
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
  if (dtype == kBF16) {
    if (misaligned(q, qs) || misaligned(k, ks) || misaligned(v, vs) ||
        misaligned(dout, dos) || misaligned(o, Strides{0, 0, 0}))
      return (int)cudaErrorMisalignedAddress;
    return launch_bwd_tc(q, k, v, o, lse, dout, delta, partial, dq, dk, dv, qs,
                         ks, vs, dos, batch, n_heads, n_kv, seq, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
