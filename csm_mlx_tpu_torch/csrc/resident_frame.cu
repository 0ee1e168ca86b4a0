// The whole-frame CSM decoder for Hopper (sm_90a): kernel 3 of the port.
//
// Replaces the TPU kernel `_frame_kernel` of csm_mlx_tpu/ops/resident_decoder.py
// (its default variant set: elementwise RoPE, attention over each row's own
// KV, the int8 audio head), with f32 KV at every batch size. One call runs
// one decoder frame for B <= 64 rows: for s = 0..n_cb-1 the input x is
// proj01[s] (s < 2) or embed[(s-2)*v + tok[s-1]], the W8A8 layers run
//   h = rms(x) * ln1; qkv = mv(h); RoPE(q, k) at position s; K, V -> slot s;
//   a = softmax(q.K[0..s] * hd^-1/2) . V[0..s]; x += mv(a);
//   x += mv(silu(g) * u) with [g, u] = mv(rms(x) * ln2),
// and for s >= 1 the final rms, the int8 head of codebook s and the pick
// (argmax, or Gumbel-max at T > 0) give tok[s]. `mv` is the JAX frame
// kernel's own W8A8 form: codes clip(rint(x * (127 / absmax))) with
// absmax = max(max|x|, 1e-6), out = P * s * (absmax * f32(1/127)) + z * sum(x).
//
// The design: ONE cooperative launch per call (`cudaLaunchCooperativeKernel`,
// a grid of co-resident blocks), whose phases are separated by grid-wide
// barriers (`cooperative_groups::this_grid().sync()`), ~34 per step:
// - per-row phases (one block per row): rms + int8 quantization of a row into
//   a global int8 buffer and its (absmax/127, sum) pair; attention of all
//   heads of a row followed by the quantization of its output; the pick of a
//   token from the head phase's per-block partials and the gather of the next
//   input row;
// - matvec phases: output-channel PAIRS spread over all warps of the grid,
//   each warp streaming its two weight rows in 16-byte loads into __dp4a
//   int32 sums (as csrc/w8a8_matvec.cu). The qkv warp owning channels
//   (2i, 2i+1) rotates the pair and writes q, or K / V of slot s; the
//   gate-up warp owning gate channel j and up channel f+j writes
//   silu(g)*u; the o and down warps add into x; the head warp keeps each
//   row's best (logit, column) over its columns.
// Every cross-block reduction (the token pick) goes through per-block
// partials reduced in a fixed order with a first-index tie rule; no float
// atomics, so a call's tokens are the same on every run. Data written inside
// the launch is read with plain (coherent) loads after a barrier; only the
// weight codes and norm gains go through the read-only path (__ldg). Every
// sum runs in a fixed order that the plain version repeats, so the two agree
// to the bit.
//
// What bounds it on the H100: the decoder's int8 weights (111 MB at CSM-1B
// width) do not fit the 50 MB L2, so every step streams them again: 32 steps
// x 111 MB at 3.35 TB/s is ~1.06 ms a frame, against 54 us to read every table
// once. The ~1,100 grid barriers a frame, and per-row phases that leave all
// but B blocks idle, cost more: 7.7 ms a frame at B = 1 on an H100 (700 W).
// Holding weights in L2 across steps, fewer barriers and wgmma at B = 64 are
// later work.

#include <cooperative_groups.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;    // MAX_LAYERS of ops/resident_decoder.py
constexpr int kBlocksPerSM = 2;  // _BLOCKS_PER_SM of ops/resident_decoder.py
constexpr int kMaxRows = 64;     // RESIDENT_MAX_BATCH
constexpr float kNeg = -1e30f;
constexpr float kInv127 = 1.0f / 127.0f;  // == float32(1.0 / 127.0)

struct Layer {
  const float* ln1;
  const int8_t* qkv;
  const float* qkv_sz;  // (2, OUT): scales, then biases
  const int8_t* o;
  const float* o_sz;
  const float* ln2;
  const int8_t* gu;
  const float* gu_sz;
  const int8_t* dn;
  const float* dn_sz;
};

struct Frame {
  Layer layer[kMaxLayers];
  const float* norm;     // (d)
  const float* rope_cs;  // (n_cb, 3, hd)
  const int8_t* head_q;  // (n_cb-1, v_pad, d)
  const float* head_s;   // (n_cb-1, v_pad)
  const float* embed;    // ((n_cb-2)*v, d)
  const float* proj01;   // (2, B, d)
  float* x;              // (B, d)
  float* q;              // (B, heads*hd)
  float* act;            // (B, f)
  int8_t* xq;            // (B, <= max(d, f))
  float2* aux;           // (B): (absmax / 127, sum) of each quantized row
  float* kc;             // (layers, n_cb, B, n_kv*hd)
  float* vc;
  int2* part;            // (grid, B): (logit bits, column) of each block
  int* tokens;           // (n_cb, B)
  float* logits;         // (n_cb-1, B, v) before any noise, or null
  int n_layers, rows, heads, n_kv, hd, d, f, n_cb, v, v_pad;
  float eps, scale, inv_t;
  unsigned seed;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Block-wide sum / max, the same fixed order on every run. `red` holds
// kWarps floats of shared memory.
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__device__ float block_max(float x, float* red) {
  x = warp_max(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w]);
  return t;
}

// One row, by the whole block: buf <- src (a copy also to `copy_to`), or
// rms(src) * gain; then its int8 codes into xq and (absmax/127, sum) into aux.
__device__ void quant_row(const float* src, const float* gain, float eps, int n,
                          float* copy_to, int8_t* xq, float2* aux, float* buf,
                          float* red) {
  __syncthreads();  // buf may still be read by another thread's last phase
  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float t = src[i];
    buf[i] = t;
    if (copy_to != nullptr) copy_to[i] = t;
    ss = __fadd_rn(ss, __fmul_rn(t, t));
  }
  if (gain != nullptr) {
    const float rr = 1.f / sqrtf(block_sum(ss, red) / (float)n + eps);
    for (int i = threadIdx.x; i < n; i += kThreads)
      buf[i] = __fmul_rn(__fmul_rn(buf[i], rr), __ldg(gain + i));
  }
  float amax = 0.f, sum = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    amax = fmaxf(amax, fabsf(buf[i]));
    sum += buf[i];
  }
  amax = fmaxf(block_max(amax, red), 1e-6f);
  sum = block_sum(sum, red);
  const float xs = 127.f / amax;  // a true division, as in JAX
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float c = fminf(fmaxf(rintf(__fmul_rn(buf[i], xs)), -127.f), 127.f);
    xq[i] = (int8_t)(int)c;
  }
  if (threadIdx.x == 0) *aux = make_float2(__fmul_rn(amax, kInv127), sum);
}

__device__ __forceinline__ int dot16(const int4& a, const int4& b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// Exact int32 dots of two weight rows with rows r0..r0+RB-1 of xq, summed
// over the warp: every lane ends with every sum.
template <int RB>
__device__ __forceinline__ void dot_pair(const int8_t* w0, const int8_t* w1,
                                         const int8_t* xq, int r0, int rows,
                                         int in_dim, int (&acc)[2][RB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[0][r] = acc[1][r] = 0;
  const int nvec = in_dim >> 4;
  const int4* p0 = reinterpret_cast<const int4*>(w0);
  const int4* p1 = reinterpret_cast<const int4*>(w1);
  const int4* px = reinterpret_cast<const int4*>(xq + (size_t)r0 * in_dim);
#pragma unroll 4
  for (int k = lane; k < nvec; k += 32) {
    const int4 a = __ldg(p0 + k), c = __ldg(p1 + k);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r0 + r < rows) {
        const int4 xv = px[(size_t)r * nvec + k];
        acc[0][r] = dot16(a, xv, acc[0][r]);
        acc[1][r] = dot16(c, xv, acc[1][r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[0][r] += __shfl_xor_sync(0xffffffffu, acc[0][r], off);
      acc[1][r] += __shfl_xor_sync(0xffffffffu, acc[1][r], off);
    }
}

// The output pairs of one matvec spread over every warp of the grid.
// rows_of(p, w0, w1) names pair p's two weight rows; epi(p, row, acc0, acc1)
// runs once per batch row, on lane row % 32.
template <int RB, typename RowsOf, typename Epi>
__device__ __forceinline__ void matvec_pairs(int n_pairs, int in_dim,
                                             const int8_t* xq, int rows,
                                             RowsOf rows_of, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * kWarps;
  for (int p = blockIdx.x * kWarps + (threadIdx.x >> 5); p < n_pairs; p += nw) {
    const int8_t* w0;
    const int8_t* w1;
    rows_of(p, w0, w1);
    for (int r0 = 0; r0 < rows; r0 += RB) {
      int acc[2][RB];
      dot_pair<RB>(w0, w1, xq, r0, rows, in_dim, acc);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (lane == ((r0 + r) & 31) && r0 + r < rows)
          epi(p, r0 + r, acc[0][r], acc[1][r]);
    }
  }
}

// P * s * (absmax/127) + z * sum, unfused, in the plain version's order.
__device__ __forceinline__ float fixup(int acc, float s, float z, float2 a) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)acc, s), a.x), __fmul_rn(z, a.y));
}

// Philox4x32-10 of (column, row, step) under the call's seed: 32 random bits.
__device__ __forceinline__ unsigned philox(unsigned seed, unsigned col,
                                           unsigned row, unsigned step) {
  unsigned c0 = col, c1 = row, c2 = step, c3 = 0u;
  unsigned k0 = seed, k1 = 0x85A308D3u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// (value, column) order of the pick: larger value, then smaller column.
__device__ __forceinline__ void take_better(float v, int i, float& bv, int& bi) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// The token of row `row` from the head phase's per-block partials, reduced
// by warp 0 of the block; every thread returns it.
__device__ int pick_token(const Frame& a, int row, int* s_tok) {
  if (threadIdx.x < 32) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int g = threadIdx.x; g < (int)gridDim.x; g += 32) {
      const int2 e = a.part[(size_t)g * a.rows + row];
      take_better(__int_as_float(e.x), e.y, bv, bi);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      take_better(__shfl_xor_sync(0xffffffffu, bv, off),
                  __shfl_xor_sync(0xffffffffu, bi, off), bv, bi);
    if (threadIdx.x == 0) *s_tok = bi;
  }
  __syncthreads();
  return *s_tok;
}

template <int RB>
__global__ void __launch_bounds__(kThreads)
resident_frame_kernel(const __grid_constant__ Frame a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* red = smem;                                 // kWarps
  int* s_tok = reinterpret_cast<int*>(smem + 32);    // 1
  float* sv = smem + 64;                             // kWarps * kMaxRows
  int* si = reinterpret_cast<int*>(sv + kWarps * kMaxRows);
  float* buf = reinterpret_cast<float*>(si + kWarps * kMaxRows);  // max(d, f)

  const int B = a.rows, d = a.d, f = a.f, hd = a.hd;
  const int attn = a.heads * hd, kvd = a.n_kv * hd, group = a.heads / a.n_kv;
  const int qkv_out = attn + 2 * kvd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int s = 0; s < a.n_cb; ++s) {
    // The pick of step s-1, this step's input row, layer 0's quantization.
    for (int row = blockIdx.x; row < B; row += gridDim.x) {
      const float* src = a.proj01 + ((size_t)min(s, 1) * B + row) * d;
      if (s >= 2) {
        const int tok = pick_token(a, row, s_tok);
        if (threadIdx.x == 0) a.tokens[(size_t)(s - 1) * B + row] = tok;
        const int t = min(max(tok, 0), a.v - 1);
        src = a.embed + ((size_t)(s - 2) * a.v + t) * d;
      }
      quant_row(src, a.layer[0].ln1, a.eps, d, a.x + (size_t)row * d,
                a.xq + (size_t)row * d, a.aux + row, buf, red);
    }
    grid.sync();

    for (int l = 0; l < a.n_layers; ++l) {
      const Layer L = a.layer[l];
      if (l > 0) {
        for (int row = blockIdx.x; row < B; row += gridDim.x)
          quant_row(a.x + (size_t)row * d, L.ln1, a.eps, d, nullptr,
                    a.xq + (size_t)row * d, a.aux + row, buf, red);
        grid.sync();
      }
      float* kc = a.kc + (size_t)l * a.n_cb * B * kvd;
      float* vc = a.vc + (size_t)l * a.n_cb * B * kvd;

      // qkv; RoPE on q and k pairs; q -> a.q, k and v -> slot s
      const float* cs = a.rope_cs + (size_t)s * 3 * hd;
      matvec_pairs<RB>(
          qkv_out / 2, d, a.xq, B,
          [&](int p, const int8_t*& w0, const int8_t*& w1) {
            w0 = L.qkv + (size_t)(2 * p) * d;
            w1 = w0 + d;
          },
          [&](int p, int row, int acc0, int acc1) {
            const int o = 2 * p;
            const float2 ax = a.aux[row];
            const float y0 = fixup(acc0, L.qkv_sz[o], L.qkv_sz[qkv_out + o], ax);
            const float y1 = fixup(acc1, L.qkv_sz[o + 1], L.qkv_sz[qkv_out + o + 1], ax);
            if (o < attn + kvd) {
              const int i = o % hd;
              const float c = cs[i], ns = cs[hd + i], sn = cs[2 * hd + i + 1];
              const float r0 = __fadd_rn(__fmul_rn(y0, c), __fmul_rn(y1, ns));
              const float r1 = __fadd_rn(__fmul_rn(y1, c), __fmul_rn(y0, sn));
              float* dst = o < attn
                               ? a.q + (size_t)row * attn + o
                               : kc + ((size_t)s * B + row) * kvd + (o - attn);
              dst[0] = r0;
              dst[1] = r1;
            } else {
              float* dst = vc + ((size_t)s * B + row) * kvd + (o - attn - kvd);
              dst[0] = y0;
              dst[1] = y1;
            }
          });
      grid.sync();

      // attention of every head of a row over slots 0..s, then its quantization
      for (int row = blockIdx.x; row < B; row += gridDim.x) {
        for (int h = warp; h < a.heads; h += kWarps) {
          const int g = h / group;
          const float* qv = a.q + (size_t)row * attn + (size_t)h * hd;
          float mine = -INFINITY;
          for (int j = 0; j <= s; ++j) {
            const float* kv = kc + ((size_t)j * B + row) * kvd + (size_t)g * hd;
            float part = 0.f;
            for (int e = lane; e < hd; e += 32)
              part = __fadd_rn(part, __fmul_rn(qv[e], kv[e]));
            part = warp_sum(part);
            if (lane == j) mine = __fmul_rn(part, a.scale);
          }
          const float m = warp_max(mine);
          const float ex = lane <= s ? expf(mine - m) : 0.f;
          const float pj = ex / warp_sum(ex);
          for (int base = 0; base < hd; base += 32) {
            const int e = base + lane;
            float acc = 0.f;
            for (int j = 0; j <= s; ++j) {
              const float pjj = __shfl_sync(0xffffffffu, pj, j);
              if (e < hd)
                acc = __fadd_rn(acc, __fmul_rn(
                    pjj, vc[((size_t)j * B + row) * kvd + (size_t)g * hd + e]));
            }
            if (e < hd) buf[h * hd + e] = acc;
          }
        }
        __syncthreads();
        quant_row(buf, nullptr, 0.f, attn, nullptr, a.xq + (size_t)row * attn,
                  a.aux + row, buf, red);
      }
      grid.sync();

      // x += o(attention)
      matvec_pairs<RB>(
          d / 2, attn, a.xq, B,
          [&](int p, const int8_t*& w0, const int8_t*& w1) {
            w0 = L.o + (size_t)(2 * p) * attn;
            w1 = w0 + attn;
          },
          [&](int p, int row, int acc0, int acc1) {
            const int o = 2 * p;
            const float2 ax = a.aux[row];
            float* xr = a.x + (size_t)row * d + o;
            xr[0] = __fadd_rn(xr[0], fixup(acc0, L.o_sz[o], L.o_sz[d + o], ax));
            xr[1] = __fadd_rn(xr[1], fixup(acc1, L.o_sz[o + 1], L.o_sz[d + o + 1], ax));
          });
      grid.sync();

      for (int row = blockIdx.x; row < B; row += gridDim.x)
        quant_row(a.x + (size_t)row * d, L.ln2, a.eps, d, nullptr,
                  a.xq + (size_t)row * d, a.aux + row, buf, red);
      grid.sync();

      // act = silu(gate) * up: the warp of pair j owns gate j and up f+j
      matvec_pairs<RB>(
          f, d, a.xq, B,
          [&](int j, const int8_t*& w0, const int8_t*& w1) {
            w0 = L.gu + (size_t)j * d;
            w1 = L.gu + (size_t)(f + j) * d;
          },
          [&](int j, int row, int acc0, int acc1) {
            const float2 ax = a.aux[row];
            const float gt = fixup(acc0, L.gu_sz[j], L.gu_sz[2 * f + j], ax);
            const float up = fixup(acc1, L.gu_sz[f + j], L.gu_sz[3 * f + j], ax);
            const float sig = 1.f / (1.f + expf(-gt));
            a.act[(size_t)row * f + j] = __fmul_rn(__fmul_rn(gt, sig), up);
          });
      grid.sync();

      for (int row = blockIdx.x; row < B; row += gridDim.x)
        quant_row(a.act + (size_t)row * f, nullptr, 0.f, f, nullptr,
                  a.xq + (size_t)row * f, a.aux + row, buf, red);
      grid.sync();

      // x += down(act)
      matvec_pairs<RB>(
          d / 2, f, a.xq, B,
          [&](int p, const int8_t*& w0, const int8_t*& w1) {
            w0 = L.dn + (size_t)(2 * p) * f;
            w1 = w0 + f;
          },
          [&](int p, int row, int acc0, int acc1) {
            const int o = 2 * p;
            const float2 ax = a.aux[row];
            float* xr = a.x + (size_t)row * d + o;
            xr[0] = __fadd_rn(xr[0], fixup(acc0, L.dn_sz[o], L.dn_sz[d + o], ax));
            xr[1] = __fadd_rn(xr[1], fixup(acc1, L.dn_sz[o + 1], L.dn_sz[d + o + 1], ax));
          });
      grid.sync();
    }
    if (s == 0) continue;

    // the head of codebook s: final rms, int8 codes of h, then each block's
    // best (logit, column) per row
    for (int row = blockIdx.x; row < B; row += gridDim.x)
      quant_row(a.x + (size_t)row * d, a.norm, a.eps, d, nullptr,
                a.xq + (size_t)row * d, a.aux + row, buf, red);
    grid.sync();

    const int8_t* head = a.head_q + (size_t)(s - 1) * a.v_pad * d;
    const float* hs = a.head_s + (size_t)(s - 1) * a.v_pad;
    float bv0 = -INFINITY, bv1 = -INFINITY;  // rows lane and lane + 32
    int bi0 = INT_MAX, bi1 = INT_MAX;
    matvec_pairs<RB>(
        a.v_pad / 2, d, a.xq, B,
        [&](int p, const int8_t*& w0, const int8_t*& w1) {
          w0 = head + (size_t)(2 * p) * d;
          w1 = w0 + d;
        },
        [&](int p, int row, int acc0, int acc1) {
          const float inv = a.aux[row].x;
          const int accs[2] = {acc0, acc1};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 2 * p + c;
            float lg = kNeg;
            if (col < a.v) {
              lg = __fmul_rn(__fmul_rn((float)accs[c], hs[col]), inv);
              if (a.logits != nullptr)
                a.logits[((size_t)(s - 1) * B + row) * a.v + col] = lg;
              if (a.inv_t > 0.f) {
                const unsigned bits = philox(a.seed, col, row, s);
                const float u = (float)(bits & 0x7FFFFFu) * (1.f / 8388608.f);
                const float gn = -logf(-logf(u + 1e-10f) + 1e-10f);
                lg = __fadd_rn(__fmul_rn(lg, a.inv_t), gn);
              }
            }
            // this is lane row % 32: it keeps rows lane and lane + 32
            if (row < 32) take_better(lg, col, bv0, bi0);
            else take_better(lg, col, bv1, bi1);
          }
        });
    // each block's best per row, reduced over its warps in a fixed order
    sv[warp * kMaxRows + lane] = bv0;
    si[warp * kMaxRows + lane] = bi0;
    sv[warp * kMaxRows + lane + 32] = bv1;
    si[warp * kMaxRows + lane + 32] = bi1;
    __syncthreads();
    for (int row = threadIdx.x; row < B; row += kThreads) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int w = 0; w < kWarps; ++w)
        take_better(sv[w * kMaxRows + row], si[w * kMaxRows + row], bv, bi);
      a.part[(size_t)blockIdx.x * B + row] = make_int2(__float_as_int(bv), bi);
    }
    grid.sync();
  }

  // the last step's pick, and codebook 0's row of zeros
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const int tok = pick_token(a, row, s_tok);
    if (threadIdx.x == 0) {
      a.tokens[(size_t)(a.n_cb - 1) * B + row] = tok;
      a.tokens[row] = 0;
    }
  }
}

template <int RB>
cudaError_t launch(const Frame& f, int part_cap, cudaStream_t stream) {
  auto* kernel = resident_frame_kernel<RB>;
  const size_t smem =
      (64 + 2 * kWarps * kMaxRows + (size_t)std::max(f.d, f.f)) * sizeof(float);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  // Every block of a cooperative grid must be resident at once; more than
  // kBlocksPerSM a SM would only lengthen each grid barrier.
  const int grid = std::min(sms * std::min(per_sm, kBlocksPerSM), part_cap);
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Frame*>(&f)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// layer_ptrs: n_layers * 10 device pointers, per layer [ln1, qkv codes, qkv
// scale/bias rows, o codes, o rows, ln2, gate-up codes, gate-up rows, down
// codes, down rows]; the other tables, the scratch buffers and the tokens as
// in `Frame`. part holds part_cap * rows int2. inv_t = 0 picks greedily.
// logits, when not null, receives the (n_cb-1, rows, v) logits before noise.
// The wrapper (ops/resident_decoder.py) checks shapes, types and layout.
// Returns the launch's error code, 0 on success.
extern "C" int csm_resident_frame(
    const void* const* layer_ptrs, int n_layers, const void* norm,
    const void* rope_cs, const void* head_q, const void* head_s,
    const void* embed, const void* proj01, void* x, void* q, void* act,
    void* xq, void* aux, void* kc, void* vc, void* part, int part_cap,
    void* tokens, void* logits, int rows, int heads, int n_kv, int hd, int d, int f, int n_cb,
    int v, int v_pad, float eps, float scale, float inv_t, unsigned seed,
    void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || rows < 1 || rows > kMaxRows ||
      n_cb > 32)
    return (int)cudaErrorInvalidValue;
  Frame fr{};
  for (int l = 0; l < n_layers; ++l) {
    const void* const* p = layer_ptrs + 10 * l;
    fr.layer[l] = Layer{static_cast<const float*>(p[0]), static_cast<const int8_t*>(p[1]),
                        static_cast<const float*>(p[2]), static_cast<const int8_t*>(p[3]),
                        static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
                        static_cast<const int8_t*>(p[6]), static_cast<const float*>(p[7]),
                        static_cast<const int8_t*>(p[8]), static_cast<const float*>(p[9])};
  }
  fr.norm = static_cast<const float*>(norm);
  fr.rope_cs = static_cast<const float*>(rope_cs);
  fr.head_q = static_cast<const int8_t*>(head_q);
  fr.head_s = static_cast<const float*>(head_s);
  fr.embed = static_cast<const float*>(embed);
  fr.proj01 = static_cast<const float*>(proj01);
  fr.x = static_cast<float*>(x);
  fr.q = static_cast<float*>(q);
  fr.act = static_cast<float*>(act);
  fr.xq = static_cast<int8_t*>(xq);
  fr.aux = static_cast<float2*>(aux);
  fr.kc = static_cast<float*>(kc);
  fr.vc = static_cast<float*>(vc);
  fr.part = static_cast<int2*>(part);
  fr.tokens = static_cast<int*>(tokens);
  fr.logits = static_cast<float*>(logits);
  fr.n_layers = n_layers;
  fr.rows = rows;
  fr.heads = heads;
  fr.n_kv = n_kv;
  fr.hd = hd;
  fr.d = d;
  fr.f = f;
  fr.n_cb = n_cb;
  fr.v = v;
  fr.v_pad = v_pad;
  fr.eps = eps;
  fr.scale = scale;
  fr.inv_t = inv_t;
  fr.seed = seed;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (rows == 1)
    e = launch<1>(fr, part_cap, st);
  else if (rows == 2)
    e = launch<2>(fr, part_cap, st);
  else if (rows <= 4)
    e = launch<4>(fr, part_cap, st);
  else
    e = launch<8>(fr, part_cap, st);
  return (int)e;
}
