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
// What bounds it on the H100: the decoder's int8 codes, 111 MB at CSM-1B
// width, more than the 50 MB L2, are read by each of the 32 steps (1.06 ms a
// frame at 3.35 TB/s), against 54 us to read every table once; and each
// step is a chain of ~20 dependent phases, each closed by a grid barrier, so
// at small B the latency of each phase counts more than its bytes.
//
// The design: ONE cooperative launch per call, one block per SM, each block
// owning the same 16-channel tiles of every matvec in every step (tile t of a
// matrix belongs to block t % grid). Every step streams the codes from
// device memory. The TPU kernel's idea, loading the weights once a frame,
// does not carry over: on an H100 (132 SMs, 227 KB a block) the room beside
// the ring and the row buffers holds 6.3 MB of the 111 MB at CSM-1B width,
// and holding those in shared memory for the call measured within noise of
// streaming them, as the steps are bound by their phases' latency, not
// their bytes. A block streams its tiles in units of 16 rows x 1024 bytes
// with bulk copies (TMA, cp.async.bulk, evict_first in L2) into a ring of
// kRing shared-memory slots: warp 0 issues, completing each on the slot's
// "full" mbarrier, and refills a slot with the unit kRing later as soon as
// the consumer warps 1..7 mark it "empty". The next phase's first units,
// which do not depend on the data, so arrive while the block waits
// at the grid barrier and does its per-row work.
//
// Matvecs run on the int8 tensor cores (csrc/int8_mma.cuh: mma.sync
// m16n8k32): the weights are the 16-row A tile, the batch rows the n8
// columns, so each weight byte is read once a step for all rows. At B <= 8
// (one n8 tile) with rows of one unit, a consumer warp owns whole tiles and
// runs the epilogue from its own registers, with four independent
// accumulators in flight; otherwise the consumer warps split each unit's
// k-steps and their exact int32 partials meet in shared memory.
//
// Per-row work. Where B <= kLocalRows and B x width <= kLocalElems, every
// block prepares the rows a matvec needs itself, from the f32 rows in device
// memory into its shared memory (rms x gain, int8 codes, (absmax/127, sum)),
// as the matvec's prologue. Otherwise a per-row phase spreads the rows over
// the blocks and writes device memory, and the matvec stages those codes in
// chunks. Attention is a phase of its own: one warp per (row, head), each
// lane scoring one slot. At B = 1 a layer-step is qkv | attention | o |
// gate-up | down, 5 barriers, and the head one more.
//
// Numerics: every float sum runs in the order of the plain version
// (`resident_decode_frame_plain`): a row sum is 256 thread chains, each
// warp's butterfly and the warps in order; a score is 32 lane chains and the
// butterfly; int32 sums are exact in any order. The token pick keeps
// per-block partials and a total order on (value, column), so any split of
// the columns gives the same token, and no float atomics are used. Data
// written inside the launch is read with plain loads after a barrier; the
// codes and norm gains go through the read-only path.

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;    // _THREADS of ops/resident_decoder.py
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;    // MAX_LAYERS
constexpr int kMaxRows = 64;     // RESIDENT_MAX_BATCH
// every block prepares the rows of a matvec itself while B <= kLocalRows
// and B x the matvec's IN <= kLocalElems (LOCAL_ROWS, LOCAL_ELEMS)
constexpr int kLocalRows = 8;
constexpr int kLocalElems = 8192;
constexpr int kRing = 4;         // RING_UNITS
constexpr int kUnitK = 1024;     // UNIT_K: bytes of a row in one unit
constexpr int kUnitStride = kUnitK + 16;
constexpr int kUnitBytes = 16 * kUnitStride;
constexpr float kNeg = -1e30f;
constexpr float kInv127 = 1.0f / 127.0f;  // == float32(1.0 / 127.0)

// Phase kinds of the stamp records (PHASE_KINDS).
enum Phase : int { kPick = 0, kPrep, kQkv, kAttn, kO, kGu, kDn, kHead, kEnd };

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
  float* ao;             // (B, heads*hd): attention outputs
  float* act;            // (B, f)
  int8_t* xq;            // (B, <= max(d, f)): codes of the spread per-row phases
  float2* aux;           // (B): (absmax / 127, sum) of each quantized row
  float* kc;             // (layers, n_cb, B, n_kv*hd)
  float* vc;
  int2* part;            // (grid, B): (logit bits, column) of each block
  int* tokens;           // (n_cb, B)
  float* logits;         // (n_cb-1, B, v) before any noise, or null
  unsigned long long* stamps;  // (stamp_cap, 4) phase records, or null
  int stamp_cap;
  int n_layers, rows, heads, n_kv, hd, d, f, n_cb, v, v_pad;
  float eps, scale, inv_t;
  // the call's seed, one int32 in device memory: read by the kernel, so a
  // launch captured in a CUDA graph takes the seed its step drew
  const int* seed;
};

// Fixed shared-memory regions (bytes).
constexpr int kSmBars = 0;     // kRing "full", kRing "empty"
constexpr int kSmRed = 128;    // kWarps * kLocalRows floats
constexpr int kSmAux = kSmRed + kWarps * kLocalRows * 4;
constexpr int kSmTok = kSmAux + kMaxRows * 8;
constexpr int kSmBest = kSmTok + kMaxRows * 4;   // float + int per warp and row
constexpr int kSmAcc = kSmBest + kWarps * kMaxRows * 8;
constexpr int kSmRowp = kSmAcc + 2 * kMaxRows * 16 * 4;  // kLocalRows row pointers
constexpr int kSmTab = kSmRowp + kLocalRows * 8;          // the producer's slot table
constexpr int kSmProd = kSmTab + (4 * kMaxLayers + 1) * 48;  // the producer's state
// int32 partial sums of the consumer warps, (2, kWarps - 1, kLocalRows, 16),
// summed in the block before an epilogue at B <= 8
constexpr int kSmPart = kSmProd + 64;
constexpr int kSmFixed = kSmPart + 2 * (kWarps - 1) * kLocalRows * 16 * 4;
// the rows' codes: the block's own (<= kLocalElems + 16 a row), or a staged
// chunk of up to kMaxRows rows; then the ring
constexpr int kXqBytes = (kMaxRows * kUnitStride > kLocalElems + 16 * kLocalRows)
                             ? kMaxRows * kUnitStride
                             : kLocalElems + 16 * kLocalRows;
constexpr int kSmXq = kSmFixed;
constexpr int kSmRing = kSmXq + (kXqBytes + 15) / 16 * 16;
constexpr int kSmTotal = kSmRing + kRing * kUnitBytes;

// One matrix of a phase, as this kernel walks it.
struct Mat {
  const int8_t* w;  // codes (OUT, IN)
  int in;
  int tiles;        // 16-row tiles (gate-up: tiles of 16 gate and 16 up rows)
  int halves;       // 2 for gate-up: gate rows t*16.., up rows half_rows + t*16..
  int half_rows;
  int upt;          // units per tile half: ceil(in / kUnitK)
};

__device__ __forceinline__ int my_tiles(int tiles) {
  const int b = blockIdx.x;
  return b < tiles ? (tiles - 1 - b) / (int)gridDim.x + 1 : 0;
}

__device__ __forceinline__ Mat make_mat(const int8_t* w, int out_tiles, int in, int halves,
                                        int half_rows) {
  return Mat{w, in, out_tiles, halves, half_rows, (in + kUnitK - 1) / kUnitK};
}

// Matrix slot `slot` of step s: 4 per layer (qkv, o, gate-up, down), then
// the head of codebook s-1 for s >= 1.
__device__ __forceinline__ Mat slot_mat(const Frame& a, int s, int slot) {
  const int L = a.n_layers;
  if (slot >= 4 * L) {
    return make_mat(a.head_q + (size_t)(s - 1) * a.v_pad * a.d, a.v_pad / 16, a.d, 1, 0);
  }
  const Layer& ly = a.layer[slot >> 2];
  const int attn = a.heads * a.hd, qkv_out = attn + 2 * a.n_kv * a.hd;
  switch (slot & 3) {
    case 0: return make_mat(ly.qkv, qkv_out / 16, a.d, 1, 0);
    case 1: return make_mat(ly.o, a.d / 16, attn, 1, 0);
    case 2: return make_mat(ly.gu, a.f / 16, a.d, 2, a.f);
    default: return make_mat(ly.dn, a.d / 16, a.f, 1, 0);
  }
}

__device__ __forceinline__ int block_units(const Mat& m) {
  return my_tiles(m.tiles) * m.halves * m.upt;
}

// One matrix slot of a step as the producer walks it (shared memory, built
// once a call): this block's units of it. The head's codes move by
// step_stride a codebook.
struct UnitSlot {
  const int8_t* w;
  long long step_stride;
  int in, upt, halves, half_rows, units;
};
static_assert(sizeof(UnitSlot) <= 48, "slot table entry");

// The next streamed unit to issue, in the order the block consumes them:
// step s, matrix slot, index within the slot and the same index as (tile,
// half, chunk); kRing units ahead of the consumers. In shared memory, read
// and written by warp 0 only.
struct Producer {
  int s, slot, idx, count, tl, half, c, done;
  int n_cb, n_full;          // steps; slots of a step with a head
  int issued;                // units issued so far (read by the consumers)
};

// Move p to the next slot with streamed units at or after its position.
__device__ __forceinline__ void producer_seek(const UnitSlot* tab, Producer& p) {
  while (!p.done && p.idx >= p.count) {
    p.idx = p.tl = p.half = p.c = 0;
    if (++p.slot >= (p.s >= 1 ? p.n_full : p.n_full - 1)) {
      p.slot = 0;
      if (++p.s >= p.n_cb) {
        p.done = 1;
        break;
      }
    }
    p.count = tab[p.slot].units;
  }
}

// Issue the unit of *state into ring slot r (warp 0: lane 0 announces the
// bytes, lanes 0..15 copy a row each), then advance *state.
__device__ __forceinline__ void producer_issue(const UnitSlot* tab, Producer* state,
                                               int8_t* ring, uint64_t* full, int r) {
  Producer p = *state;
  if (p.done) return;
  const int lane = threadIdx.x & 31;
  const UnitSlot& t = tab[p.slot];
  const int in = t.in, upt = t.upt;
  const int tile = blockIdx.x + p.tl * (int)gridDim.x;
  const int k0 = p.c * kUnitK, kb = min(kUnitK, in - k0);
  const long long rel = ((long long)p.half * t.half_rows + (long long)tile * 16) * in + k0;
  const int8_t* src = t.w + (p.s >= 1 ? (p.s - 1) * t.step_stride : 0) + rel;
  if (lane == 0) mbar_arrive_tx(full + r, 16u * kb);
  __syncwarp();
  if (lane < 16)
    bulk_copy(ring + r * kUnitBytes + lane * kUnitStride, src + (size_t)lane * in,
              (uint32_t)kb, full + r, l2_policy_stream());
  ++p.idx;
  if (++p.c == upt) {
    p.c = 0;
    if (++p.half == t.halves) {
      p.half = 0;
      ++p.tl;
    }
  }
  producer_seek(tab, p);
  ++p.issued;
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();  // the unit's arrive before its count
    *state = p;
  }
  __syncwarp();
}

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

// Block-wide sums (or maxima) of `nrows` values per thread, each in the fixed
// order of the plain version: the warp's butterfly, then warps 0..7 in turn.
template <bool kMax>
__device__ void block_reduce(float (&v)[kLocalRows], int nrows, float* red) {
  __syncthreads();  // red may still be read by the last reduction
#pragma unroll
  for (int r = 0; r < kLocalRows; ++r) {
    if (r < nrows) {
      const float t = kMax ? warp_max(v[r]) : warp_sum(v[r]);
      if ((threadIdx.x & 31) == 0) red[r * kWarps + (threadIdx.x >> 5)] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kLocalRows; ++r) {
    if (r < nrows) {
      float t = kMax ? red[r * kWarps] : 0.f;
      for (int w = kMax ? 1 : 0; w < kWarps; ++w)
        t = kMax ? fmaxf(t, red[r * kWarps + w]) : t + red[r * kWarps + w];
      v[r] = t;
    }
  }
}

// Rows 0..nrows-1 (<= kLocalRows), row r's n f32 values at rowp[r] (shared
// memory, set before the call): h = the row (gain null) or rms(row) * gain;
// h's int8 codes into dst + r * dst_stride and (absmax/127, sum) into
// aux[r]. The whole block takes part. One instance, not inlined: the
// kernel's code stays small enough for the instruction cache.
__device__ __noinline__ void prep_rows(const float* const* rowp, int nrows, int n,
                                       const float* gain, float eps, int8_t* dst,
                                       int dst_stride, float2* aux, float* red) {
  __syncthreads();  // rowp is set
  if (nrows == 1 && n <= 32 * kThreads) {
    // one row: this thread's elements i = t, t + 256, ... held in registers,
    // read once
    const float* p = rowp[0];
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int i = threadIdx.x + k * kThreads;
      v[k] = i < n ? p[i] : 0.f;
    }
    float one[kLocalRows];
    if (gain != nullptr) {
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (threadIdx.x + k * kThreads < n) ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
      one[0] = ss;
      block_reduce<false>(one, 1, red);
      const float rr = 1.f / sqrtf(one[0] / (float)n + eps);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < n) v[k] = __fmul_rn(__fmul_rn(v[k], rr), __ldg(gain + i));
      }
    }
    float mx = 0.f, sm = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (threadIdx.x + k * kThreads < n) {
        mx = fmaxf(mx, fabsf(v[k]));
        sm = __fadd_rn(sm, v[k]);
      }
    }
    one[0] = mx;
    block_reduce<true>(one, 1, red);
    const float amax = fmaxf(one[0], 1e-6f);
    one[0] = sm;
    block_reduce<false>(one, 1, red);
    const float xs = 127.f / amax;  // a true division, as in JAX
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < n)
        dst[i] = (int8_t)(int)fminf(fmaxf(rintf(__fmul_rn(v[k], xs)), -127.f), 127.f);
    }
    if (threadIdx.x == 0) aux[0] = make_float2(__fmul_rn(amax, kInv127), one[0]);
    __syncthreads();
    return;
  }
  if (n <= 4 * kThreads) {
    // up to kLocalRows rows of up to 1024: held in registers, read once
    float v[kLocalRows][4], rr[kLocalRows];
#pragma unroll
    for (int r = 0; r < kLocalRows; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = threadIdx.x + j * kThreads;
        v[r][j] = r < nrows && i < n ? rowp[r][i] : 0.f;
      }
    if (gain != nullptr) {
      float ss[kLocalRows];
#pragma unroll
      for (int r = 0; r < kLocalRows; ++r) {
        ss[r] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (threadIdx.x + j * kThreads < n) ss[r] = __fadd_rn(ss[r], __fmul_rn(v[r][j], v[r][j]));
      }
      block_reduce<false>(ss, nrows, red);
#pragma unroll
      for (int r = 0; r < kLocalRows; ++r) {
        rr[r] = 1.f / sqrtf(ss[r] / (float)n + eps);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = threadIdx.x + j * kThreads;
          if (i < n) v[r][j] = __fmul_rn(__fmul_rn(v[r][j], rr[r]), __ldg(gain + i));
        }
      }
    }
    float mx[kLocalRows], sm[kLocalRows];
#pragma unroll
    for (int r = 0; r < kLocalRows; ++r) {
      mx[r] = 0.f;
      sm[r] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (threadIdx.x + j * kThreads < n) {
          mx[r] = fmaxf(mx[r], fabsf(v[r][j]));
          sm[r] = __fadd_rn(sm[r], v[r][j]);
        }
      }
    }
    block_reduce<true>(mx, nrows, red);
    block_reduce<false>(sm, nrows, red);
#pragma unroll
    for (int r = 0; r < kLocalRows; ++r) {
      if (r < nrows) {
        const float amax = fmaxf(mx[r], 1e-6f);
        const float xs = 127.f / amax;  // a true division, as in JAX
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = threadIdx.x + j * kThreads;
          if (i < n)
            dst[(size_t)r * dst_stride + i] =
                (int8_t)(int)fminf(fmaxf(rintf(__fmul_rn(v[r][j], xs)), -127.f), 127.f);
        }
        if (threadIdx.x == 0) aux[r] = make_float2(__fmul_rn(amax, kInv127), sm[r]);
      }
    }
    __syncthreads();
    return;
  }
  float rr[kLocalRows];
  if (gain != nullptr) {
    float ss[kLocalRows];
#pragma unroll
    for (int r = 0; r < kLocalRows; ++r) {
      ss[r] = 0.f;
      if (r < nrows) {
        const float* p = rowp[r];
#pragma unroll 4
        for (int i = threadIdx.x; i < n; i += kThreads) {
          const float t = p[i];
          ss[r] = __fadd_rn(ss[r], __fmul_rn(t, t));
        }
      }
    }
    block_reduce<false>(ss, nrows, red);
#pragma unroll
    for (int r = 0; r < kLocalRows; ++r) rr[r] = 1.f / sqrtf(ss[r] / (float)n + eps);
  }
  float mx[kLocalRows], sm[kLocalRows];
#pragma unroll
  for (int r = 0; r < kLocalRows; ++r) {
    mx[r] = 0.f;
    sm[r] = 0.f;
    if (r < nrows) {
      const float* p = rowp[r];
#pragma unroll 4
      for (int i = threadIdx.x; i < n; i += kThreads) {
        float h = p[i];
        if (gain != nullptr) h = __fmul_rn(__fmul_rn(h, rr[r]), __ldg(gain + i));
        mx[r] = fmaxf(mx[r], fabsf(h));
        sm[r] = __fadd_rn(sm[r], h);
      }
    }
  }
  block_reduce<true>(mx, nrows, red);
  block_reduce<false>(sm, nrows, red);
  for (int r = 0; r < nrows; ++r) {
    float amax = 0.f, sum = 0.f, rs = 0.f;
#pragma unroll
    for (int k = 0; k < kLocalRows; ++k)
      if (k == r) {
        amax = fmaxf(mx[k], 1e-6f);
        sum = sm[k];
        rs = gain != nullptr ? rr[k] : 0.f;
      }
    const float xs = 127.f / amax;  // a true division, as in JAX
    const float* p = rowp[r];
    int8_t* q = dst + (size_t)r * dst_stride;
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += kThreads) {
      float h = p[i];
      if (gain != nullptr) h = __fmul_rn(__fmul_rn(h, rs), __ldg(gain + i));
      const float c = fminf(fmaxf(rintf(__fmul_rn(h, xs)), -127.f), 127.f);
      q[i] = (int8_t)(int)c;
    }
    if (threadIdx.x == 0) aux[r] = make_float2(__fmul_rn(amax, kInv127), sum);
  }
  __syncthreads();
}

// Bring the 64-byte run of 16 floats at p (64-byte aligned) into L1, for an
// epilogue that reads it after the tile's units.
__device__ __forceinline__ void prefetch_l1(const float* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
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

// The token of row `row` from the head phase's per-block partials, by one
// warp; every lane returns it.
__device__ __noinline__ int warp_pick(const int2* part, int rows, int row) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int g = threadIdx.x & 31; g < (int)gridDim.x; g += 32) {
    const int2 e = part[(size_t)g * rows + row];
    take_better(__int_as_float(e.x), e.y, bv, bi);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    take_better(__shfl_xor_sync(0xffffffffu, bv, off),
                __shfl_xor_sync(0xffffffffu, bi, off), bv, bi);
  return bi;
}

// Attention of head h of row `row` over slots 0..s, by one warp, into
// out[0..hd). Lane j scores slot j: 32 chains q[c + 32i] * k[c + 32i] and
// their butterfly, in the order of a warp's lane sum; then the softmax and
// P.V, each lane owning 4 consecutive dimensions. hd % 4 == 0.
__device__ __noinline__ void attend(const float* q, const float* kc, const float* vc, int s,
                                    int row, int h, int hd, int B, int heads, int n_kv,
                                    float scale, float* out) {
  const int lane = threadIdx.x & 31;
  const int attn = heads * hd, kvd = n_kv * hd, g = h / (heads / n_kv);
  const float* qv = q + (size_t)row * attn + (size_t)h * hd;
  float mine = -INFINITY;
  if (lane <= s) {
    const float* kv = kc + ((size_t)lane * B + row) * kvd + (size_t)g * hd;
    float ch[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) ch[c] = 0.f;
    for (int i = 0; i < hd; i += 32) {
      if (i + 32 <= hd) {
#pragma unroll
        for (int c4 = 0; c4 < 8; ++c4) {
          const float4 qa = *reinterpret_cast<const float4*>(qv + i + 4 * c4);
          const float4 ka = *reinterpret_cast<const float4*>(kv + i + 4 * c4);
          ch[4 * c4] = __fadd_rn(ch[4 * c4], __fmul_rn(qa.x, ka.x));
          ch[4 * c4 + 1] = __fadd_rn(ch[4 * c4 + 1], __fmul_rn(qa.y, ka.y));
          ch[4 * c4 + 2] = __fadd_rn(ch[4 * c4 + 2], __fmul_rn(qa.z, ka.z));
          ch[4 * c4 + 3] = __fadd_rn(ch[4 * c4 + 3], __fmul_rn(qa.w, ka.w));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 32; ++c)
          if (i + c < hd) ch[c] = __fadd_rn(ch[c], __fmul_rn(qv[i + c], kv[i + c]));
      }
    }
    // the butterfly, as lane 0 of a warp_sum adds: x[c] + x[c + off]
#pragma unroll
    for (int c = 0; c < 16; ++c) ch[c] = __fadd_rn(ch[c], ch[c + 16]);
#pragma unroll
    for (int c = 0; c < 8; ++c) ch[c] = __fadd_rn(ch[c], ch[c + 8]);
#pragma unroll
    for (int c = 0; c < 4; ++c) ch[c] = __fadd_rn(ch[c], ch[c + 4]);
#pragma unroll
    for (int c = 0; c < 2; ++c) ch[c] = __fadd_rn(ch[c], ch[c + 2]);
    ch[0] = __fadd_rn(ch[0], ch[1]);
    mine = __fmul_rn(ch[0], scale);
  }
  const float m = warp_max(mine);
  const float ex = lane <= s ? expf(mine - m) : 0.f;
  const float pj = ex / warp_sum(ex);
  for (int base = 0; base < hd; base += 128) {
    const int e = base + 4 * lane;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j <= s; ++j) {
      const float p = __shfl_sync(0xffffffffu, pj, j);
      if (e < hd) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vc + ((size_t)j * B + row) * kvd + (size_t)g * hd + e);
        acc.x = __fadd_rn(acc.x, __fmul_rn(p, vv.x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(p, vv.y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(p, vv.z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(p, vv.w));
      }
    }
    if (e < hd) *reinterpret_cast<float4*>(out + e) = acc;
  }
}

// The block's counters (its shared state sits at the kSm* offsets).
struct Ctx {
  int u;            // streamed units consumed
};

template <typename T>
__device__ __forceinline__ T* sm_at(int off) {
  extern __shared__ __align__(128) unsigned char smem[];
  return reinterpret_cast<T*>(smem + off);
}
#define SM_FULL sm_at<uint64_t>(kSmBars)
#define SM_EMPTY (sm_at<uint64_t>(kSmBars) + kRing)
#define SM_RED sm_at<float>(kSmRed)
#define SM_AUX sm_at<float2>(kSmAux)
#define SM_TOK sm_at<int>(kSmTok)
#define SM_BEST_V sm_at<float>(kSmBest)
#define SM_BEST_I sm_at<int>(kSmBest + kWarps * kMaxRows * 4)
#define SM_ACC sm_at<int>(kSmAcc)
#define SM_PART sm_at<int>(kSmPart)
#define SM_ROWP sm_at<const float*>(kSmRowp)
#define SM_TAB sm_at<UnitSlot>(kSmTab)
#define SM_PROD sm_at<Producer>(kSmProd)
#define SM_XQ sm_at<int8_t>(kSmXq)
#define SM_RING sm_at<int8_t>(kSmRing)

// Where a matvec reads its activation codes: the block's own rows (local) or
// chunks staged from the spread phase's codes in device memory.
struct XSrc {
  bool local;
  int stride;
  const int8_t* g;  // spread: (B, in) codes in device memory
  int in;
};

// One unit's tensor-core products into acc (a 16-channel tile half, the
// rows as n8 tiles): this warp's k-steps first, first + step, ... of the
// unit's nks. With one n8 tile, four independent accumulators keep four
// k-steps in flight. Integer sums: exact in any order.
template <int kNT>
__device__ __forceinline__ void unit_mma(int (&acc)[kNT][4], const int8_t* wp, const int8_t* xp,
                                         int xstride, int nks, int first, int step, int NT) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  if (kNT == 1) {
    int part[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) part[q][0] = part[q][1] = part[q][2] = part[q][3] = 0;
    for (int ks0 = first; ks0 < nks; ks0 += 4 * step) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ks = ks0 + q * step;
        if (ks < nks) {
          uint32_t af[4];
          load_a_frag(af, wp + ks * 32, kUnitStride, lane);
          const int8_t* bp = xp + g * xstride + ks * 32 + tg * 4;
          mma_s8(part[q], af, *reinterpret_cast<const uint32_t*>(bp),
                 *reinterpret_cast<const uint32_t*>(bp + 16));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[0][i] += (part[0][i] + part[1][i]) + (part[2][i] + part[3][i]);
  } else {
    for (int ks = first; ks < nks; ks += step) {
      uint32_t af[4];
      load_a_frag(af, wp + ks * 32, kUnitStride, lane);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt < NT) {
          const int8_t* bp = xp + (nt * 8 + g) * xstride + ks * 32 + tg * 4;
          mma_s8(acc[nt], af, *reinterpret_cast<const uint32_t*>(bp),
                 *reinterpret_cast<const uint32_t*>(bp + 16));
        }
      }
    }
  }
}

// The activation codes of k-bytes k0..k0+kb of every row into SM_XQ
// (rows at kUnitStride), from the spread phase's codes in device memory.
__device__ __forceinline__ void stage_codes(const XSrc& xs, int rows, int k0, int kb) {
  __syncthreads();
  const int per_row = kb >> 4;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int n = i / per_row, qd = i % per_row;
    cp_async16(SM_XQ + n * kUnitStride + qd * 16, xs.g + (size_t)n * xs.in + k0 + qd * 16,
               true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// This block's tiles of matrix m, each through pre(tile) (prefetches for
// the epilogue), its units' tensor-core products, and epi(tile, acc) run
// by one warp on the tile's int32 sums in the mma C layout: acc(half, nt, i)
// is channel tile * 16 + g + (i >> 1) * 8 of half `half` and row nt * 8 +
// 2 * tg + (i & 1) (g = lane / 4, tg = lane % 4), for the row tiles nt0,
// nt0 + nt_step, ... below NT. Warp 0 refills each ring
// slot, as soon as the consumers are done with it, with the unit kRing
// later. One n8 row tile (B <= 8) and rows of one unit (IN <= kUnitK):
// consumer warp w owns tiles w - 1, w + 6, ... whole, with no barrier inside
// the phase. Otherwise the consumer warps split each unit's k-steps, the
// sums meet in shared memory, and warp 1 runs the epilogue.
template <int kNT, typename Pre, typename Epi>
__device__ __forceinline__ void matvec(const Frame& a, Ctx& c, const Mat& m, const XSrc xs,
                                       Pre pre, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int B = a.rows, NT = (B + 7) >> 3;
  const int n_tiles = my_tiles(m.tiles);
  const int n_units = n_tiles * m.halves * m.upt;
  const int u0 = c.u;  // ring sequence number of this matrix's first unit
  c.u += n_units;
  if (n_tiles == 0) return;
  auto wait_unit = [&](int idx) -> const int8_t* {
    const int useq = u0 + idx;
    // issued units are at most one ring turn ahead: then the slot's parity
    // names this unit
    const volatile int* issued = &SM_PROD->issued;
    while (*issued <= useq) {
    }
    mbar_wait(SM_FULL + useq % kRing, (uint32_t)(useq / kRing) & 1u);
    return SM_RING + (useq % kRing) * kUnitBytes;
  };
  // the slot's "empty" barrier waits for kWarps - 1 arrivals: one from each
  // consumer warp when they split a unit, all from the owner otherwise
  auto release_unit = [&](int idx, uint32_t count) {
    __syncwarp();
    if (lane == 0) mbar_arrive(SM_EMPTY + (u0 + idx) % kRing, count);
  };
  auto produce = [&](int idx) {  // warp 0, after the consumers free unit idx
    const int useq = u0 + idx;
    mbar_wait(SM_EMPTY + useq % kRing, (uint32_t)(useq / kRing) & 1u);
    producer_issue(SM_TAB, SM_PROD, SM_RING, SM_FULL, useq % kRing);
  };

  if (kNT == 1 && m.upt == 1) {
    if (!xs.local) stage_codes(xs, B, 0, m.in);
    if (warp == 0) {
      for (int idx = 0; idx < n_units; ++idx) produce(idx);
      return;
    }
    for (int tl = warp - 1; tl < n_tiles; tl += kWarps - 1) {
      const int t = blockIdx.x + tl * (int)gridDim.x;
      pre(t);
      int acc[2][kNT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) acc[h][nt][0] = acc[h][nt][1] = acc[h][nt][2] = acc[h][nt][3] = 0;
      for (int half = 0; half < m.halves; ++half) {
        const int idx = tl * m.halves + half;
        const int8_t* wp = wait_unit(idx);
        unit_mma<kNT>(acc[half], wp, SM_XQ, xs.stride, m.in >> 5, 0, 1, NT);
        release_unit(idx, kWarps - 1);
      }
      epi(t, [&](int h, int nt, int i) { return acc[h][kNT == 1 ? 0 : nt][i]; }, 0, 1);
    }
    return;
  }

  int idx = 0, loaded = -1;
  for (int tl = 0; tl < n_tiles; ++tl) {
    const int t = blockIdx.x + tl * (int)gridDim.x;
    pre(t);
    for (int half = 0; half < m.halves; ++half) {
      int acc[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
      for (int ci = 0; ci < m.upt; ++ci, ++idx) {
        const int k0 = ci * kUnitK, kb = min(kUnitK, m.in - k0);
        const int8_t* xp = SM_XQ + k0;
        if (!xs.local) {
          if (loaded != k0) stage_codes(xs, B, k0, kb);
          loaded = k0;
          xp = SM_XQ;
        }
        if (warp == 0) {
          produce(idx);
        } else {
          const int8_t* wp = wait_unit(idx);
          unit_mma<kNT>(acc, wp, xp, xs.stride, kb >> 5, warp - 1, kWarps - 1, NT);
          release_unit(idx, 1);
        }
      }
      if (warp > 0) {
        if (kNT == 1) {
          // this warp's partials, summed over the warps below
          int* part = SM_PART + (half * (kWarps - 1) + warp - 1) * kLocalRows * 16;
#pragma unroll
          for (int i = 0; i < 4; ++i) part[(tg * 2 + (i & 1)) * 16 + g + (i >> 1) * 8] = acc[0][i];
        } else {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt < NT) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int n = nt * 8 + tg * 2 + (i & 1), ch = g + (i >> 1) * 8;
                if (n < B) atomicAdd(SM_ACC + (half * kMaxRows + n) * 16 + ch, acc[nt][i]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
    if (kNT == 1) {
      for (int i = threadIdx.x; i < m.halves * B * 16; i += kThreads) {
        const int half = i / (B * 16), nch = i % (B * 16);
        const int* part = SM_PART + half * (kWarps - 1) * kLocalRows * 16 + nch;
        int sum = 0;
#pragma unroll
        for (int w = 0; w < kWarps - 1; ++w) sum += part[w * kLocalRows * 16];
        SM_ACC[half * kMaxRows * 16 + nch] = sum;
      }
      __syncthreads();
    }
    auto shared_acc = [&](int h, int nt, int i) {
      const int n = nt * 8 + tg * 2 + (i & 1), ch = g + (i >> 1) * 8;
      return h < m.halves && nt < NT && n < B ? SM_ACC[(h * kMaxRows + n) * 16 + ch] : 0;
    };
    if (kNT == 1) {
      if (warp == 1) epi(t, shared_acc, 0, 1);
    } else {
      epi(t, shared_acc, warp, kWarps);  // warp w: row tile w
    }
    __syncthreads();
    if (kNT > 1) {  // the next tile's atomics start from zero
      for (int i = threadIdx.x; i < m.halves * kMaxRows * 16; i += kThreads) SM_ACC[i] = 0;
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void stamp_prologue(const Frame& a, int n) {
  if (a.stamps != nullptr && n < a.stamp_cap && threadIdx.x == 0)
    atomicMax(a.stamps + 4 * n + 1, global_ns());
}

// The end of phase n: with stamps set, every block's arrival raises record
// n's [2] to the latest arrival, and block 0 writes the release time into
// record n+1's [0] and the kind (phase | prologue << 8) into record n's [3].
__device__ __forceinline__ void phase_end(const Frame& a, cg::grid_group& grid, int kind,
                                          int& n) {
  const bool rec = a.stamps != nullptr && n + 1 < a.stamp_cap;
  if (rec && threadIdx.x == 0) {
    __threadfence();
    atomicMax(a.stamps + 4 * n + 2, global_ns());
  }
  grid.sync();
  if (rec && blockIdx.x == 0 && threadIdx.x == 0) {
    a.stamps[4 * (n + 1)] = global_ns();
    a.stamps[4 * n + 3] = (unsigned long long)kind;
  }
  ++n;
}

// Every block prepares rows 0..B-1 (rows at base + r * stride) into its own
// codes and aux.
__device__ __forceinline__ void local_prep(const Frame& a, Ctx& c, const float* base,
                                           int stride, int n, const float* gain) {
  if (threadIdx.x < a.rows) SM_ROWP[threadIdx.x] = base + (size_t)threadIdx.x * stride;
  prep_rows(SM_ROWP, a.rows, n, gain, a.eps, SM_XQ, n + 16, SM_AUX, SM_RED);
}

// A spread per-row phase: row r by block r % grid, codes to a.xq (rows at
// n), aux to a.aux.
__device__ __forceinline__ void spread_prep(const Frame& a, Ctx& c, const float* base,
                                            int stride, int n, const float* gain) {
  for (int row = blockIdx.x; row < a.rows; row += gridDim.x) {
    if (threadIdx.x == 0) SM_ROWP[0] = base + (size_t)row * stride;
    prep_rows(SM_ROWP, 1, n, gain, a.eps, a.xq + (size_t)row * n, n, a.aux + row, SM_RED);
  }
}

__device__ __forceinline__ void load_aux(const Frame& a, const Ctx& c) {
  for (int r = threadIdx.x; r < a.rows; r += kThreads) SM_AUX[r] = a.aux[r];
  __syncthreads();
}

// kNT: the most n8 row tiles a call has (1 for B <= 8, else 8).
template <int kNT>
__global__ void __launch_bounds__(kThreads, 1)
resident_frame_kernel(const __grid_constant__ Frame a) {
  cg::grid_group grid = cg::this_grid();
  Ctx c{0};

  const int B = a.rows, d = a.d, f = a.f, hd = a.hd, L = a.n_layers;
  const int attn = a.heads * hd, kvd = a.n_kv * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3, NT = (B + 7) >> 3;  // mma C layout
  // per-row work in every block while rows x width <= kLocalElems
  const bool local_d = B <= kLocalRows && B * d <= kLocalElems;
  const bool local_o = B <= kLocalRows && B * attn <= kLocalElems;
  const bool local_f = B <= kLocalRows && B * f <= kLocalElems;
  int n_ph = 0;

  for (int i = threadIdx.x; i < 2 * kMaxRows * 16; i += kThreads) SM_ACC[i] = 0;
  if (warp == 0) {
    if (lane == 0) {
      if (a.stamps != nullptr && blockIdx.x == 0) a.stamps[0] = global_ns();
      for (int i = 0; i < kRing; ++i) {
        mbar_init(SM_FULL + i, 1);
        mbar_init(SM_EMPTY + i, kWarps - 1);
      }
      mbar_fence_init();
    }
    __syncwarp();
    // the slot table, then the first kRing units
    for (int i = lane; i <= 4 * L; i += 32) {
      const Mat m = slot_mat(a, 1, i);
      UnitSlot t;
      t.w = m.w;
      t.step_stride = i == 4 * L ? (long long)a.v_pad * a.d : 0;
      t.in = m.in;
      t.upt = m.upt;
      t.halves = m.halves;
      t.half_rows = m.half_rows;
      t.units = block_units(m);
      SM_TAB[i] = t;
    }
    __syncwarp();
    Producer p{0, 0, 0, SM_TAB[0].units, 0, 0, 0, 0, a.n_cb, 4 * L + 1, 0};
    producer_seek(SM_TAB, p);
    if (lane == 0) *SM_PROD = p;
    __syncwarp();
    for (int i = 0; i < kRing; ++i) producer_issue(SM_TAB, SM_PROD, SM_RING, SM_FULL, i);
  }
  __syncthreads();

  const XSrc xs_d{local_d, local_d ? d + 16 : kUnitStride, a.xq, d};
  const XSrc xs_o{local_o, local_o ? attn + 16 : kUnitStride, a.xq, attn};
  const XSrc xs_f{local_f, local_f ? f + 16 : kUnitStride, a.xq, f};

  for (int s = 0; s < a.n_cb; ++s) {
    const float* cs = a.rope_cs + (size_t)s * 3 * hd;
    for (int l = 0; l < L; ++l) {
      const Layer ly = a.layer[l];
      float* kc = a.kc + (size_t)l * a.n_cb * B * kvd;
      float* vc = a.vc + (size_t)l * a.n_cb * B * kvd;
      const int qkv_out = attn + 2 * kvd;

      // ---- qkv: h = rms(x) * ln1 (at layer 0 the step's input row) ----
      int pro = kPrep;
      if (l == 0) {
        pro = kPick;
        // the pick of step s-1 and this step's input rows
        if (local_d) {
          if (s >= 2 && warp < B) {
            const int tok = warp_pick(a.part, B, warp);
            if (lane == 0) {
              SM_TOK[warp] = tok;
              if (blockIdx.x == 0) a.tokens[(size_t)(s - 1) * B + warp] = tok;
            }
          }
          __syncthreads();
          auto src = [&](int r) {
            if (s < 2) return a.proj01 + ((size_t)s * B + r) * d;
            const int t = min(max(SM_TOK[r], 0), a.v - 1);
            return a.embed + ((size_t)(s - 2) * a.v + t) * d;
          };
          // x channels of this block's o / down tiles start as the input row
          for (int t = blockIdx.x; t < d / 16; t += gridDim.x)
            for (int i = threadIdx.x; i < B * 16; i += kThreads) {
              const int r = i >> 4, ch = t * 16 + (i & 15);
              a.x[(size_t)r * d + ch] = src(r)[ch];
            }
          if (threadIdx.x < B) SM_ROWP[threadIdx.x] = src(threadIdx.x);
          prep_rows(SM_ROWP, B, d, ly.ln1, a.eps, SM_XQ, d + 16, SM_AUX, SM_RED);
        } else {
          for (int row = blockIdx.x; row < B; row += gridDim.x) {
            const float* src = a.proj01 + ((size_t)min(s, 1) * B + row) * d;
            if (s >= 2) {
              if (warp == 0) {
                const int tok = warp_pick(a.part, B, row);
                if (lane == 0) {
                  SM_TOK[0] = tok;
                  a.tokens[(size_t)(s - 1) * B + row] = tok;
                }
              }
              __syncthreads();
              const int t = min(max(SM_TOK[0], 0), a.v - 1);
              src = a.embed + ((size_t)(s - 2) * a.v + t) * d;
            }
            for (int i = threadIdx.x; i < d; i += kThreads) a.x[(size_t)row * d + i] = src[i];
            if (threadIdx.x == 0) SM_ROWP[0] = src;
            prep_rows(SM_ROWP, 1, d, ly.ln1, a.eps, a.xq + (size_t)row * d, d, a.aux + row,
                      SM_RED);
          }
          phase_end(a, grid, kPick, n_ph);
          pro = -1;
        }
      } else if (local_d) {
        local_prep(a, c, a.x, d, d, ly.ln1);
      } else {
        spread_prep(a, c, a.x, d, d, ly.ln1);
        phase_end(a, grid, kPrep, n_ph);
        pro = -1;
      }
      if (local_d) stamp_prologue(a, n_ph);
      else load_aux(a, c);
      matvec<kNT>(a, c, slot_mat(a, s, 4 * l), xs_d, [&](int t) {
        if (lane < 2) prefetch_l1(ly.qkv_sz + lane * qkv_out + t * 16);
      }, [&](int t, auto acc, int nt0, int nt_step) {
        for (int nt = nt0; nt < NT; nt += nt_step) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = nt * 8 + tg * 2 + (i & 1), o = t * 16 + g + (i >> 1) * 8;
            const float y = fixup(acc(0, nt, i), ly.qkv_sz[o], ly.qkv_sz[qkv_out + o],
                                  SM_AUX[min(n, B - 1)]);
            const float yp = __shfl_xor_sync(0xffffffffu, y, 4);  // channel o ^ 1
            if (n >= B) continue;
            const bool even = (o & 1) == 0;
            const float y0 = even ? y : yp, y1 = even ? yp : y;
            const int oe = o & ~1;
            if (oe < attn + kvd) {
              const int e = oe % hd;
              const float co = cs[e], ns = cs[hd + e], sn = cs[2 * hd + e + 1];
              const float r = even ? __fadd_rn(__fmul_rn(y0, co), __fmul_rn(y1, ns))
                                   : __fadd_rn(__fmul_rn(y1, co), __fmul_rn(y0, sn));
              float* dst = oe < attn ? a.q + (size_t)n * attn + o
                                     : kc + ((size_t)s * B + n) * kvd + (o - attn);
              *dst = r;
            } else {
              vc[((size_t)s * B + n) * kvd + (o - attn - kvd)] = y;
            }
          }
        }
      });
      phase_end(a, grid, kQkv | (pro >= 0 ? pro << 8 : 0), n_ph);

      // ---- attention: one warp per (row, head) over the grid ----
      {
        for (int p = blockIdx.x + (int)gridDim.x * warp; p < B * a.heads;
             p += (int)gridDim.x * kWarps) {
          const int row = p / a.heads, h = p % a.heads;
          attend(a.q, kc, vc, s, row, h, hd, B, a.heads, a.n_kv, a.scale,
                 a.ao + (size_t)row * attn + (size_t)h * hd);
        }
        phase_end(a, grid, kAttn, n_ph);
      }

      // ---- o: x += o(attention) ----
      if (local_o) {
        local_prep(a, c, a.ao, attn, attn, nullptr);
        stamp_prologue(a, n_ph);
        pro = kPrep;
      } else {
        spread_prep(a, c, a.ao, attn, attn, nullptr);
        phase_end(a, grid, kPrep, n_ph);
        load_aux(a, c);
        pro = -1;
      }
      matvec<kNT>(a, c, slot_mat(a, s, 4 * l + 1), xs_o, [&](int t) {
        if (lane < 2) prefetch_l1(ly.o_sz + lane * d + t * 16);
      }, [&](int t, auto acc, int nt0, int nt_step) {
        for (int nt = nt0; nt < NT; nt += nt_step) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = nt * 8 + tg * 2 + (i & 1), ch = t * 16 + g + (i >> 1) * 8;
            if (n < B) {
              float* xr = a.x + (size_t)n * d + ch;
              *xr = __fadd_rn(*xr, fixup(acc(0, nt, i), ly.o_sz[ch], ly.o_sz[d + ch], SM_AUX[n]));
            }
          }
        }
      });
      phase_end(a, grid, kO | (pro >= 0 ? pro << 8 : 0), n_ph);

      // ---- gate-up: act = silu(gate) * up ----
      if (local_d) {
        local_prep(a, c, a.x, d, d, ly.ln2);
        stamp_prologue(a, n_ph);
        pro = kPrep;
      } else {
        spread_prep(a, c, a.x, d, d, ly.ln2);
        phase_end(a, grid, kPrep, n_ph);
        load_aux(a, c);
        pro = -1;
      }
      matvec<kNT>(a, c, slot_mat(a, s, 4 * l + 2), xs_d, [&](int t) {
        if (lane < 4) prefetch_l1(ly.gu_sz + lane * f + t * 16);
      }, [&](int t, auto acc, int nt0, int nt_step) {
        for (int nt = nt0; nt < NT; nt += nt_step) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = nt * 8 + tg * 2 + (i & 1), j = t * 16 + g + (i >> 1) * 8;
            if (n < B) {
              const float2 ax = SM_AUX[n];
              const float gt = fixup(acc(0, nt, i), ly.gu_sz[j], ly.gu_sz[2 * f + j], ax);
              const float up = fixup(acc(1, nt, i), ly.gu_sz[f + j], ly.gu_sz[3 * f + j], ax);
              const float sig = 1.f / (1.f + expf(-gt));
              a.act[(size_t)n * f + j] = __fmul_rn(__fmul_rn(gt, sig), up);
            }
          }
        }
      });
      phase_end(a, grid, kGu | (pro >= 0 ? pro << 8 : 0), n_ph);

      // ---- down: x += down(act) ----
      if (local_f) {
        local_prep(a, c, a.act, f, f, nullptr);
        stamp_prologue(a, n_ph);
        pro = kPrep;
      } else {
        spread_prep(a, c, a.act, f, f, nullptr);
        phase_end(a, grid, kPrep, n_ph);
        load_aux(a, c);
        pro = -1;
      }
      matvec<kNT>(a, c, slot_mat(a, s, 4 * l + 3), xs_f, [&](int t) {
        if (lane < 2) prefetch_l1(ly.dn_sz + lane * d + t * 16);
      }, [&](int t, auto acc, int nt0, int nt_step) {
        for (int nt = nt0; nt < NT; nt += nt_step) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = nt * 8 + tg * 2 + (i & 1), ch = t * 16 + g + (i >> 1) * 8;
            if (n < B) {
              float* xr = a.x + (size_t)n * d + ch;
              *xr = __fadd_rn(*xr, fixup(acc(0, nt, i), ly.dn_sz[ch], ly.dn_sz[d + ch], SM_AUX[n]));
            }
          }
        }
      });
      phase_end(a, grid, kDn | (pro >= 0 ? pro << 8 : 0), n_ph);
    }
    if (s == 0) continue;

    // ---- the head of codebook s: final rms, codes, each block's best ----
    int pro = kPrep;
    if (local_d) {
      local_prep(a, c, a.x, d, d, a.norm);
      stamp_prologue(a, n_ph);
    } else {
      spread_prep(a, c, a.x, d, d, a.norm);
      phase_end(a, grid, kPrep, n_ph);
      load_aux(a, c);
      pro = -1;
    }
    for (int r = threadIdx.x; r < kWarps * kMaxRows; r += kThreads) {
      SM_BEST_V[r] = -INFINITY;
      SM_BEST_I[r] = INT_MAX;
    }
    __syncthreads();
    const float* hs = a.head_s + (size_t)(s - 1) * a.v_pad;
    matvec<kNT>(a, c, slot_mat(a, s, 4 * L), xs_d, [&](int t) {
      if (lane == 0) prefetch_l1(hs + t * 16);
    }, [&](int t, auto acc, int nt0, int nt_step) {
      // each warp keeps its best (logit, column) per row over its columns
      float* bv = SM_BEST_V + warp * kMaxRows;
      int* bi = SM_BEST_I + warp * kMaxRows;
      for (int nt = nt0; nt < NT; nt += nt_step) {
        float lv[4];
        int li[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = nt * 8 + tg * 2 + (i & 1), col = t * 16 + g + (i >> 1) * 8;
          lv[i] = -INFINITY;
          li[i] = INT_MAX;
          if (n < B) {
            float lg = kNeg;
            if (col < a.v) {
              lg = __fmul_rn(__fmul_rn((float)acc(0, nt, i), hs[col]), SM_AUX[n].x);
              if (a.logits != nullptr) a.logits[((size_t)(s - 1) * B + n) * a.v + col] = lg;
              if (a.inv_t > 0.f) {
                const unsigned bits = philox((unsigned)__ldg(a.seed), col, n, s);
                const float u = (float)(bits & 0x7FFFFFu) * (1.f / 8388608.f);
                const float gn = -logf(-logf(u + 1e-10f) + 1e-10f);
                lg = __fadd_rn(__fmul_rn(lg, a.inv_t), gn);
              }
            }
            lv[i] = lg;
            li[i] = col;
          }
        }
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          // row nt * 8 + 2 tg + b: its two channel halves, then the 8 lanes g
          float bvv = lv[b];
          int bii = li[b];
          take_better(lv[b + 2], li[b + 2], bvv, bii);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            take_better(__shfl_xor_sync(0xffffffffu, bvv, off),
                        __shfl_xor_sync(0xffffffffu, bii, off), bvv, bii);
          const int n = nt * 8 + tg * 2 + b;
          if (g == 0 && n < B) take_better(bvv, bii, bv[n], bi[n]);
        }
      }
    });
    __syncthreads();
    for (int r = threadIdx.x; r < B; r += kThreads) {
      float bvv = -INFINITY;
      int bii = INT_MAX;
      for (int w = 0; w < kWarps; ++w)
        take_better(SM_BEST_V[w * kMaxRows + r], SM_BEST_I[w * kMaxRows + r], bvv, bii);
      a.part[(size_t)blockIdx.x * B + r] = make_int2(__float_as_int(bvv), bii);
    }
    phase_end(a, grid, kHead | (pro >= 0 ? pro << 8 : 0), n_ph);
  }

  // the last step's pick, and codebook 0's row of zeros
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    if (warp == 0) {
      const int tok = warp_pick(a.part, B, row);
      if (lane == 0) {
        a.tokens[(size_t)(a.n_cb - 1) * B + row] = tok;
        a.tokens[row] = 0;
      }
    }
  }
  if (a.stamps != nullptr && n_ph < a.stamp_cap) {
    __syncthreads();
    if (threadIdx.x == 0) {
      if (blockIdx.x == 0) a.stamps[4 * n_ph + 3] = kEnd;
      atomicMax(a.stamps + 4 * n_ph + 2, global_ns());
    }
  }
}

}  // namespace

// layer_ptrs: n_layers * 10 device pointers, per layer [ln1, qkv codes, qkv
// scale/bias rows, o codes, o rows, ln2, gate-up codes, gate-up rows, down
// codes, down rows]. The other tables, the scratch buffers and the tokens as
// in `Frame`; part holds grid * rows int2. inv_t = 0 picks greedily. logits,
// when not null, receives the (n_cb-1, rows, v) logits before noise; stamps,
// when not null, stamp_cap phase records; seed: one int32 in device memory,
// read at T > 0; grid is one block per SM. Returns
// the launch's error code, 0 on success.
extern "C" int csm_resident_frame(
    const void* const* layer_ptrs, int n_layers, const void* norm,
    const void* rope_cs, const void* head_q, const void* head_s, const void* embed,
    const void* proj01, void* x, void* q, void* ao, void* act, void* xq, void* aux, void* kc,
    void* vc, void* part, void* tokens, void* logits, int rows, int heads, int n_kv, int hd,
    int d, int f, int n_cb, int v, int v_pad, float eps, float scale, float inv_t,
    const void* seed, int grid, void* stamps, int stamp_cap, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || rows < 1 || rows > kMaxRows || n_cb > 32 ||
      grid < 1 || seed == nullptr)
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
  const size_t smem = kSmTotal;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin || grid > sms)
    return (int)cudaErrorInvalidValue;
  fr.norm = static_cast<const float*>(norm);
  fr.rope_cs = static_cast<const float*>(rope_cs);
  fr.head_q = static_cast<const int8_t*>(head_q);
  fr.head_s = static_cast<const float*>(head_s);
  fr.embed = static_cast<const float*>(embed);
  fr.proj01 = static_cast<const float*>(proj01);
  fr.x = static_cast<float*>(x);
  fr.q = static_cast<float*>(q);
  fr.ao = static_cast<float*>(ao);
  fr.act = static_cast<float*>(act);
  fr.xq = static_cast<int8_t*>(xq);
  fr.aux = static_cast<float2*>(aux);
  fr.kc = static_cast<float*>(kc);
  fr.vc = static_cast<float*>(vc);
  fr.part = static_cast<int2*>(part);
  fr.tokens = static_cast<int*>(tokens);
  fr.logits = static_cast<float*>(logits);
  fr.stamps = static_cast<unsigned long long*>(stamps);
  fr.stamp_cap = stamp_cap;
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
  fr.seed = static_cast<const int*>(seed);

  auto* kernel = rows <= 8 ? resident_frame_kernel<1> : resident_frame_kernel<8>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&fr};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                  dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
