// Grouped-affine dequant matvec for Hopper (sm_90a): kernel 5 of the port.
//
// Replaces the TPU kernel `_pallas_quant_matvec` in csm_mlx_tpu/ops/quant.py
// (MLX `nn.quantize` parity): unsigned codes q with, per output row o and
// input group g of `group` columns, w[o,i] = s[o,g] * q[o,i] + z[o,g], and
//
//   out[b,o] = sum_i x[b,i] * w[o,i]        (fp32 accumulation, out in x's type)
//
// Codes are 8-bit, uint8 (OUT, IN), or 4-bit packed two to a byte, uint8
// (OUT, IN/2), column 2j in the low nibble of byte j. The group is any
// multiple of 16 that divides IN; any OUT; any number of rows.
//
// What bounds it on the H100: the bytes, at every B <= 64. On the 2048 ->
// 16384 gate-up at 4 bits, group 64: 21.0 MB of codes and fp32 scales and
// biases, 6.3 us at 3.35 TB/s. At B = 64 the 4.3 GFLOP take the tensor
// cores 4.3 us at their bf16 peak, fp32 FMAs 64 us.
//
// Two routes, by dtype and rows:
//
// CUDA-core route (`affine_matvec_kernel`): fp32 x at any B, and bf16 x at
// B <= kCoreRows. Each warp owns kCoreOutRows output rows, each lane takes
// 16 codes of a row at a time, dequantizes them in registers (as the plain
// version: __fmul_rn then __fadd_rn, no FMA contraction) and multiplies them
// into the fp32 accumulators of RB activation rows; rows past RB (grid.y)
// re-read the codes. A lane loads the codes, scales and biases of 1-4
// chunks before it sums any, in chunk order. The tensor cores would round
// an fp32 x; and at B <= 2 this route is the faster one: the tensor-core
// route's time there is its per-step latency (the nibble-to-bf16 work, a
// barrier a window, few warps an SM), not its bytes (PERF.md).
//
// Tensor-core route (`affine_mma_kernel`): bf16 x at B > kCoreRows.
// - Products on the tensor cores, the weights exact: mma.sync m16n8k16 bf16
//   with the codes as A (a warp owns a 16-row tile) and x as B (one n8 tile
//   per 8 activation rows). A code, 0..15 or 0..255, is exact in bf16 (4-bit:
//   the nibble ORed into 128.0's mantissa, minus 128; 8-bit: through fp32's
//   2^23 magic), so each product q * x is exact and the tensor core sums
//   them in fp32 into a per-group partial C. The scale and bias are applied
//   once per group, acc = fma(z, xs, fma(s, C, acc)), with xs the group's
//   sum of x: sum_i x_i (s q_i + z) in another order, never the dequantized
//   weight rounded to bf16.
// - xs on the tensor cores too: row 15 of every 16-row tile holds ones
//   (code 1, written once into each ring slot), so a tile carries 15 output
//   rows and its C row 15 is the group's sum of x in the same mma.
// - Where a group is a multiple of 32 columns, a lane's codes of two k16
//   steps are one contiguous 4- or 8-byte load (columns 8tq .. 8tq + 7 of
//   each 32), and its x of both one 16-byte load; else one load a step.
// - Codes read once for all rows <= 64: a block holds every activation row
//   of its chunk (64 a chunk, grid.z); x, the codes and the scales of the
//   groups that end in a window stream through a ring of 128- or 256-column
//   windows in shared memory by 16-byte cp.async (4-byte where a 4-bit
//   group is not a multiple of 32), ~100 KB a block.
// - At group 64 and B <= 16 a half window's two groups are summed side by
//   side, two independent mma chains, each in step order.
// - Enough warps on the small shapes: the plan (`make_plan`) splits IN on
//   group boundaries across the blocks of a thread-block cluster (up to 8)
//   where OUT has fewer than 4 tiles an SM; the partials meet in distributed
//   shared memory and are summed in rank order, no atomics. The plan
//   depends on (IN, OUT, group) only, never on B: each activation row is its
//   own mma column, so a row's output is bit-identical whatever B it is
//   launched with, within the route.

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

// --- CUDA-core route: fp32, and bf16 at <= kCoreRows rows ---------------------

constexpr int kCoreWarps = 4;    // warps per block
constexpr int kCoreOutRows = 2;  // output rows per warp
constexpr int kCoreCodes = 16;   // codes per lane step
// bf16 at up to this many rows takes the CUDA-core route, the faster one
// there (PERF.md)
constexpr int kCoreRows = 2;

// One lane's 16 codes of a row at chunk `chunk`: the raw bytes (the loads
// of several chunks are issued before any is used), then as floats.
template <int BITS>
struct RawCodes {
  using T = std::conditional_t<BITS == 8, uint4, uint2>;
};

template <int BITS>
__device__ __forceinline__ typename RawCodes<BITS>::T load_raw(const uint8_t* row, int chunk) {
  return __ldg(reinterpret_cast<const typename RawCodes<BITS>::T*>(row) + chunk);
}

template <int BITS>
__device__ __forceinline__ void codes_to_float(typename RawCodes<BITS>::T u,
                                               float (&q)[kCoreCodes]) {
  if constexpr (BITS == 8) {
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int k = 0; k < 4; ++k) q[4 * w + k] = (float)((words[w] >> (8 * k)) & 0xFFu);
  } else {
    const uint32_t words[2] = {u.x, u.y};
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t byte = (words[w] >> (8 * k)) & 0xFFu;
        q[8 * w + 2 * k] = (float)(byte & 0xFu);
        q[8 * w + 2 * k + 1] = (float)(byte >> 4);
      }
  }
}

// AHEAD: chunks a lane loads before it sums them, for more bytes in flight
// as far as the registers allow (run_core's choice was timed on the H100);
// the sums run in chunk order whatever AHEAD is.
template <typename T, int BITS, int RB, int AHEAD>
__global__ void __launch_bounds__(kCoreWarps * 32)
affine_matvec_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                     const float* __restrict__ s, const float* __restrict__ z,
                     T* __restrict__ out, int rows, int in_dim, int out_dim,
                     int group) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x * kCoreWarps + warp) * kCoreOutRows;
  const int r0 = blockIdx.y * RB;
  if (o0 >= out_dim) return;
  const int n_chunks = in_dim / kCoreCodes;
  const int chunks_per_group = group / kCoreCodes;
  const int n_groups = in_dim / group;
  const size_t row_bytes = BITS == 8 ? (size_t)in_dim : (size_t)in_dim / 2;

  float acc[kCoreOutRows][RB];
#pragma unroll
  for (int c = 0; c < kCoreOutRows; ++c)
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[c][r] = 0.f;

  const uint8_t* wrow[kCoreOutRows];
  const float* srow[kCoreOutRows];
  const float* zrow[kCoreOutRows];
#pragma unroll
  for (int c = 0; c < kCoreOutRows; ++c) {
    const int o = min(o0 + c, out_dim - 1);  // a ragged last warp re-reads a valid row
    wrow[c] = w + (size_t)o * row_bytes;
    srow[c] = s + (size_t)o * n_groups;
    zrow[c] = z + (size_t)o * n_groups;
  }

  // AHEAD chunks a lane at a time: their codes, scales and biases loaded
  // first, then summed chunk by chunk in order
  for (int v0 = lane; v0 < n_chunks; v0 += 32 * AHEAD) {
    typename RawCodes<BITS>::T raw[AHEAD][kCoreOutRows];
    float sc[AHEAD][kCoreOutRows], zc[AHEAD][kCoreOutRows];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int v = v0 + 32 * u;
      if (v >= n_chunks) break;
      const int g = v / chunks_per_group;
#pragma unroll
      for (int c = 0; c < kCoreOutRows; ++c) {
        raw[u][c] = load_raw<BITS>(wrow[c], v);
        sc[u][c] = __ldg(srow[c] + g);
        zc[u][c] = __ldg(zrow[c] + g);
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int v = v0 + 32 * u;
      if (v >= n_chunks) break;
      float wv[kCoreOutRows][kCoreCodes];
#pragma unroll
      for (int c = 0; c < kCoreOutRows; ++c) {
        codes_to_float<BITS>(raw[u][c], wv[c]);
#pragma unroll
        for (int j = 0; j < kCoreCodes; ++j)
          wv[c][j] = __fadd_rn(__fmul_rn(wv[c][j], sc[u][c]), zc[u][c]);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r0 + r < rows) {
          const T* xr = x + (size_t)(r0 + r) * in_dim + (size_t)v * kCoreCodes;
          float xa[8], xb[8];
          load8(xr, xa);
          load8(xr + 8, xb);
#pragma unroll
          for (int c = 0; c < kCoreOutRows; ++c) {
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[c][r] = fmaf(wv[c][j], xa[j], acc[c][r]);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[c][r] = fmaf(wv[c][8 + j], xb[j], acc[c][r]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCoreOutRows; ++c)
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[c][r] += __shfl_xor_sync(0xffffffffu, acc[c][r], off);

  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kCoreOutRows; ++c) {
      const int o = o0 + c;
      if (o >= out_dim) continue;
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r0 + r < rows) out[(size_t)(r0 + r) * out_dim + o] = from_f32<T>(acc[c][r]);
    }
  }
}

template <typename T, int BITS, int RB, int AHEAD>
void launch_core(const void* x, const uint8_t* w, const float* s, const float* z,
                 void* out, int rows, int in_dim, int out_dim, int group,
                 cudaStream_t stream) {
  const int per_block = kCoreWarps * kCoreOutRows;
  dim3 grid((out_dim + per_block - 1) / per_block, (rows + RB - 1) / RB);
  affine_matvec_kernel<T, BITS, RB, AHEAD><<<grid, kCoreWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), w, s, z, static_cast<T*>(out), rows, in_dim,
      out_dim, group);
}

// 8-bit codes load one chunk ahead (more would cost occupancy); 4-bit two,
// and at two rows four where a lane has four chunks (IN >= 2048)
template <typename T, int BITS>
void run_core(const void* x, const uint8_t* w, const float* s, const float* z,
              void* out, int rows, int in_dim, int out_dim, int group,
              cudaStream_t stream) {
  constexpr int kA = BITS == 8 ? 1 : 2;
  if (rows == 1) {
    launch_core<T, BITS, 1, kA>(x, w, s, z, out, rows, in_dim, out_dim, group, stream);
  } else if (rows == 2) {
    if constexpr (BITS == 4) {
      if (in_dim >= 32 * 4 * kCoreCodes) {
        launch_core<T, BITS, 2, 4>(x, w, s, z, out, rows, in_dim, out_dim, group, stream);
        return;
      }
    }
    launch_core<T, BITS, 2, kA>(x, w, s, z, out, rows, in_dim, out_dim, group, stream);
  } else if constexpr (std::is_same_v<T, float>) {
    if (rows <= 4)
      launch_core<T, BITS, 4, kA>(x, w, s, z, out, rows, in_dim, out_dim, group, stream);
    else
      launch_core<T, BITS, 8, kA>(x, w, s, z, out, rows, in_dim, out_dim, group, stream);
  }
}

// --- bf16 route: tensor cores -------------------------------------------------

constexpr int kTileRows = 15;        // output rows of a warp's 16-row tile
constexpr int kHalf = 128;           // columns of a half window: 4 pairs of k16 steps
constexpr int kMaxWarps = 12;        // tiles of a block, at most
constexpr int kChunkRows = 64;       // activation rows of a launch chunk
constexpr int kPlanSMs = 132;        // the H100 SXM's SMs: the plan's target
constexpr int kMaxSplit = 8;         // blocks of a cluster (portable limit)
constexpr int kWarpsPerSM = 16;      // the plan's target
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 96 << 10;  // shared memory of the ring, at most (two blocks an SM)

struct MmaArgs {
  const bf16* x;
  const uint8_t* w;
  const float* s;
  const float* z;
  bf16* out;
  int rows, in_dim, out_dim, group;
  int mw;        // tiles (warps) of a block
  int cw;        // columns of a ring window: 128 or 256
  int ns;        // ring stages
  int paired;    // a lane's columns of two k16 steps are contiguous (group % 32 == 0)
  int copy;      // bytes of one code copy: 16, or 4
  int su;        // scale floats of one copy: 4, 2 or 1
  int nsl;       // scale slots of a row in a stage (a power of 2, >= su)
  int stage;     // bytes of one ring stage
  int cstride;   // bytes of a staged code row
  int xstride;   // bytes of a staged x row
  int x_off, s_off, z_off;  // offsets in a stage
  int recv_off;  // offset of the partial sums the cluster sends this block
};

// bf16x2 v - (128, 128), exact for 128 + q, q < 128
__device__ __forceinline__ uint32_t minus128(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(0x3F803F80u),
      "r"(0xC300C300u));
  return r;
}

// two bytes of v (B0 low, B1 high) as exact bf16x2, through fp32 2^23 + q
template <int B0, int B1>
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t v) {
  const float f0 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 | B0)) - 8388608.f;
  const float f1 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 | B1)) - 8388608.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// A fragments of a pair of k16 steps from one lane's codes of rows gr (c0)
// and gr + 8 (c1). 4-bit: a 32-bit word a row, bytes 0, 1 the first step's
// four codes (columns in nibble order), bytes 2, 3 the second's; 8-bit: two
// words a row, one a step, four codes each.
template <int BITS>
struct Codes {
  using T = std::conditional_t<BITS == 4, uint32_t, uint2>;
};

// (v & m) | k in one LOP3: m and k in registers, as the instruction has one
// immediate
__device__ __forceinline__ uint32_t and_or(uint32_t v, uint32_t m, uint32_t k) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(v), "r"(m), "r"(k));
  return r;
}

// 128 + (the low nibbles of bytes B of v and of h), as bf16x2
template <int SEL>
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v, uint32_t h, uint32_t m,
                                                   uint32_t k) {
  return minus128(and_or(__byte_perm(v, h, SEL), m, k));
}

template <int BITS>
__device__ __forceinline__ void to_frags(typename Codes<BITS>::T c0, typename Codes<BITS>::T c1,
                                         uint32_t (&a)[2][4]) {
  if constexpr (BITS == 4) {
    const uint32_t m = 0x000F000Fu, k = 0x43004300u;
    const uint32_t h0 = c0 >> 4, h1 = c1 >> 4;  // high nibbles in the low ones
    a[0][0] = nibbles_bf16x2<0x0400>(c0, h0, m, k);
    a[0][2] = nibbles_bf16x2<0x0501>(c0, h0, m, k);
    a[1][0] = nibbles_bf16x2<0x0602>(c0, h0, m, k);
    a[1][2] = nibbles_bf16x2<0x0703>(c0, h0, m, k);
    a[0][1] = nibbles_bf16x2<0x0400>(c1, h1, m, k);
    a[0][3] = nibbles_bf16x2<0x0501>(c1, h1, m, k);
    a[1][1] = nibbles_bf16x2<0x0602>(c1, h1, m, k);
    a[1][3] = nibbles_bf16x2<0x0703>(c1, h1, m, k);
  } else {
    a[0][0] = bytes_to_bf16x2<0, 1>(c0.x);
    a[0][2] = bytes_to_bf16x2<2, 3>(c0.x);
    a[1][0] = bytes_to_bf16x2<0, 1>(c0.y);
    a[1][2] = bytes_to_bf16x2<2, 3>(c0.y);
    a[0][1] = bytes_to_bf16x2<0, 1>(c1.x);
    a[0][3] = bytes_to_bf16x2<2, 3>(c1.x);
    a[1][1] = bytes_to_bf16x2<0, 1>(c1.y);
    a[1][3] = bytes_to_bf16x2<2, 3>(c1.y);
  }
}

// This lane's codes of pair p of a half window (row base `row`, gr's row):
// paired, one load a row; else one a step, merged into the same layout.
template <int BITS>
__device__ __forceinline__ typename Codes<BITS>::T load_pair(const uint8_t* row, int p,
                                                             int tq, bool paired) {
  if constexpr (BITS == 4) {
    if (paired) return *reinterpret_cast<const uint32_t*>(row + 16 * p + 4 * tq);
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(row + 16 * p + 2 * tq);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(row + 16 * p + 8 + 2 * tq);
    return lo | (hi << 16);
  } else {
    if (paired) return *reinterpret_cast<const uint2*>(row + 32 * p + 8 * tq);
    return make_uint2(*reinterpret_cast<const uint32_t*>(row + 32 * p + 4 * tq),
                      *reinterpret_cast<const uint32_t*>(row + 32 * p + 16 + 4 * tq));
  }
}

// B fragments of pair p for one n8 tile: x row at `xr` (this half window's
// first column): .x, .y the first step's, .z, .w the second's.
__device__ __forceinline__ uint4 load_x(const uint8_t* xr, int p, int tq, bool paired) {
  if (paired) return *reinterpret_cast<const uint4*>(xr + 64 * p + 16 * tq);
  const uint2 u = *reinterpret_cast<const uint2*>(xr + 64 * p + 8 * tq);
  const uint2 v = *reinterpret_cast<const uint2*>(xr + 64 * p + 32 + 8 * tq);
  return make_uint4(u.x, u.y, v.x, v.y);
}

// cp.async.wait_group takes an immediate: n = 0 .. kMaxStages - 2
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait_group<0>(); break;
    case 1: cp_async_wait_group<1>(); break;
    case 2: cp_async_wait_group<2>(); break;
    case 3: cp_async_wait_group<3>(); break;
    case 4: cp_async_wait_group<4>(); break;
    case 5: cp_async_wait_group<5>(); break;
    default: cp_async_wait_group<6>(); break;
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Grid (split, row blocks, row chunks), clusters of `split` blocks along x:
// block (rank, y, c) sums output rows y * 15 mw .. + 15 mw - 1 of rows
// chunk c over its rank's share of the groups.
template <int BITS, int NT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
affine_mma_kernel(const MmaArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  if (split > 1) cluster_arrive_relaxed();  // waited on before the first remote store
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const bool paired = a.paired;
  const int r0 = blockIdx.z * kChunkRows;
  const int nrows = min(kChunkRows, a.rows - r0);
  const bf16* x = a.x + (size_t)r0 * a.in_dim;
  const int R = kTileRows * a.mw;
  const int o_blk = blockIdx.y * R;
  const int n_groups = a.in_dim / a.group;
  const int gsteps = a.group / 16;  // k16 steps of a group
  const int g_lo = rank * n_groups / split, g_hi = (rank + 1) * n_groups / split;
  const int k_lo = g_lo * a.group;  // first column of this rank's slice
  const int n_steps = (g_hi - g_lo) * gsteps;
  const int wsteps = a.cw / 16;     // k16 steps of a window
  const int n_win = (n_steps + wsteps - 1) / wsteps;
  const int cb = a.cw * BITS / 8;   // code bytes of a row in a window
  const size_t w_row = (size_t)a.in_dim * BITS / 8;

  // row 15 of every tile in every slot: ones (cp.async never writes it)
  {
    const int words = cb / 4;
    const uint32_t ones = BITS == 4 ? 0x11111111u : 0x01010101u;
    for (int i = tid; i < a.ns * a.mw * words; i += nthr) {
      const int slot = i / (a.mw * words), rem = i - slot * a.mw * words;
      const int tile = rem / words, word = rem - tile * words;
      *reinterpret_cast<uint32_t*>(smem + slot * a.stage +
                                   (tile * 16 + 15) * a.cstride + word * 4) = ones;
    }
  }

  // the copies of window t into slot t % ns: codes, x, and the scales and
  // biases of the groups ending in it
  const int cpr_log = __ffs(cb / a.copy) - 1;  // code copies a row
  const int xpr_log = __ffs(a.cw / 8) - 1;     // x copies a row
  const int spr_log = __ffs(a.nsl / a.su) - 1; // scale copies a row
  auto issue = [&](int t) {
    if (t >= n_win) return;
    uint8_t* st = smem + (t % a.ns) * a.stage;
    const int step0 = t * wsteps;
    const int win_steps = min(wsteps, n_steps - step0);
    const int col0 = k_lo + step0 * 16;
    const int bytes = win_steps * 2 * BITS;  // code bytes of a row in this window
    const uint8_t* wsrc = a.w + (size_t)col0 * BITS / 8;
    for (int i = tid; i < (R << cpr_log); i += nthr) {
      const int r = i >> cpr_log, c = (i - (r << cpr_log)) * a.copy;
      if (c >= bytes) continue;
      const int o = min(o_blk + r, a.out_dim - 1);
      const uint8_t* src = wsrc + (size_t)o * w_row + c;
      uint8_t* dst = st + ((r / kTileRows) * 16 + r % kTileRows) * a.cstride + c;
      if (a.copy == 16)
        cp_async16(dst, src, true);
      else
        cp_async4(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), true);
    }
    const int xcols = win_steps * 16;
    for (int i = tid; i < (nrows << xpr_log); i += nthr) {
      const int b = i >> xpr_log, c = (i - (b << xpr_log)) * 8;
      if (c >= xcols) continue;
      cp_async16(st + a.x_off + b * a.xstride + c * 2, x + (size_t)b * a.in_dim + col0 + c,
                 true);
    }
    const int gs = step0 / gsteps;  // the first group ending in this window
    const int ng = (step0 + win_steps) / gsteps - gs;
    for (int i = tid; i < ((2 * R) << spr_log); i += nthr) {
      const int ar = i >> spr_log, j = (i - (ar << spr_log)) * a.su;
      if (j >= ng) continue;
      const int arr = ar >= R, r = ar - arr * R;
      const int o = min(o_blk + r, a.out_dim - 1);
      const float* src = (arr ? a.z : a.s) + (size_t)o * n_groups + g_lo + gs + j;
      float* dst = reinterpret_cast<float*>(st + (arr ? a.z_off : a.s_off)) +
                   ((r / kTileRows) * 16 + r % kTileRows) * a.nsl + j;
      if (a.su == 4)
        cp_async16(dst, src, true);
      else if (a.su == 2)
        cp_async8(dst, src);
      else
        cp_async4(dst, src, true);
    }
  };

  for (int t = 0; t < a.ns - 1; ++t) {
    issue(t);
    cp_async_commit();
  }

  float acc[NT][4], part[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = part[n][e] = 0.f;
  int xoff[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) xoff[n] = min(8 * n + gr, nrows - 1) * a.xstride;
  const int crow = (warp * 16 + gr) * a.cstride;
  const int srow = (warp * 16 + gr) * a.nsl;
  // a group's end: its sum of q x in C (rows gr, gr + 8 of this lane) and
  // its sum of x in C row 15 (lanes 28..31, c[2], c[3]) take the scales s
  // and biases z of rows gr, gr + 8
  auto group_end = [&](const float (&c)[NT][4], float s0, float s1, float z0, float z1) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (8 * n >= nrows) break;
      const float xs0 = __shfl_sync(0xffffffffu, c[n][2], 28 + tq);
      const float xs1 = __shfl_sync(0xffffffffu, c[n][3], 28 + tq);
      acc[n][0] = fmaf(z0, xs0, fmaf(s0, c[n][0], acc[n][0]));
      acc[n][1] = fmaf(z0, xs1, fmaf(s0, c[n][1], acc[n][1]));
      acc[n][2] = fmaf(z1, xs0, fmaf(s1, c[n][2], acc[n][2]));
      acc[n][3] = fmaf(z1, xs1, fmaf(s1, c[n][3], acc[n][3]));
    }
  };
  int gidx = 0;        // the group being summed, relative to the slice
  int gleft = gsteps;  // its steps still to come

  for (int t = 0; t < n_win; ++t) {
    cp_async_wait_upto(a.ns - 2);
    __syncthreads();
    issue(t + a.ns - 1);
    cp_async_commit();
    const uint8_t* st = smem + (t % a.ns) * a.stage;
    const float* sw = reinterpret_cast<const float*>(st + a.s_off) + srow;
    const float* zw = reinterpret_cast<const float*>(st + a.z_off) + srow;
    const int win_steps = min(wsteps, n_steps - t * wsteps);
    const int gs = gidx;
    for (int h = 0; 8 * h < win_steps; ++h) {
      const int steps = min(8, win_steps - 8 * h);
      const uint8_t* c0 = st + crow + h * (kHalf * BITS / 8);
      const uint8_t* xh = st + a.x_off + h * (2 * kHalf);
      // the half window's codes, all pairs at once (stale past `steps`, unused)
      typename Codes<BITS>::T cv0[4], cv1[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        cv0[p] = load_pair<BITS>(c0, p, tq, paired);
        cv1[p] = load_pair<BITS>(c0 + 8 * a.cstride, p, tq, paired);
      }
      if constexpr (NT <= 2) {
        if (gsteps == 4 && steps == 8 && gleft == 4 && paired) {
          // group 64, a whole half window: its two groups, A (pairs 0, 1)
          // and B (pairs 2, 3), summed side by side, each in step order
          const int j = gidx - gs;  // A's scale slot
          uint4 bx[4][NT];
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int n = 0; n < NT; ++n) bx[p][n] = load_x(xh + xoff[n], p, tq, true);
          const float sa0 = sw[j], sa1 = sw[8 * a.nsl + j];
          const float za0 = zw[j], za1 = zw[8 * a.nsl + j];
          const float sb0 = sw[j + 1], sb1 = sw[8 * a.nsl + j + 1];
          const float zb0 = zw[j + 1], zb1 = zw[8 * a.nsl + j + 1];
          float pa[NT][4], pb[NT][4];
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int k = 0; k < 4; ++k) pa[n][k] = pb[n][k] = 0.f;
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            uint32_t fa[2][4], fb[2][4];
            to_frags<BITS>(cv0[pp], cv1[pp], fa);
            to_frags<BITS>(cv0[2 + pp], cv1[2 + pp], fb);
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int n = 0; n < NT; ++n) {
                if (8 * n >= nrows) break;
                mma(pa[n], fa[e], e ? bx[pp][n].z : bx[pp][n].x, e ? bx[pp][n].w : bx[pp][n].y);
                mma(pb[n], fb[e], e ? bx[2 + pp][n].z : bx[2 + pp][n].x,
                    e ? bx[2 + pp][n].w : bx[2 + pp][n].y);
              }
          }
          group_end(pa, sa0, sa1, za0, za1);
          group_end(pb, sb0, sb1, zb0, zb1);
          gidx += 2;
          continue;
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (2 * p >= steps) break;
        uint4 bx[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) bx[n] = load_x(xh + xoff[n], p, tq, paired);
        uint32_t af[2][4];
        to_frags<BITS>(cv0[p], cv1[p], af);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (2 * p + e >= steps) break;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (8 * n >= nrows) break;
            mma(part[n], af[e], e ? bx[n].z : bx[n].x, e ? bx[n].w : bx[n].y);
          }
          if (--gleft == 0) {
            const int jj = gidx - gs;
            group_end(part, sw[jj], sw[8 * a.nsl + jj], zw[jj], zw[8 * a.nsl + jj]);
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int k = 0; k < 4; ++k) part[n][k] = 0.f;
            ++gidx;
            gleft = gsteps;
          }
        }
      }
    }
  }
  cp_async_wait_group<0>();

  if (split == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = 8 * n + 2 * tq + (e & 1), row = gr + 8 * (e >> 1);
        const int o = o_blk + warp * kTileRows + row;
        if (row < kTileRows && b < nrows && o < a.out_dim)
          a.out[(size_t)(r0 + b) * a.out_dim + o] = __float2bfloat16_rn(acc[n][e]);
      }
    return;
  }
  // the partial sums of output (b, r), e = b * R + r, go to the rank that
  // owns e (ranks own equal runs of e), which adds them in rank order
  const int n_out = nrows * R;
  const int per_rank = (n_out + split - 1) / split;
  float* recv = reinterpret_cast<float*>(smem + a.recv_off);
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = 8 * n + 2 * tq + (e & 1), row = gr + 8 * (e >> 1);
      if (row >= kTileRows || b >= nrows) continue;
      const int idx = b * R + warp * kTileRows + row;
      const int owner = ((idx + 1) * split + n_out - 1) / n_out - 1;
      float* dst = cluster.map_shared_rank(recv, owner);
      dst[rank * per_rank + idx - owner * n_out / split] = acc[n][e];
    }
  cluster.sync();
  const int e_lo = rank * n_out / split, e_hi = (rank + 1) * n_out / split;
  for (int idx = e_lo + tid; idx < e_hi; idx += nthr) {
    const int b = idx / R, r = idx - b * R;
    const int o = o_blk + r;
    float v = 0.f;
    for (int k = 0; k < split; ++k) v += recv[k * per_rank + idx - e_lo];
    if (o < a.out_dim) a.out[(size_t)(r0 + b) * a.out_dim + o] = __float2bfloat16_rn(v);
  }
}

struct Plan {
  int mw, split, row_blocks;
};

// Tiles of 15 rows; B plays no part. A shape of >= 4 tiles an SM: one
// block an SM, IN whole. Fewer tiles: IN split on group boundaries over
// the blocks of a cluster. At IN <= 1024 a block's fixed cost outweighs its
// share of the bytes: one block an SM of >= 4 tiles, split while a block
// would hold fewer. Wider IN: split until the card holds kWarpsPerSM warps
// (one a tile and slice), two blocks an SM of >= 4 tiles. On the H100 the
// split is 1.3-5.6x faster than none at B = 8-64 on the shapes it splits
// (PERF.md §6).
Plan make_plan(int in_dim, int out_dim, int group) {
  const int tiles = (out_dim + kTileRows - 1) / kTileRows;
  const int n_groups = in_dim / group;
  if (tiles >= 4 * kPlanSMs) {
    const int mw = min(kMaxWarps, (tiles + kPlanSMs - 1) / kPlanSMs);
    return {mw, 1, (tiles + mw - 1) / mw};
  }
  const bool narrow = in_dim <= 1024;
  const int per_block = narrow ? kPlanSMs : 2 * kPlanSMs;  // blocks the card holds
  int split = 1;
  auto warps = [&](int sp) { return (tiles * sp + per_block - 1) / per_block; };
  while (2 * split <= min(kMaxSplit, n_groups) &&
         (narrow ? warps(split) < 4 : tiles * split < kWarpsPerSM * kPlanSMs))
    split *= 2;
  const int mw = min(kMaxWarps, max(4, warps(split)));
  return {mw, split, (tiles + mw - 1) / mw};
}

constexpr int kMaxDevices = 64;

template <int BITS, int NT>
cudaError_t launch_mma(const MmaArgs& a, dim3 grid, int split, int smem, cudaStream_t stream) {
  // the shared-memory opt-in, once per device
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(affine_mma_kernel<BITS, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, 227 << 10);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * a.mw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;  // a cluster only where IN is split
  return cudaLaunchKernelEx(&cfg, affine_mma_kernel<BITS, NT>, a);
}

int align16(int n) { return (n + 15) & ~15; }

template <int BITS>
cudaError_t run_bf16(const void* x, const uint8_t* w, const float* s, const float* z,
                     void* out, int rows, int in_dim, int out_dim, int group,
                     cudaStream_t stream) {
  const Plan plan = make_plan(in_dim, out_dim, group);
  const int xr = min(rows, kChunkRows);
  const int n_groups = in_dim / group;
  MmaArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = w;
  a.s = s;
  a.z = z;
  a.out = static_cast<bf16*>(out);
  a.rows = rows;
  a.in_dim = in_dim;
  a.out_dim = out_dim;
  a.group = group;
  a.mw = plan.mw;
  a.cw = xr <= 16 ? 256 : 128;  // wider windows while x is small
  // a pair of k16 steps (32 columns) inside one group: 16-byte code copies
  // and one load a pair
  a.paired = group % 32 == 0;
  a.copy = (BITS == 8 || a.paired) ? 16 : 4;
  const int gsteps = group / 16;
  const int win_groups = (a.cw / 16 + gsteps - 1) / gsteps;  // groups ending in a window, at most
  a.nsl = 1;
  while (a.nsl < win_groups) a.nsl *= 2;
  // scale copies of 4, 2 or 1 floats: every slice, window and row of scales
  // starts on one
  a.su = 1;
  for (int u = 4; u > 1; u /= 2)
    if (a.cw % group == 0 && (a.cw / group) % u == 0 && n_groups % (plan.split * u) == 0 &&
        reinterpret_cast<uintptr_t>(s) % (4 * u) == 0 &&
        reinterpret_cast<uintptr_t>(z) % (4 * u) == 0) {
      a.su = u;
      break;
    }
  const int cb = a.cw * BITS / 8;
  a.cstride = cb + (BITS == 8 ? 32 : 16);  // bank offsets of the fragment loads
  a.xstride = 2 * a.cw + (a.paired ? 64 : 32);
  a.x_off = align16(16 * plan.mw * a.cstride);
  a.s_off = a.x_off + align16(xr * a.xstride);
  a.z_off = a.s_off + a.nsl * 16 * plan.mw * 4;
  a.stage = a.z_off + a.nsl * 16 * plan.mw * 4;
  a.ns = max(2, min(kMaxStages, kRingBytes / a.stage));
  a.recv_off = a.ns * a.stage;
  const int n_out = xr * kTileRows * plan.mw;
  const int smem =
      a.recv_off + (plan.split > 1 ? plan.split * ((n_out + plan.split - 1) / plan.split) * 4 : 0);
  const dim3 grid(plan.split, plan.row_blocks, (rows + kChunkRows - 1) / kChunkRows);
  if (xr <= 8) return launch_mma<BITS, 1>(a, grid, plan.split, smem, stream);
  if (xr <= 16) return launch_mma<BITS, 2>(a, grid, plan.split, smem, stream);
  if (xr <= 32) return launch_mma<BITS, 4>(a, grid, plan.split, smem, stream);
  return launch_mma<BITS, 8>(a, grid, plan.split, smem, stream);
}

}  // namespace

// bf16 rows up to which the CUDA-core route runs, the tensor-core one above
extern "C" int csm_affine_core_rows() { return kCoreRows; }

// x: (rows, in_dim) fp32 or bf16, contiguous, 16-byte aligned; w: uint8
// codes, (out_dim, in_dim) at bits 8 or (out_dim, in_dim / 2) at bits 4,
// contiguous, 16-byte aligned; s, z: (out_dim, in_dim / group) fp32; out:
// (rows, out_dim) in x's type. group % 16 == 0 and in_dim % group == 0
// (checked by the wrapper). Returns the launch's error code.
extern "C" int csm_affine_matvec(const void* x, const void* w, const void* s,
                                 const void* z, void* out, int rows,
                                 int in_dim, int out_dim, int group, int bits,
                                 int dtype, void* stream) {
  if (group <= 0 || group % 16 != 0 || in_dim % group != 0 || rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* wq = static_cast<const uint8_t*>(w);
  auto* sf = static_cast<const float*>(s);
  auto* zf = static_cast<const float*>(z);
  cudaError_t e = cudaSuccess;
  if (dtype == kF32 && bits == 8)
    run_core<float, 8>(x, wq, sf, zf, out, rows, in_dim, out_dim, group, st);
  else if (dtype == kF32 && bits == 4)
    run_core<float, 4>(x, wq, sf, zf, out, rows, in_dim, out_dim, group, st);
  else if (dtype == kBF16 && rows <= kCoreRows && bits == 8)
    run_core<bf16, 8>(x, wq, sf, zf, out, rows, in_dim, out_dim, group, st);
  else if (dtype == kBF16 && rows <= kCoreRows && bits == 4)
    run_core<bf16, 4>(x, wq, sf, zf, out, rows, in_dim, out_dim, group, st);
  else if (dtype == kBF16 && bits == 8)
    e = run_bf16<8>(x, wq, sf, zf, out, rows, in_dim, out_dim, group, st);
  else if (dtype == kBF16 && bits == 4)
    e = run_bf16<4>(x, wq, sf, zf, out, rows, in_dim, out_dim, group, st);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
