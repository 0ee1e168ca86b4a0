// Grouped-affine dequant matvec for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_quant_matvec` in csm_mlx_tpu/ops/quant.py
// (MLX `nn.quantize` parity): unsigned codes q with, per output row o and
// input group g of `group` columns, w[o,i] = s[o,g] * q[o,i] + z[o,g], and
//
//   out[b,o] = sum_i x[b,i] * w[o,i]        (fp32 accumulation, out in x's type)
//
// Codes are 8-bit, uint8 (OUT, IN), or 4-bit packed two to a byte, uint8
// (OUT, IN/2), column 2j in the low nibble of byte j. The group is any
// multiple of 16 that divides IN (the TPU kernel needs 128-aligned groups,
// so the default group 64 never reached it there).
//
// What bounds it on the H100: the code bytes plus the fp32 scales and
// biases (8 bytes a group a row). At decode (B <= 64 rows) each code byte
// is used 2*B times, far below what would make the card compute-bound at
// small B, so the kernel streams the codes: each warp owns kOC output rows,
// each lane takes 16 codes of a row at a time (one 16-byte load of 8-bit
// codes, one 8-byte load of 4-bit codes; 16 | group, so the 16 codes share
// one scale and bias), dequantizes them in registers and multiplies them
// into the fp32 accumulators of RB activation rows. x is read in its own
// type through L1/L2 (64 rows of 8192 fp32 do not fit in 227 KB of shared
// memory); its conversion to fp32 is exact. Rows past RB (grid.y) re-read
// the codes, mostly from the 50 MB L2. At B = 64 the fp32 FMAs, not the
// bytes, set the pace: a later version would put them on the tensor cores.
//
// Rounding: the dequantized weight is __fmul_rn then __fadd_rn (no FMA
// contraction), so it equals the plain version's q * s + z to the bit; the
// sums differ from it only in their order.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kOC = 2;     // output rows per warp
constexpr int kChunk = 16; // codes per lane step

template <int BITS>
__device__ __forceinline__ void load_codes(const uint8_t* row, int chunk,
                                           float (&q)[kChunk]) {
  if constexpr (BITS == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row) + chunk);
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int k = 0; k < 4; ++k) q[4 * w + k] = (float)((words[w] >> (8 * k)) & 0xFFu);
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + chunk);
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

template <typename T, int BITS, int RB>
__global__ void __launch_bounds__(kWarps * 32)
affine_matvec_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                     const float* __restrict__ s, const float* __restrict__ z,
                     T* __restrict__ out, int rows, int in_dim, int out_dim,
                     int group) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x * kWarps + warp) * kOC;
  const int r0 = blockIdx.y * RB;
  if (o0 >= out_dim) return;
  const int n_chunks = in_dim / kChunk;
  const int chunks_per_group = group / kChunk;
  const int n_groups = in_dim / group;
  const size_t row_bytes = BITS == 8 ? (size_t)in_dim : (size_t)in_dim / 2;

  float acc[kOC][RB];
#pragma unroll
  for (int c = 0; c < kOC; ++c)
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[c][r] = 0.f;

  const uint8_t* wrow[kOC];
  const float* srow[kOC];
  const float* zrow[kOC];
#pragma unroll
  for (int c = 0; c < kOC; ++c) {
    const int o = min(o0 + c, out_dim - 1);  // a ragged last warp re-reads a valid row
    wrow[c] = w + (size_t)o * row_bytes;
    srow[c] = s + (size_t)o * n_groups;
    zrow[c] = z + (size_t)o * n_groups;
  }

  for (int v = lane; v < n_chunks; v += 32) {
    const int g = v / chunks_per_group;
    float wv[kOC][kChunk];
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      load_codes<BITS>(wrow[c], v, wv[c]);
      const float sc = __ldg(srow[c] + g), zc = __ldg(zrow[c] + g);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) wv[c][j] = __fadd_rn(__fmul_rn(wv[c][j], sc), zc);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r0 + r < rows) {
        const T* xr = x + (size_t)(r0 + r) * in_dim + (size_t)v * kChunk;
        float xa[8], xb[8];
        load8(xr, xa);
        load8(xr + 8, xb);
#pragma unroll
        for (int c = 0; c < kOC; ++c) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[c][r] = fmaf(wv[c][j], xa[j], acc[c][r]);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[c][r] = fmaf(wv[c][8 + j], xb[j], acc[c][r]);
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kOC; ++c)
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[c][r] += __shfl_xor_sync(0xffffffffu, acc[c][r], off);

  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      const int o = o0 + c;
      if (o >= out_dim) continue;
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r0 + r < rows) out[(size_t)(r0 + r) * out_dim + o] = from_f32<T>(acc[c][r]);
    }
  }
}

template <typename T, int BITS, int RB>
void launch(const void* x, const uint8_t* w, const float* s, const float* z,
            void* out, int rows, int in_dim, int out_dim, int group,
            cudaStream_t stream) {
  const int per_block = kWarps * kOC;
  dim3 grid((out_dim + per_block - 1) / per_block, (rows + RB - 1) / RB);
  affine_matvec_kernel<T, BITS, RB><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), w, s, z, static_cast<T*>(out), rows, in_dim,
      out_dim, group);
}

template <typename T, int BITS>
void run(const void* x, const uint8_t* w, const float* s, const float* z,
         void* out, int rows, int in_dim, int out_dim, int group,
         cudaStream_t stream) {
  if (rows == 1)
    launch<T, BITS, 1>(x, w, s, z, out, rows, in_dim, out_dim, group, stream);
  else if (rows == 2)
    launch<T, BITS, 2>(x, w, s, z, out, rows, in_dim, out_dim, group, stream);
  else if (rows <= 4)
    launch<T, BITS, 4>(x, w, s, z, out, rows, in_dim, out_dim, group, stream);
  else
    launch<T, BITS, 8>(x, w, s, z, out, rows, in_dim, out_dim, group, stream);
}

}  // namespace

// x: (rows, in_dim) fp32 or bf16, contiguous, 16-byte aligned; w: uint8
// codes, (out_dim, in_dim) at bits 8 or (out_dim, in_dim / 2) at bits 4,
// contiguous, 16-byte aligned; s, z: (out_dim, in_dim / group) fp32; out:
// (rows, out_dim) in x's type. group % 16 == 0 and in_dim % group == 0
// (checked by the wrapper). Returns cudaGetLastError().
extern "C" int csm_affine_matvec(const void* x, const void* w, const void* s,
                                 const void* z, void* out, int rows,
                                 int in_dim, int out_dim, int group, int bits,
                                 int dtype, void* stream) {
  if (group <= 0 || group % kChunk != 0 || in_dim % group != 0 || rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* wq = static_cast<const uint8_t*>(w);
  auto* sf = static_cast<const float*>(s);
  auto* zf = static_cast<const float*>(z);
  if (dtype == kF32 && bits == 8)
    run<float, 8>(x, wq, sf, zf, out, rows, in_dim, out_dim, group, st);
  else if (dtype == kF32 && bits == 4)
    run<float, 4>(x, wq, sf, zf, out, rows, in_dim, out_dim, group, st);
  else if (dtype == kBF16 && bits == 8)
    run<__nv_bfloat16, 8>(x, wq, sf, zf, out, rows, in_dim, out_dim, group, st);
  else if (dtype == kBF16 && bits == 4)
    run<__nv_bfloat16, 4>(x, wq, sf, zf, out, rows, in_dim, out_dim, group, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
