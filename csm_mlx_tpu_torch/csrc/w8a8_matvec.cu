// W8A8 matvec for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_quant_matvec_w8a8` in
// csm_mlx_tpu/ops/quant.py, together with the dynamic activation
// quantization its wrapper runs before the pallas_call. It computes exactly
// what the XLA mirror `_xla_w8a8_matvec` computes:
//
//   absmax[b] = max(max_i |x[b,i]|, 1e-6)
//   qx[b,i]   = clip(rint(x[b,i] * (127 / absmax[b])), -127, 127)   (int8)
//   P[b,o]    = sum_i qx[b,i] * q[o,i]                           (exact int32)
//   out[b,o]  = P[b,o] * s[o] * (absmax[b] / 127) + z[o] * sum_i x[b,i]
//
// What bounds it on the H100: the int8 weight bytes. At decode (B <= 64
// rows) every call streams OUT*IN weight bytes once and does 2*B ops per
// byte, far below the ~590 int8 ops/byte where the tensor cores would be the
// limit, so the kernel is a bandwidth kernel: each warp owns OC output
// channels and streams their rows with 16-byte loads (32 lanes cover 512
// contiguous bytes per row per step), and the int8 dot products run on
// __dp4a into int32 registers. The quantized activations (at most B*IN
// bytes, 512 KB at B=64, IN=8192) are read through L1/L2 rather than
// staged in shared memory, so no tile of them has to fit in 227 KB. Rows
// are taken RB at a time (grid.y); past RB rows the weights are re-read,
// mostly from the 50 MB L2.
//
// Rounding: rintf rounds half to even, like jnp.round (CUDA's roundf would
// round half away from zero and change the codes at every .5). The fix-up
// uses __fmul_rn / __fadd_rn so that the compiler does not contract it into
// FMAs and it rounds like the plain PyTorch version.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kQuantThreads = 256;
constexpr int kWarps = 4;   // warps per block of the matvec pass
constexpr int kOC = 2;      // output channels per warp

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ qx,
                  float2* __restrict__ aux, int in_dim) {
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * in_dim;
  float amax = 0.f, sum = 0.f;
  for (int i = threadIdx.x; i < in_dim; i += kQuantThreads) {
    float v = to_f32(xr[i]);
    amax = fmaxf(amax, fabsf(v));
    sum += v;
  }
  __shared__ float s_max[kQuantThreads / 32], s_sum[kQuantThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { s_max[warp] = amax; s_sum[warp] = sum; }
  __syncthreads();
  amax = 0.f; sum = 0.f;
  for (int w = 0; w < kQuantThreads / 32; ++w) {
    amax = fmaxf(amax, s_max[w]);
    sum += s_sum[w];
  }
  amax = fmaxf(amax, 1e-6f);
  const float xs = 127.f / amax;
  for (int i = threadIdx.x; i < in_dim; i += kQuantThreads) {
    float v = rintf(__fmul_rn(to_f32(xr[i]), xs));
    v = fminf(fmaxf(v, -127.f), 127.f);
    qx[(size_t)row * in_dim + i] = (int8_t)(int)v;
  }
  if (threadIdx.x == 0) aux[row] = make_float2(amax / 127.f, sum);
}

__device__ __forceinline__ int dot16(const int4& a, const int4& b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

template <typename T, int RB>
__global__ void __launch_bounds__(kWarps * 32)
w8a8_matvec_kernel(const int8_t* __restrict__ qx, const float2* __restrict__ aux,
                   const int8_t* __restrict__ w, const float* __restrict__ s,
                   const float* __restrict__ z, T* __restrict__ out,
                   int rows, int in_dim, int out_dim) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x * kWarps + warp) * kOC;
  const int r0 = blockIdx.y * RB;
  if (o0 >= out_dim) return;
  const int nvec = in_dim / 16;

  int acc[kOC][RB];
#pragma unroll
  for (int c = 0; c < kOC; ++c)
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[c][r] = 0;

  const int4* wrow[kOC];
#pragma unroll
  for (int c = 0; c < kOC; ++c) {
    const int o = min(o0 + c, out_dim - 1);  // a ragged last warp re-reads a valid row
    wrow[c] = reinterpret_cast<const int4*>(w + (size_t)o * in_dim);
  }

  for (int v = lane; v < nvec; v += 32) {
    int4 wv[kOC];
#pragma unroll
    for (int c = 0; c < kOC; ++c) wv[c] = __ldg(wrow[c] + v);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r0 + r < rows) {
        const int4 xv = __ldg(reinterpret_cast<const int4*>(
                                  qx + (size_t)(r0 + r) * in_dim) + v);
#pragma unroll
        for (int c = 0; c < kOC; ++c) acc[c][r] = dot16(wv[c], xv, acc[c][r]);
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
      const float so = s[o], zo = z[o];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int b = r0 + r;
        if (b >= rows) continue;
        const float2 a = aux[b];  // (absmax / 127, sum of the row)
        const float y = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[c][r], so), a.x),
                                  __fmul_rn(zo, a.y));
        out[(size_t)b * out_dim + o] = from_f32<T>(y);
      }
    }
  }
}

template <typename T, int RB>
void launch_matvec(const int8_t* qx, const float2* aux, const int8_t* w,
                   const float* s, const float* z, T* out, int rows, int in_dim,
                   int out_dim, cudaStream_t stream) {
  const int per_block = kWarps * kOC;
  dim3 grid((out_dim + per_block - 1) / per_block, (rows + RB - 1) / RB);
  w8a8_matvec_kernel<T, RB><<<grid, kWarps * 32, 0, stream>>>(
      qx, aux, w, s, z, out, rows, in_dim, out_dim);
}

template <typename T>
void run(const void* x, int8_t* qx, float2* aux, const int8_t* w,
         const float* s, const float* z, void* out, int rows, int in_dim,
         int out_dim, cudaStream_t stream) {
  quant_rows_kernel<T><<<rows, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), qx, aux, in_dim);
  T* o = static_cast<T*>(out);
  if (rows == 1)
    launch_matvec<T, 1>(qx, aux, w, s, z, o, rows, in_dim, out_dim, stream);
  else if (rows == 2)
    launch_matvec<T, 2>(qx, aux, w, s, z, o, rows, in_dim, out_dim, stream);
  else if (rows <= 4)
    launch_matvec<T, 4>(qx, aux, w, s, z, o, rows, in_dim, out_dim, stream);
  else
    launch_matvec<T, 8>(qx, aux, w, s, z, o, rows, in_dim, out_dim, stream);
}

}  // namespace

// x: (rows, in_dim) fp32 or bf16, contiguous; qx: (rows, in_dim) int8 and
// aux: (rows, 2) fp32 scratch; w: (out_dim, in_dim) int8, contiguous, 16-byte
// aligned; s, z: (out_dim,) fp32; out: (rows, out_dim) in x's type.
// in_dim % 16 == 0 (checked by the wrapper). Returns cudaGetLastError().
extern "C" int csm_w8a8_matvec(const void* x, void* qx, void* aux,
                               const void* w, const void* s, const void* z,
                               void* out, int rows, int in_dim, int out_dim,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* q8 = static_cast<int8_t*>(qx);
  auto* a2 = static_cast<float2*>(aux);
  auto* w8 = static_cast<const int8_t*>(w);
  auto* sf = static_cast<const float*>(s);
  auto* zf = static_cast<const float*>(z);
  if (dtype == kF32)
    run<float>(x, q8, a2, w8, sf, zf, out, rows, in_dim, out_dim, st);
  else if (dtype == kBF16)
    run<__nv_bfloat16>(x, q8, a2, w8, sf, zf, out, rows, in_dim, out_dim, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
