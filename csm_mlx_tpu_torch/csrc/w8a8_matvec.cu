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
// are taken RB at a time (grid.y).
//
// Above 64 rows (prefill) the product is a GEMM with 2*rows ops a weight
// byte, past the point where the tensor cores bound it (the JAX package
// sends these rows to an int8 XLA dot on the MXU): `w8a8_gemm_kernel` runs
// it on the int8 tensor cores (csrc/int8_mma.cuh, mma.sync m16n8k32) in
// 128 x 128 block tiles, 64 bytes of IN a step, through a 3-stage cp.async
// ring, each warp a 64 x 32 tile; the fix-up is its epilogue, in the
// matvec's order. Its int32 products equal the __dp4a ones exactly.
//
// Rounding: rintf rounds half to even, like jnp.round (CUDA's roundf would
// round half away from zero and change the codes at every .5). The fix-up
// uses __fmul_rn / __fadd_rn so that the compiler does not contract it into
// FMAs and it rounds like the plain PyTorch version.
//
// Tensor parallelism splits the product in two places (the JAX package's
// `_quant_linear_tp`, tp="in": o_proj and down_proj with their input dim
// sharded over the mesh's "model" axis). Three more entries serve it:
// `csm_w8a8_quant_rows` quantizes the whole (gathered) activation row
// alone, giving the codes and `aux` the fused call would compute;
// `csm_w8a8_partial` contracts a column range of those codes (row stride
// `ldx`) against the local int8 shard to RAW int32 sums, on the matvec
// route up to 64 rows and the GEMM route above (the same kernels with the
// fix-up left out); after the int32 all-reduce, `csm_w8a8_fixup` applies
// the fix-up once, in the kernels' order. Integer sums are exact in any
// order, so the three give the fused kernel's output bit for bit.

#include <cstdint>

#include "common.cuh"
#include "int8_mma.cuh"

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

// kRaw: out is int32 and gets the raw sums P (no fix-up; aux, s, z unused).
// qx rows are `ldx` bytes apart (in_dim for the fused call).
template <typename T, int RB, bool kRaw>
__global__ void __launch_bounds__(kWarps * 32)
w8a8_matvec_kernel(const int8_t* __restrict__ qx, int ldx,
                   const float2* __restrict__ aux,
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
                                  qx + (size_t)(r0 + r) * ldx) + v);
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
      if constexpr (kRaw) {
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r0 + r < rows) out[(size_t)(r0 + r) * out_dim + o] = acc[c][r];
      } else {
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
}

template <typename T, int RB, bool kRaw>
void launch_matvec(const int8_t* qx, int ldx, const float2* aux, const int8_t* w,
                   const float* s, const float* z, T* out, int rows, int in_dim,
                   int out_dim, cudaStream_t stream) {
  const int per_block = kWarps * kOC;
  dim3 grid((out_dim + per_block - 1) / per_block, (rows + RB - 1) / RB);
  w8a8_matvec_kernel<T, RB, kRaw><<<grid, kWarps * 32, 0, stream>>>(
      qx, ldx, aux, w, s, z, out, rows, in_dim, out_dim);
}

constexpr int kGemmM = 128, kGemmN = 128, kGemmK = 64, kGemmStages = 3;
constexpr int kGemmStride = kGemmK + 16;  // 80 bytes: ldmatrix rows on distinct banks
constexpr int kGemmThreads = 256;         // 8 warps: 2 (rows) x 4 (channels)
constexpr int kGemmTile = kGemmM * kGemmStride;
constexpr int kGemmSmem = kGemmStages * 2 * kGemmTile;

// out = fix-up(qx . w^T) for rows > 64: block tile 128 rows x 128 channels.
// kRaw and ldx as in the matvec.
template <typename T, bool kRaw>
__global__ void __launch_bounds__(kGemmThreads)
w8a8_gemm_kernel(const int8_t* __restrict__ qx, int ldx,
                 const float2* __restrict__ aux,
                 const int8_t* __restrict__ w, const float* __restrict__ s,
                 const float* __restrict__ z, T* __restrict__ out, int rows,
                 int in_dim, int out_dim) {
  extern __shared__ __align__(128) int8_t gsm[];
  int8_t* sa = gsm;                             // stages x (128 rows x 64 bytes)
  int8_t* sb = gsm + kGemmStages * kGemmTile;   // stages x (128 channels x 64 bytes)
  const int m0 = blockIdx.y * kGemmM, n0 = blockIdx.x * kGemmN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
  const int k_tiles = (in_dim + kGemmK - 1) / kGemmK;

  // one k-tile of both operands; 16-byte pieces past the edges are zeros
  auto load = [&](int stage, int kt) {
    const int k0 = kt * kGemmK;
    for (int i = threadIdx.x; i < kGemmM * 4; i += kGemmThreads) {
      const int r = i >> 2, k = k0 + (i & 3) * 16;
      const bool ok = m0 + r < rows && k < in_dim;
      cp_async16(sa + stage * kGemmTile + r * kGemmStride + (i & 3) * 16,
                 ok ? qx + (size_t)(m0 + r) * ldx + k : qx, ok);
    }
    for (int i = threadIdx.x; i < kGemmN * 4; i += kGemmThreads) {
      const int r = i >> 2, k = k0 + (i & 3) * 16;
      const bool ok = n0 + r < out_dim && k < in_dim;
      cp_async16(sb + stage * kGemmTile + r * kGemmStride + (i & 3) * 16,
                 ok ? w + (size_t)(n0 + r) * in_dim + k : w, ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

#pragma unroll
  for (int st = 0; st < kGemmStages - 1; ++st) {
    if (st < k_tiles) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kGemmStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    const int next = kt + kGemmStages - 1;
    if (next < k_tiles) load(next % kGemmStages, next);
    cp_async_commit();
    const int8_t* at = sa + (kt % kGemmStages) * kGemmTile + wm * 64 * kGemmStride;
    const int8_t* bt = sb + (kt % kGemmStages) * kGemmTile + wn * 32 * kGemmStride;
#pragma unroll
    for (int ks = 0; ks < kGemmK / 32; ++ks) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        load_a_frag(af[mi], at + mi * 16 * kGemmStride + ks * 32, kGemmStride, lane);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        load_b_frag2(bf[nj], bt + nj * 16 * kGemmStride + ks * 32, kGemmStride, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = m0 + wm * 64 + mi * 16 + g + (i >> 1) * 8;
        const int o = n0 + wn * 32 + ni * 8 + tg * 2 + (i & 1);
        if (b < rows && o < out_dim) {
          if constexpr (kRaw) {
            out[(size_t)b * out_dim + o] = acc[mi][ni][i];
          } else {
            const float2 a = aux[b];  // (absmax / 127, sum of the row)
            const float y = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[mi][ni][i], s[o]), a.x),
                                      __fmul_rn(z[o], a.y));
            out[(size_t)b * out_dim + o] = from_f32<T>(y);
          }
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

template <typename T, bool kRaw>
cudaError_t launch_gemm(const int8_t* qx, int ldx, const float2* aux, const int8_t* w,
                        const float* s, const float* z, T* out, int rows,
                        int in_dim, int out_dim, cudaStream_t stream) {
  // the shared-memory opt-in, once per device
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(w8a8_gemm_kernel<T, kRaw>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kGemmSmem);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  dim3 grid((out_dim + kGemmN - 1) / kGemmN, (rows + kGemmM - 1) / kGemmM);
  w8a8_gemm_kernel<T, kRaw><<<grid, kGemmThreads, kGemmSmem, stream>>>(
      qx, ldx, aux, w, s, z, out, rows, in_dim, out_dim);
  return cudaSuccess;
}

constexpr int kMaxMatvecRows = 64;  // W8A8_MATVEC_MAX_ROWS of ops/quant.py

// The product of quantized rows (qx, ldx bytes apart) with w: the fix-up
// into T (kRaw false), or the raw int32 sums (kRaw true, T = int).
template <typename T, bool kRaw>
cudaError_t product(const int8_t* qx, int ldx, const float2* aux, const int8_t* w,
                    const float* s, const float* z, T* o, int rows, int in_dim,
                    int out_dim, cudaStream_t stream) {
  if (rows > kMaxMatvecRows)
    return launch_gemm<T, kRaw>(qx, ldx, aux, w, s, z, o, rows, in_dim, out_dim, stream);
  if (rows == 1)
    launch_matvec<T, 1, kRaw>(qx, ldx, aux, w, s, z, o, rows, in_dim, out_dim, stream);
  else if (rows == 2)
    launch_matvec<T, 2, kRaw>(qx, ldx, aux, w, s, z, o, rows, in_dim, out_dim, stream);
  else if (rows <= 4)
    launch_matvec<T, 4, kRaw>(qx, ldx, aux, w, s, z, o, rows, in_dim, out_dim, stream);
  else
    launch_matvec<T, 8, kRaw>(qx, ldx, aux, w, s, z, o, rows, in_dim, out_dim, stream);
  return cudaSuccess;
}

template <typename T>
void run(const void* x, int8_t* qx, float2* aux, const int8_t* w,
         const float* s, const float* z, void* out, int rows, int in_dim,
         int out_dim, cudaStream_t stream, cudaError_t* err) {
  quant_rows_kernel<T><<<rows, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), qx, aux, in_dim);
  const cudaError_t e = product<T, false>(qx, in_dim, aux, w, s, z,
                                          static_cast<T*>(out), rows, in_dim,
                                          out_dim, stream);
  if (e != cudaSuccess) *err = e;
}

constexpr int kFixupThreads = 256;

// out[b,o] = P[b,o] * s[o] * aux[b].x + z[o] * aux[b].y, the fused
// epilogue's arithmetic on summed int32 partials.
template <typename T>
__global__ void __launch_bounds__(kFixupThreads)
w8a8_fixup_kernel(const int* __restrict__ p, const float2* __restrict__ aux,
                  const float* __restrict__ s, const float* __restrict__ z,
                  T* __restrict__ out, int rows, int out_dim) {
  const size_t i = (size_t)blockIdx.x * kFixupThreads + threadIdx.x;
  if (i >= (size_t)rows * out_dim) return;
  const int b = (int)(i / out_dim), o = (int)(i % out_dim);
  const float2 a = aux[b];
  const float y = __fadd_rn(__fmul_rn(__fmul_rn((float)p[i], s[o]), a.x),
                            __fmul_rn(z[o], a.y));
  out[i] = from_f32<T>(y);
}

}  // namespace

// x: (rows, in_dim) fp32 or bf16, contiguous; qx: (rows, in_dim) int8 and
// aux: (rows, 2) fp32 scratch; w: (out_dim, in_dim) int8, contiguous, 16-byte
// aligned; s, z: (out_dim,) fp32; out: (rows, out_dim) in x's type.
// in_dim % 16 == 0 (checked by the wrapper). Up to 64 rows the matvec runs,
// above that the tensor-core GEMM. Returns cudaGetLastError().
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
  cudaError_t err = cudaSuccess;
  if (dtype == kF32)
    run<float>(x, q8, a2, w8, sf, zf, out, rows, in_dim, out_dim, st, &err);
  else if (dtype == kBF16)
    run<__nv_bfloat16>(x, q8, a2, w8, sf, zf, out, rows, in_dim, out_dim, st, &err);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The whole row's quantization alone: qx (rows, in_dim) int8 and aux
// (rows, 2) fp32 = (absmax / 127, sum of the row), as the fused call
// computes them. x: (rows, in_dim) fp32 or bf16, contiguous.
extern "C" int csm_w8a8_quant_rows(const void* x, void* qx, void* aux, int rows,
                                   int in_dim, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* q8 = static_cast<int8_t*>(qx);
  auto* a2 = static_cast<float2*>(aux);
  if (dtype == kF32)
    quant_rows_kernel<float><<<rows, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), q8, a2, in_dim);
  else if (dtype == kBF16)
    quant_rows_kernel<__nv_bfloat16><<<rows, kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q8, a2, in_dim);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Raw int32 sums out[b,o] = sum_i qx[b*ldx + i] * w[o*in_dim + i] for i <
// in_dim: a column range of quantized rows (the pointer at its first
// column, rows ldx bytes apart) against the local shard w (out_dim,
// in_dim). qx + b*ldx and w on 16-byte boundaries, in_dim % 16 == 0
// (checked by the wrapper). Up to 64 rows the matvec, above the GEMM.
extern "C" int csm_w8a8_partial(const void* qx, int ldx, const void* w, void* out,
                                int rows, int in_dim, int out_dim, void* stream) {
  const cudaError_t e = product<int, true>(
      static_cast<const int8_t*>(qx), ldx, nullptr, static_cast<const int8_t*>(w),
      nullptr, nullptr, static_cast<int*>(out), rows, in_dim, out_dim,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The fix-up of summed partials: p (rows, out_dim) int32, aux (rows, 2)
// fp32, s, z (out_dim,) fp32 -> out (rows, out_dim) in `dtype`.
extern "C" int csm_w8a8_fixup(const void* p, const void* aux, const void* s,
                              const void* z, void* out, int rows, int out_dim,
                              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)rows * out_dim;
  const unsigned blocks = (unsigned)((n + kFixupThreads - 1) / kFixupThreads);
  auto* pi = static_cast<const int*>(p);
  auto* a2 = static_cast<const float2*>(aux);
  auto* sf = static_cast<const float*>(s);
  auto* zf = static_cast<const float*>(z);
  if (n == 0) return (int)cudaSuccess;
  if (dtype == kF32)
    w8a8_fixup_kernel<float><<<blocks, kFixupThreads, 0, st>>>(
        pi, a2, sf, zf, static_cast<float*>(out), rows, out_dim);
  else if (dtype == kBF16)
    w8a8_fixup_kernel<__nv_bfloat16><<<blocks, kFixupThreads, 0, st>>>(
        pi, a2, sf, zf, static_cast<__nv_bfloat16*>(out), rows, out_dim);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
