// Flash decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_decode_sdpa` in csm_mlx_tpu/ops/attention.py:
// attention of ONE query position (a backbone decode step) over a whole KV
// cache with grouped-query heads, where key j of batch row b is valid iff
// pad_len[b] <= j <= index (`index` is the slot this step just wrote), with
// an fp32 softmax and the mask computed in the kernel.
//
// What bounds it on the H100: the K/V bytes. Each key is used by the G
// query heads of its group only, ~4*G flops per K/V element read (at G=4
// about 13 TFLOP/s at the bandwidth bound, a fifth of the fp32 peak), so
// the design is about keeping enough bytes in flight and few instructions
// a byte: the bf16 scores run on the tensor cores, the rest (and fp32,
// whose gate TF32 cannot meet) on the CUDA cores in fp32.
//
// The numerics are those of the masked softmax it replaces (the plain
// version): the scores s = q.k * scale in fp32, P = exp(s - max) / sum over
// all the row's keys, P rounded to the element type, then P.V summed in
// fp32 and rounded. So K and V are read in two passes, each exactly once:
// the K pass writes the scores (fp32, B * H * cap values, a few percent of
// the K/V bytes) and each block's (max, sum of exp); the V pass turns the
// scores into P with the row's max and sum and accumulates P.V. (The JAX
// kernel keeps P in fp32, unnormalised; rounding the normalised P as the
// masked softmax does keeps a bf16 decode step within a last-bit
// difference of the masked path instead of P's rounding, which 16 layers
// amplify.)
//
// Flash-decoding: the grid is (splits, n_kv, B). A block serves one (batch
// row, kv head) and its G query heads over one contiguous chunk of the
// cache, clipped to the valid keys [pad, index]. The split count and the
// chunk come from the wrapper and depend on (B, n_kv, cap) only, never on
// `index`, which every block reads from device memory (`index_ptr`, the
// cache's own int32 index): one launch configuration, captured once in a
// CUDA graph, serves every decode step. Where B * n_kv blocks already fill the card there is one split
// and one launch: a block runs both passes over the whole row. Otherwise
// three launches: the K pass of every split (each block leaves its max and
// sum), the V pass (each block reduces the row's splits' max and sum in
// split order, then leaves its P.V partial), and a merge that sums the
// partials in split order. No atomics: every value is written by one
// thread and summed in a fixed order, so repeats are bit-equal. (Merging
// in the V pass's last block of a row, through an integer ticket, measured
// no faster: its fences cost what the launch saved.)
//
// A block of 4 warps streams its chunk in tiles of kT keys (64 in bf16, 32
// in fp32: 8 KB), double-buffered in shared memory by 16-byte cp.async
// copies, consecutive threads on consecutive 16 bytes of a row (the V
// pass stages the tile's scores beside it). In the K pass each warp owns
// kT / 4 keys of a tile and keeps an online max and sum of exp per head.
// bf16: its 16 keys are the A operand of mma.sync m16n8k16 (ldmatrix from
// 144-byte rows), the G <= 8 queries the B operand (n = 8), fp32 sums.
// fp32: kL = 128 / kT lanes a key, 64 bytes of its K row each (rows padded
// so the reads are free of bank conflicts), dot products with the queries
// (fp32, in shared memory) joined by shuffles. In the V pass each warp
// turns its keys' scores into P and each lane owns 2 of the 64 dims and
// walks the warp's keys; the 4 warps' sums add in order.
//
// Masking follows the JAX package: an in-range key that fails the mask gets
// the finite NEG_INF = -0.7 * FLT_MAX, not -inf, so a row with no valid key
// at all (pad > index, never seen in generation) averages all `cap` V rows,
// as the masked softmax does; its blocks then walk the whole cache. A key
// outside a block's range contributes nothing, and a split whose chunk
// holds no key to walk leaves an empty partial (max = -inf, P.V = 0).
//
// q, k and v are read through the strides the wrapper passes (the innermost
// dimension must be contiguous, rows 16-byte aligned), so the cache's layer
// buffers and the transposed query projection are read in place.

#include <cmath>

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 4;              // warps per block
constexpr int kDecodeThreads = kWarps * 32;
constexpr int kStages = 2;             // a ring of tiles; deeper measured no faster

// bf16 scores on the tensor cores; fp32 keeps the CUDA cores (TF32 could
// not meet the fp32 gate)
template <typename T>
constexpr bool kMma = sizeof(T) == 2;

template <typename T>
struct Tiles {
  static constexpr int kT = sizeof(T) == 2 ? 64 : 32;   // keys per tile
  static constexpr int kKeys = kT / kWarps;              // keys per warp: 16, 8
  static constexpr int kVec = 16 / sizeof(T);            // elements per 16 bytes
  // fp32 K pass: lanes a key, and 16-byte loads of its row a lane
  static constexpr int kL = 128 / kT;
  static constexpr int kParts = kD / kVec / kL;
  // Row stride in elements: bf16 rows of 144 bytes, conflict-free for
  // ldmatrix (kernel 6's layout); fp32 rows padded by 16 elements, which
  // put the kL lanes of a key and the next rows' lanes on distinct banks.
  static constexpr int kRow = kMma<T> ? kLd : kD + 16;
  static constexpr int kTileElems = kT * kRow;
  static_assert(!kMma<T> || kKeys == 16, "a warp's keys are one mma's 16 rows");
};

__device__ __forceinline__ void to_f32x(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Rows r0 .. r0 + kT - 1 of one (batch, kv head) plane into a shared tile;
// rows past `last` are zeros and never read from device memory.
template <typename T>
__device__ __forceinline__ void decode_tile_async(T* sm, const T* g, long long rs,
                                                  int r0, int last) {
  using C = Tiles<T>;
  constexpr int kPerRow = kD / C::kVec;  // 16-byte pieces of a row
#pragma unroll
  for (int i = 0; i < C::kT * kPerRow / kDecodeThreads; ++i) {
    const int e = threadIdx.x + i * kDecodeThreads;
    const int r = e / kPerRow, c = (e % kPerRow) * C::kVec;
    const bool ok = r0 + r <= last;
    cp_async16(sm + r * C::kRow + c, g + (long long)(ok ? r0 + r : 0) * rs + c, ok);
  }
}

// Round to the element type and back, as the masked softmax's
// probs.to(v.dtype): a no-op in fp32.
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return to_f32(from_f32<T>(x));
}

// The scores of keys r0 .. r0 + kT - 1 of the G head rows at g (row
// stride cap) into sm[G][kT]; zeros past `last`, never read.
template <typename T, int G>
__device__ __forceinline__ void score_tile_async(float* sm, const float* g, int cap,
                                                 int r0, int last) {
  constexpr int kT = Tiles<T>::kT;
#pragma unroll
  for (int i = 0; i < (G * kT + kDecodeThreads - 1) / kDecodeThreads; ++i) {
    const int e = threadIdx.x + i * kDecodeThreads;
    if (e >= G * kT) break;
    const int h = e / kT, j = e % kT;
    const bool ok = r0 + j <= last;
    cp_async4(sm + e, g + (long long)h * cap + (ok ? r0 + j : 0), ok);
  }
}

enum Phase : int { kFused = 0, kScores = 1, kValues = 2 };

// One block: keys [first, last] of (batch b, kv head kvh), split `split`.
// kScores: the K pass, scores to `scores` and the block's (max, sum of
// exp) per head to part_ml. kValues: the V pass, P from the scores and the
// row's (max, sum) over every split, P.V to part_acc. kFused (one split):
// both passes, P.V to `out`.
template <typename T, int G, int kPhase>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const long long* __restrict__ pad_len,
                    T* __restrict__ out, float* __restrict__ scores,
                    float2* __restrict__ part_ml, float* __restrict__ part_acc,
                    long long qsb, long long qsh, Strides ks, Strides vs,
                    int n_heads, int cap, const int* __restrict__ index_ptr,
                    int chunk, float scale) {
  using C = Tiles<T>;
  // the ring of K (or V) tiles and (V pass) their scores; after the V pass
  // the warps' partials over the tiles
  __shared__ __align__(16) T tiles[kStages * C::kTileElems];
  __shared__ __align__(16) float sc_s[kStages * G * C::kT];
  __shared__ __align__(16) float q_s[G][kD];
  __shared__ float p_s[kWarps][G][C::kKeys];
  __shared__ float m_s[kWarps][G], l_s[kWarps][G];
  __shared__ float row_m[G], row_l[G];
  float* acc_s = reinterpret_cast<float*>(tiles);  // [kWarps][G][kD]
  static_assert(kWarps * G * kD * 4 <= sizeof(tiles), "the partials fit the tiles");

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x, n_kv = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long slot = ((long long)b * n_kv + kvh) * splits + split;

  const int pad = (int)min(pad_len[b], (long long)cap);
  // every key up to an index past the cache is valid, as in the plain mask
  const int index = min(*index_ptr, cap - 1);
  const bool none_valid = pad > index;  // then every key, all NEG_INF
  const int lo = none_valid ? 0 : pad, hi = none_valid ? cap - 1 : index;
  const int first = max(split * chunk, lo);
  const int last = min(split * chunk + chunk - 1, hi);
  const int n_tiles = first > last ? 0 : (last - first) / C::kT + 1;
  float* srow = scores + ((long long)b * n_kv + kvh) * G * cap;  // + h * cap

  if constexpr (kPhase == kValues) {
    // the row's max and sum over its splits, in split order (the same in
    // every block of the row); an empty split has max -inf
    if (threadIdx.x < G) {
      const int h = threadIdx.x;
      const long long slot0 = ((long long)b * n_kv + kvh) * splits;
      float mx = -INFINITY, sum = 0.f;
      for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[(slot0 + s) * G + h].x);
      for (int s = 0; s < splits; ++s) {
        const float2 ml = part_ml[(slot0 + s) * G + h];
        if (ml.x != -INFINITY) sum = fmaf(ml.y, expf(ml.x - mx), sum);
      }
      row_m[h] = mx;
      row_l[h] = sum;
    }  // (a chunk with nothing to walk leaves a zero partial below)
  } else {
    if (n_tiles == 0) {  // (kScores only: one split is never empty)
      if (kPhase == kScores && threadIdx.x < G)
        part_ml[slot * G + threadIdx.x] = make_float2(-INFINITY, 0.f);
      return;
    }
    // ---- the K pass: scores, and the online max and sum of exp per head
    const T* kb = k + b * ks.b + kvh * ks.h;
    // tiles 0 .. kStages - 2 in flight; one commit group a tile (empty past
    // the last), so "tile it has landed" is "all but kStages - 2 groups"
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_tiles)
        decode_tile_async(tiles + st * C::kTileElems, kb, ks.s, first + st * C::kT,
                          last);
      cp_async_commit();
    }
    for (int e = threadIdx.x; e < G * kD; e += kDecodeThreads) {
      const int h = e / kD, d = e % kD;
      q_s[h][d] = to_f32(q[b * qsb + (long long)(kvh * G + h) * qsh + d]);
    }
    // Per thread, an online max and sum of exp for the heads it holds: all
    // G on the CUDA cores (fp32); heads 2 tq and 2 tq + 1 of the mma's C
    // fragment on the tensor cores (bf16).
    constexpr int kHeld = kMma<T> ? 2 : G;
    float m[kHeld], l[kHeld];
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
    }
    // The tensor-core route: S^T = K Q^T, m16n8k16, the warp's 16 keys as A
    // (ldmatrix from the tile), the G <= 8 queries as B (n = 8; heads past
    // G are zeros), held in registers for the whole walk.
    const int gr = lane >> 2, tq = lane & 3;
    uint32_t qb[4][2];
    for (int it = 0; it < n_tiles; ++it) {
      // tile it has landed and every warp is past tile it - 1, whose
      // buffer then takes tile it + kStages - 1 while tile it computes
      cp_async_wait_group<kStages - 2>();
      __syncthreads();
      const int t0 = first + it * C::kT;
      const int ahead = it + kStages - 1;
      if (ahead < n_tiles)
        decode_tile_async(tiles + (ahead % kStages) * C::kTileElems, kb, ks.s,
                          first + ahead * C::kT, last);
      cp_async_commit();
      const T* kt = tiles + (it % kStages) * C::kTileElems;
      if constexpr (kMma<T>) {
        if (it == 0) {  // q_s has landed (the barrier above)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* qr = q_s[gr < G ? gr : 0] + 16 * kk + 2 * tq;
            qb[kk][0] = gr < G ? pack_bf16(qr[0], qr[1]) : 0u;
            qb[kk][1] = gr < G ? pack_bf16(qr[8], qr[9]) : 0u;
          }
        }
        uint32_t kf[4][4];
        load_a(kf, kt, warp * C::kKeys, lane);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma(c, kf[kk], qb[kk][0], qb[kk][1]);
        // c[2 r + e]: key gr + 8 r of the warp's 16, head 2 tq + e
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int h = 2 * tq + e;
          float sc[2], mt = -INFINITY;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = t0 + warp * C::kKeys + gr + 8 * r;
            sc[r] = j > last ? -INFINITY : none_valid ? kNegInf : c[2 * r + e] * scale;
            if (j <= last && h < G) srow[(long long)h * cap + j] = sc[r];
            mt = fmaxf(mt, sc[r]);
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
          const float m_new = fmaxf(m[e], mt);
          // a warp that has seen no key in range keeps m = -inf: no rescale
          const float alpha = m_new == -INFINITY ? 1.f : expf(m[e] - m_new);
          float p = 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (sc[r] != -INFINITY) p += expf(sc[r] - m_new);
          l[e] = fmaf(l[e], alpha, p);
          m[e] = m_new;
        }
      } else {
        // the CUDA cores: kL lanes a key, each over 16 bytes x kParts of it
        const int key_l = lane / C::kL, piece = lane % C::kL;
        const int row = warp * C::kKeys + key_l;  // tile row of this lane's key
        float dot[G];
#pragma unroll
        for (int h = 0; h < G; ++h) dot[h] = 0.f;
#pragma unroll
        for (int c = 0; c < C::kParts; ++c) {
          const int d0 = (c * C::kL + piece) * C::kVec;
          float kf[C::kVec];
          to_f32x(kt + row * C::kRow + d0, kf);
#pragma unroll
          for (int h = 0; h < G; ++h)
#pragma unroll
            for (int e = 0; e < C::kVec; ++e)
              dot[h] = fmaf(q_s[h][d0 + e], kf[e], dot[h]);
        }
        const int j = t0 + row;
        const bool in_range = j <= last;
#pragma unroll
        for (int h = 0; h < kHeld; ++h) {
#pragma unroll
          for (int off = 1; off < C::kL; off <<= 1)
            dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], off);
          const float sc = none_valid ? kNegInf : dot[h] * scale;
          if (in_range && piece == 0) srow[(long long)h * cap + j] = sc;
          float mt = in_range ? sc : -INFINITY;
#pragma unroll
          for (int off = C::kL; off < 32; off <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
          const float m_new = fmaxf(m[h], mt);
          const float alpha = m_new == -INFINITY ? 1.f : expf(m[h] - m_new);
          const float p = in_range && piece == 0 ? expf(sc - m_new) : 0.f;
          l[h] = fmaf(l[h], alpha, p);
          m[h] = m_new;
        }
      }
    }
    // the warp's sums over its lanes; its max is already warp-wide
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
#pragma unroll
      for (int off = kMma<T> ? 4 : 1; off < 32; off <<= 1)
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
      const int head = kMma<T> ? 2 * tq + h : h;
      if ((kMma<T> ? gr == 0 : lane == 0) && head < G) {
        m_s[warp][head] = m[h];
        l_s[warp][head] = l[h];
      }
    }
    __syncthreads();
    if (threadIdx.x < G) {  // the block's max and sum, warps in order
      const int h = threadIdx.x;
      float mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][h]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (m_s[w][h] != -INFINITY) sum = fmaf(l_s[w][h], expf(m_s[w][h] - mx), sum);
      if constexpr (kPhase == kScores) {
        part_ml[slot * G + h] = make_float2(mx, sum);
      } else {
        row_m[h] = mx;
        row_l[h] = sum;
      }
    }
    if constexpr (kPhase == kScores) return;
  }  // (the barrier above also published this block's scores to its V pass)

  // ---- the V pass: P = exp(score - max) / sum rounded to the element type,
  // then P.V in fp32; each warp owns kT / 4 keys of a tile, each lane 2 dims
  const T* vb = v + b * vs.b + kvh * vs.h;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      const int r0 = first + st * C::kT;
      decode_tile_async(tiles + st * C::kTileElems, vb, vs.s, r0, last);
      score_tile_async<T, G>(sc_s + st * G * C::kT, srow, cap, r0, last);
    }
    cp_async_commit();
  }
  float acc[G][2];
#pragma unroll
  for (int h = 0; h < G; ++h) acc[h][0] = acc[h][1] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_group<kStages - 2>();
    __syncthreads();  // also publishes row_m / row_l before the first tile
    const int t0 = first + it * C::kT;
    const int ahead = it + kStages - 1;
    if (ahead < n_tiles) {
      const int nb = ahead % kStages;
      const int r0 = first + ahead * C::kT;
      decode_tile_async(tiles + nb * C::kTileElems, vb, vs.s, r0, last);
      score_tile_async<T, G>(sc_s + nb * G * C::kT, srow, cap, r0, last);
    }
    cp_async_commit();
    const T* vt = tiles + (it % kStages) * C::kTileElems;
    const float* sc = sc_s + (it % kStages) * G * C::kT;
    for (int e = lane; e < G * C::kKeys; e += 32) {
      const int h = e / C::kKeys, jj = e % C::kKeys;
      const int kk = warp * C::kKeys + jj;
      p_s[warp][h][jj] = t0 + kk <= last
          ? round_as<T>(expf(sc[h * C::kT + kk] - row_m[h]) / row_l[h]) : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < C::kKeys; ++jj) {
      const float2 vv = load2(vt + (warp * C::kKeys + jj) * C::kRow + 2 * lane);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float p = p_s[warp][h][jj];
        acc[h][0] = fmaf(p, vv.x, acc[h][0]);
        acc[h][1] = fmaf(p, vv.y, acc[h][1]);
      }
    }
    __syncwarp();
  }

  // the warps' sums, in warp order (the tiles are no longer read)
  __syncthreads();
#pragma unroll
  for (int h = 0; h < G; ++h) {
    acc_s[(warp * G + h) * kD + 2 * lane] = acc[h][0];
    acc_s[(warp * G + h) * kD + 2 * lane + 1] = acc[h][1];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * kD; e += kDecodeThreads) {
    const int h = e / kD, d = e % kD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += acc_s[(w * G + h) * kD + d];
    if constexpr (kPhase == kFused)
      out[((long long)b * n_heads + kvh * G + h) * kD + d] = from_f32<T>(o);
    else
      part_acc[slot * G * kD + e] = o;
  }
}

// out[b, kvh * G + h] = the sum of the splits' P.V partials of (b, kvh),
// in split order. One block per (kv head, batch row), one thread per
// (head, dim).
template <typename T, int G>
__global__ void __launch_bounds__(G * kD)
flash_decode_merge_kernel(const float* __restrict__ part_acc, T* __restrict__ out,
                          int n_heads, int splits) {
  const int kvh = blockIdx.x, b = blockIdx.y, n_kv = gridDim.x;
  const long long slot0 = ((long long)b * n_kv + kvh) * splits;
  float o = 0.f;
  for (int s = 0; s < splits; ++s) o += part_acc[(slot0 + s) * G * kD + threadIdx.x];
  out[((long long)b * n_heads + kvh * G) * kD + threadIdx.x] = from_f32<T>(o);
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, const long long* pad,
           void* out, void* scratch, long long qsb, long long qsh, Strides ks, Strides vs, int batch, int n_heads,
           int n_kv, int cap, const int* index, int splits, int chunk, float scale,
           cudaStream_t st) {
  // scratch: scores (B, n_kv, G, cap); with splits, then P.V partials (B,
  // n_kv, splits, G, 64) and (max, sum) (B, n_kv, splits, G)
  float* scores = static_cast<float*>(scratch);
  float* part_acc = scores + ((long long)batch * n_heads * cap + 3) / 4 * 4;
  float2* part_ml = reinterpret_cast<float2*>(
      part_acc + (long long)batch * n_heads * splits * kD);
  const dim3 grid(splits, n_kv, batch);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  T* to = static_cast<T*>(out);
  if (splits == 1) {
    flash_decode_kernel<T, G, kFused><<<grid, kDecodeThreads, 0, st>>>(
        tq, tk, tv, pad, to, scores, nullptr, nullptr, qsb, qsh, ks, vs, n_heads,
        cap, index, chunk, scale);
    return (int)cudaGetLastError();
  }
  flash_decode_kernel<T, G, kScores><<<grid, kDecodeThreads, 0, st>>>(
      tq, tk, tv, pad, to, scores, part_ml, part_acc, qsb, qsh, ks, vs, n_heads,
      cap, index, chunk, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  flash_decode_kernel<T, G, kValues><<<grid, kDecodeThreads, 0, st>>>(
      tq, tk, tv, pad, to, scores, part_ml, part_acc, qsb, qsh, ks, vs, n_heads,
      cap, index, chunk, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_decode_merge_kernel<T, G><<<dim3(n_kv, batch), G * kD, 0, st>>>(
      part_acc, to, n_heads, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, const long long* pad,
        void* out, void* scratch, long long qsb, long long qsh,
        Strides ks, Strides vs, int batch, int n_heads, int n_kv, int cap,
        const int* index, int splits, int chunk, float scale, cudaStream_t st) {
#define CSM_DECODE_G(G)                                                          \
  case G:                                                                        \
    return launch<T, G>(q, k, v, pad, out, scratch, qsb, qsh, ks, vs, batch,     \
                        n_heads, n_kv, cap, index, splits, chunk, scale, st);
  switch (n_heads / n_kv) {
    CSM_DECODE_G(1)
    CSM_DECODE_G(2)
    CSM_DECODE_G(4)
    CSM_DECODE_G(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CSM_DECODE_G
}

}  // namespace

// q: (B, H, 1, 64) with element strides qsb, qsh; k/v: (B, n_kv, cap, 64)
// with the given element strides (innermost contiguous, rows 16-byte
// aligned); pad_len: (B,) int64; out: (B, H, 1, 64) contiguous. H / n_kv in
// {1, 2, 4, 8}; index: one int32 in device memory, the slot this step
// wrote (read by the kernel, so a captured launch follows the cache; an
// index >= cap reads as cap - 1, below 0 as no valid key). The cache is
// walked in `splits` chunks of `chunk` keys (chunk a multiple of 64, splits
// * chunk >= cap > (splits - 1) * chunk). `scratch`: fp32, B * H * cap values rounded up to a multiple
// of 4, and with splits > 1 B * H * splits * 66 more. One launch with one
// split, else three. Returns cudaGetLastError().
extern "C" int csm_flash_decode(const void* q, const void* k, const void* v,
                                const void* pad_len, void* out, void* scratch,
                                long long qsb, long long qsh,
                                long long ksb, long long ksh, long long kss,
                                long long vsb, long long vsh, long long vss,
                                int batch, int n_heads, int n_kv, int cap,
                                const void* index, int splits, int chunk, int head_dim,
                                float scale, int dtype, void* stream) {
  if (head_dim != kD || n_kv <= 0 || n_heads % n_kv != 0 || index == nullptr ||
      splits < 1 || chunk < 1 || chunk % 64 != 0 ||
      (long long)splits * chunk < cap || (long long)(splits - 1) * chunk >= cap ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  const long long* pl = static_cast<const long long*>(pad_len);
  const int* idx = static_cast<const int*>(index);
  if (dtype == kF32)
    return run<float>(q, k, v, pl, out, scratch, qsb, qsh, ks, vs, batch,
                      n_heads, n_kv, cap, idx, splits, chunk, scale, st);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(q, k, v, pl, out, scratch, qsb, qsh, ks, vs,
                              batch, n_heads, n_kv, cap, idx, splits, chunk,
                              scale, st);
  return (int)cudaErrorInvalidValue;
}
