// Building blocks of the port's W8A16 / W4A16 backbone steps (bb_decode_q.cu,
// the int8 and int4 tiers); fused_decoder.cu takes its small helpers
// (bf16r, warp_sum, warp_max, NT, NWARP, NEG_INF).
//
// The weight products are skinny: y[R, N] = x[R, K] W[K, N] with R <= 64
// rows of bf16-valued activations against int8 or row-packed int4 weights,
// far below the card's ops-per-byte balance,
// so they are bound by the bytes of W.  gemm_item streams one work item, 128
// columns by KC rows of W, into registers once with 4-column loads (a warp
// reads 128 contiguous int8 columns of a row in one transaction; every thread
// keeps up to 32 loads in flight, 16 of packed int4 covering 32 K rows), then
// applies it to the item's activations, staged in shared memory, in chunks of
// RB rows.
// Staging may multiply each activation by a per-K prescale and round the
// product to bf16 (the int4 tier's equilibration u).  int8 / int4 x bf16
// products are exact in f32, so each sum is exact up to the f32 additions,
// which run in a fixed order: along K inside a warp, over the 8 warps in
// shared memory, and over the K splits (partials [KS, R, N] in global memory)
// in the caller's epilogue.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace w8a16 {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;             // threads per block
constexpr int NWARP = NT / 32;
constexpr int TILE = 128;           // columns per work item: 32 lanes x 4
constexpr int X_FLOATS = 8192;      // staged activations per item (rows x depth)
constexpr int RB_MAX = 8;           // activation rows per register chunk
constexpr int GEMM_SMEM_FLOATS = X_FLOATS + NWARP * RB_MAX * TILE;
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block in a fixed order; every thread gets the total.
// ``red`` holds NWARP floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < NWARP; ++i) t += red[i];
  return t;
}

// The weight types: 4 adjacent columns per load, the most loads a thread
// keeps in registers, the K rows one load covers (ROWS) and the stored type
// (S).  Int4 tags row-packed int4: byte row i of a [K/2, N] matrix holds
// K-rows 2i (low nibble) and 2i+1 (high nibble) of the same column.
struct Int4 {};
template <typename WT> struct Wv;
template <> struct Wv<int8_t> {
  typedef int8_t S;
  typedef int T;
  static constexpr int MAXRW = 32;
  static constexpr int ROWS = 1;
  __device__ static T load(const int8_t* p) { return __ldg(reinterpret_cast<const int*>(p)); }
  __device__ static T zero() { return 0; }
  __device__ static void unpack(T v, float f[4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = (float)(signed char)((v >> (8 * c)) & 0xff);
  }
};
template <> struct Wv<Int4> {
  typedef int8_t S;
  typedef int T;
  static constexpr int MAXRW = 16;  // 32 K rows: at 32 loads the unpacked nibbles spill
  static constexpr int ROWS = 2;
  __device__ static T load(const int8_t* p) { return __ldg(reinterpret_cast<const int*>(p)); }
  __device__ static T zero() { return 0; }
  // Sign-extended nibbles of the 4 columns: lo = row 2i, hi = row 2i+1.
  __device__ static void unpack2(T v, float lo[4], float hi[4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = (v >> (8 * c)) & 0xff;
      lo[c] = (float)((signed char)(b << 4) >> 4);
      hi[c] = (float)((signed char)b >> 4);
    }
  }
};

// Rows of W per K split for a [K, N] product at R activation rows: as deep
// as the registers (``maxrw`` K rows a thread) and the staging buffer allow,
// then halved while the items number fewer than ``nblocks``.  Host and device
// agree on it.
__host__ __device__ inline int pick_kc(int K, int N, int R, int maxrw, int nblocks) {
  const int tiles = (N + TILE - 1) / TILE;
  const int rpad = (R + RB_MAX - 1) / RB_MAX * RB_MAX;
  int kc = NWARP * maxrw;
  while (kc > NWARP && (K % kc != 0 || rpad * kc > X_FLOATS)) kc /= 2;
  while (kc > 4 * NWARP && tiles * (K / kc) < nblocks) kc /= 2;
  return kc;
}

// Floats of partial sums a [K, N] product at R rows writes.
__host__ __device__ inline long long part_floats(int K, int N, int R, int maxrw, int nblocks) {
  return (long long)(K / pick_kc(K, N, R, maxrw, nblocks)) * R * N;
}

// One work item: part[(ks R + r) N + n] = sum_{k in split ks} x'[r, k] W[k, n]
// for the 128 columns of tile ct.  x is [R, K] f32 holding the operand's
// values (bf16-rounded where the product takes bf16 activations); with a
// prescale u [K], x' = bf16(x u), else x' = x.  For Int4, KC / NWARP must be
// even (each load covers two K rows).
template <typename WT, int RB>
__device__ void gemm_item_rb(const typename Wv<WT>::S* __restrict__ W, int K, int N,
                             const float* x, const float* __restrict__ u, int R, int KC, int ct,
                             int ks, float* __restrict__ part, float* smem) {
  using L = Wv<WT>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RW = KC / NWARP;     // K rows per warp
  const int NL = RW / L::ROWS;   // loads per thread
  const int Rpad = (R + RB - 1) / RB * RB;
  float* xs = smem;               // [Rpad][KC]
  float* red = smem + Rpad * KC;  // [NWARP][RB][TILE]
  const int k0 = ks * KC;
  const int col = ct * TILE + lane * 4;
  __syncthreads();
  for (int i = threadIdx.x; i < Rpad * KC; i += NT) {
    const int r = i / KC, c = i % KC;
    float v = 0.f;
    if (r < R) {
      v = __ldcg(x + (size_t)r * K + k0 + c);
      if (u != nullptr) v = bf16r(v * __ldg(u + k0 + c));
    }
    xs[i] = v;
  }
  typename L::T wr[L::MAXRW];
  const size_t row0 = (size_t)(k0 + warp * RW) / L::ROWS;
#pragma unroll
  for (int j = 0; j < L::MAXRW; ++j)
    wr[j] = (j < NL && col < N) ? L::load(W + (row0 + j) * N + col) : L::zero();
  __syncthreads();
  for (int rc = 0; rc < Rpad; rc += RB) {
    float acc[RB][4];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[rr][c] = 0.f;
#pragma unroll
    for (int j = 0; j < L::MAXRW; ++j) {
      if (j < NL) {
        const float* xr = xs + rc * KC + warp * RW + j * L::ROWS;
        if constexpr (L::ROWS == 1) {
          float wf[4];
          L::unpack(wr[j], wf);
#pragma unroll
          for (int rr = 0; rr < RB; ++rr) {
            const float xv = xr[rr * KC];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[rr][c] = fmaf(xv, wf[c], acc[rr][c]);
          }
        } else {
          float lo[4], hi[4];
          L::unpack2(wr[j], lo, hi);
#pragma unroll
          for (int rr = 0; rr < RB; ++rr) {
            const float x0 = xr[rr * KC], x1 = xr[rr * KC + 1];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[rr][c] = fmaf(x1, hi[c], fmaf(x0, lo[c], acc[rr][c]));
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(warp * RB + rr) * TILE + lane * 4 + c] = acc[rr][c];
    __syncthreads();
    for (int i = threadIdx.x; i < RB * TILE; i += NT) {
      const int rr = i / TILE, cc = i % TILE, r = rc + rr, n = ct * TILE + cc;
      if (r < R && n < N) {
        float s = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < NWARP; ++w8) s += red[(w8 * RB + rr) * TILE + cc];
        part[((size_t)ks * R + r) * N + n] = s;
      }
    }
    __syncthreads();
  }
}

template <typename WT>
__device__ void gemm_item(const typename Wv<WT>::S* W, int K, int N, const float* x, int R, int KC,
                          int ct, int ks, float* part, float* smem, const float* u = nullptr) {
  if (R >= 8) gemm_item_rb<WT, 8>(W, K, N, x, u, R, KC, ct, ks, part, smem);
  else if (R >= 4) gemm_item_rb<WT, 4>(W, K, N, x, u, R, KC, ct, ks, part, smem);
  else if (R >= 2) gemm_item_rb<WT, 2>(W, K, N, x, u, R, KC, ct, ks, part, smem);
  else gemm_item_rb<WT, 1>(W, K, N, x, u, R, KC, ct, ks, part, smem);
}

// Sum of the KS partials of element (r, n) of an [R, N] product, in order.
__device__ __forceinline__ float split_sum(const float* part, int KS, int R, int N, int r, int n) {
  float a = 0.f;
  for (int ks = 0; ks < KS; ++ks) a += __ldcg(part + ((size_t)ks * R + r) * N + n);
  return a;
}

// Row r of the residual: h += (x W) * s over D columns; then rs[r] =
// rsqrt(mean(h^2) + eps) (RMSNorm's scale, applied to the next products'
// outputs: the norm weight is folded into the weights) and xb[r] = bf16(h),
// the next product's operand.  Returns rs[r] to every thread.
__device__ inline float residual_row(float* h, const float* part, int KS, int R, int r, int D,
                                     const float* __restrict__ s, float eps, float* rs, float* xb,
                                     float* red) {
  float ss = 0.f;
  for (int n = threadIdx.x; n < D; n += NT) {
    const float v = __ldcg(h + (size_t)r * D + n) + split_sum(part, KS, R, D, r, n) * __ldg(s + n);
    h[(size_t)r * D + n] = v;
    xb[(size_t)r * D + n] = bf16r(v);
    ss = fmaf(v, v, ss);
  }
  const float rsr = __frsqrt_rn(block_sum(ss, red) / (float)D + eps);
  if (threadIdx.x == 0) rs[r] = rsr;
  return rsr;
}

// Row r set to src (f32 values): h, xb and rs as residual_row leaves them.
__device__ inline float set_row(float* h, const float* src, int r, int D, float eps, float* rs,
                                float* xb, float* red) {
  float ss = 0.f;
  for (int n = threadIdx.x; n < D; n += NT) {
    const float v = src[n];
    h[(size_t)r * D + n] = v;
    xb[(size_t)r * D + n] = bf16r(v);
    ss = fmaf(v, v, ss);
  }
  const float rsr = __frsqrt_rn(block_sum(ss, red) / (float)D + eps);
  if (threadIdx.x == 0) rs[r] = rsr;
  return rsr;
}

// SwiGLU of element (r, n) from gate | up partials [KS, R, 2F]:
// g = (acc s) rs, u likewise; returns g sigmoid(g) u in f32.
__device__ __forceinline__ float swiglu_f32(const float* part, int KS, int R, int F, int r, int n,
                                            const float* __restrict__ s, float rsr) {
  const float g = split_sum(part, KS, R, 2 * F, r, n) * __ldg(s + n) * rsr;
  const float u = split_sum(part, KS, R, 2 * F, r, F + n) * __ldg(s + F + n) * rsr;
  return g * (1.f / (1.f + expf(-g))) * u;
}

}  // namespace w8a16
