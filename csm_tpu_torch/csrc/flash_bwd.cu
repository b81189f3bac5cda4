// Flash-attention backward for Hopper (sm_90a), bf16 or fp32: the dq kernel
// (K5a) and the dk/dv kernel (K5b).
//
// Replace csm_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (the Pallas TPU backward, launched by
// _flash_bwd_call).  Same function, the FlashAttention-2 recompute scheme:
// each score block is recomputed from q, k and the forward's saved per-row
// log-sum-exp, p = exp(s - lse), so the S x T probabilities are never stored.
// Rows whose lse is at or below NEG_INF / 2 (dead rows: every key masked)
// get p = 0 exactly, so their dq / dk / dv contributions are exactly zero.
// With dP = dO.V^T in f32 and delta = rowsum(dO * O) (computed by the caller
// in f32, as the JAX package does it in XLA):
//   dS = p * (dP - delta) * scale, rounded to the operands' type,
//   dq = dS.K                   (K5a: walks key tiles up to the diagonal),
//   dV = P~^T.dO, P~ = p rounded to dO's type,
//   dK = dS^T.Q                 (K5b: walks query tiles from the first that
//                                can see its key tile, over the g heads of
//                                the GQA group, so the group sum is in-block),
// all sums in f32, outputs in the operands' type.  No atomics: every output
// element is summed by one thread (or one wgmma accumulator register) in a
// fixed order, so two runs give bitwise-equal gradients.
//
// q_offset (causal only) is the absolute position of query row 0, as in
// flash_fwd.cu: a shard of sequence-parallel training passes seq_rank *
// S_local with k / v over the whole gathered sequence.  K5a walks the same
// key tiles from key 0 as the unsharded launch, and the tiles one launch
// visits and the other does not are wholly masked for the row (p = 0
// exactly), so a shard's dq rows are bitwise equal to the unsharded dq.
// K5b starts at the first local query tile that can see its key tile
// (_i_first of the TPU kernel); a key tile that lies wholly after the
// shard's last row visits none and is written as zeros, which the
// all-gather's backward then sums into its owner's dk / dv.
//
// On fp32 operands both kernels run on the CUDA cores (wgmma has no fp32
// operands and TF32 would not hold the fp32 contract): 256 threads per block,
// 64-row tiles staged in shared memory as fp32 with a row stride of hd + 1
// (column reads across a warp fall in distinct banks); each thread holds a
// 4 x 4 block of the 64 x 64 score tile (rows ty + 16a, keys tx + 16c) and a
// 4 x hd/16 block of its 64 x hd accumulator.  K5a: one block per (64-row
// query tile, kv head, batch row), walking the group's g heads in turn with
// that head's q / dO tile resident.  K5b: one block per (64-key tile, kv
// head, batch row).
//
// K5a on bf16 operands, flash_bwd_dq_wgmma_kernel (tensor cores): one block
// per (128 folded query rows, kv head, batch row), the GQA group folded into
// the rows as K3 folds it (row r = position r / G, head r % G: a TMA box
// {hd, G, 128 / G} over q and dO), so each K / V tile comes in once for all
// G heads; causal blocks run latest first, so the longest walks start
// first.  A producer warp keeps a ring of 2 K / V tiles of 64 keys in flight
// by TMA with their key_valid bits, from key 0 in fixed steps up to the
// block's last row.  Two consumer warpgroups own 64 folded rows each: S =
// Q.K^T and dP = dO.V^T by wgmma from shared memory, p and dS on the
// accumulator registers (dS rounded to bf16 in registers), and dQ += dS.K by
// wgmma with dS from registers and K as the transposed (MN-major) operand;
// dQ stays in fp32 registers (S, dP and dQ: three 64 x 64 fp32 tiles at hd
// 64) and is written once.
//
// K5b on bf16 operands, flash_bwd_dkv_wgmma_kernel (tensor cores): one block
// per (64-key tile, kv head, batch row), key tile 0 (the longest walk)
// first; the keys are the M axis of every product.  K and V of the block
// come once by TMA; a producer warp keeps a ring of 2 (q, dO) tiles of 64
// rows in flight by TMA, with the rows' lse and delta, walking the group's
// heads in turn from the first query tile that can see the keys.  One
// consumer warpgroup forms S^T = K.Q^T and dP^T = V.dO^T by wgmma from
// shared memory, P^T and dS^T on the accumulator registers, and adds
// dV += bf16(P^T).dO and dK += bf16(dS^T).Q by wgmma with the A operand
// from registers and dO, Q as the transposed (MN-major) operand; dK and dV
// stay in fp32 registers and are written once.  One block per SM: the
// consumer holds four 64 x 64 fp32 tiles (S^T, dP^T, dK, dV at hd 64) in
// ~170 registers without spilling, which two blocks an SM would not leave
// room for (at 128 registers it spilled ~0.5 KB a thread and ran 2.3x
// slower, and handing the producer's registers over with setmaxnreg did
// not lift ptxas's allocation: PERF.md).
//
// Bound on the H100: at CSM-1B training shapes (S = T = 2048, hd = 64, 32
// query / 8 kv heads) the backward does 14 * hd * nq * (causal pairs) flops
// (60 GFLOP a layer at B = 1) against ~34 MB of inputs and outputs, so it is
// operation-bound (0.061 ms at 989 TFLOP/s bf16), which only the tensor
// cores reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using namespace hopper;

constexpr int TILE = 64;  // query rows of a query tile, keys of a key tile
constexpr int NT = 256;   // threads per block, as 16 x 16
constexpr int LDS = TILE + 1;  // row stride of the 64 x 64 score-shaped tiles
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, bf16>::value) return __float2bfloat16_rn(x);
  else return x;
}

// x rounded to T and widened back: what a product with T operands takes.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Rows [r0, r0 + TILE) of one head of a [rows, heads, HD] slab (src points
// at row 0 of that head; consecutive rows are row_stride elements apart)
// into a fp32 tile of row stride HD + 1.  Rows at or past n_rows read as 0.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int n_rows, size_t row_stride) {
  for (int idx = threadIdx.x; idx < TILE * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * (HD + 1) + d] = row < n_rows ? to_f(src[(size_t)row * row_stride + d]) : 0.f;
  }
}

// The 4 x 4 score block of this thread: s = q.k and dp = dO.v for query rows
// ty + 16a and keys tx + 16c of the staged tiles.
template <int HD>
__device__ __forceinline__ void score_block(const float* sQ, const float* sdO, const float* sK,
                                            const float* sV, int ty, int tx, float (&s)[4][4],
                                            float (&dp)[4][4]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[4], da[4], kc[4], vc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sQ[(ty + 16 * a) * LD + d];
      da[a] = sdO[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = sK[(tx + 16 * c) * LD + d];
      vc[c] = sV[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(da[a], vc[c], dp[a][c]);
      }
  }
}

// p of one score (row at absolute position pos): masked keys (invalid, or
// after the row when causal) take
// NEG_INF; dead rows (lse <= NEG_INF / 2) take 0.
__device__ __forceinline__ float prob(float dot, float scale, bool key_ok, int pos, int key,
                                      int causal, float lse) {
  const bool ok = key_ok && (!causal || key <= pos);
  const float s = ok ? dot * scale : NEG_INF;
  return lse <= NEG_INF / 2 ? 0.f : expf(s - lse);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * TILE * (HD + 1) + TILE * LDS + 2 * TILE) + sizeof(int) * TILE;
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * TILE * (HD + 1) + 2 * TILE * LDS + 2 * TILE) + sizeof(int) * TILE;
}

template <int HD, int G>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q,              // [B, S, nkv*G, HD]
                    const float* __restrict__ k,              // [B, T, nkv, HD]
                    const float* __restrict__ v,              // [B, T, nkv, HD]
                    const int32_t* __restrict__ key_valid,    // [B, T]
                    const float* __restrict__ dout,           // [B, S, nkv*G, HD]
                    const float* __restrict__ lse,            // [B, nkv*G, S]
                    const float* __restrict__ delta,          // [B, nkv*G, S]
                    float* __restrict__ dq,                   // [B, S, nkv*G, HD]
                    int S, int T_, int nkv, int causal, int q_offset, float scale) {
  typedef float T;
  constexpr int LD = HD + 1;
  constexpr int DE = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + TILE * LD;
  float* sK = sdO + TILE * LD;
  float* sV = sK + TILE * LD;
  float* sdS = sV + TILE * LD;  // [TILE][LDS]
  float* sL = sdS + TILE * LDS;
  float* sD = sL + TILE;
  int* sOk = reinterpret_cast<int*>(sD + TILE);

  const int nq = nkv * G;
  const int i0 = blockIdx.x * TILE;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // Keys any row of this tile may see: causality stops at its last row.
  const int kend = causal ? min(T_, q_offset + min(S, i0 + TILE)) : T_;
  const size_t kv_off = ((size_t)b * T_ * nkv + kvh) * HD;

  for (int gi = 0; gi < G; ++gi) {
    const int hq = kvh * G + gi;
    const size_t q_off = ((size_t)b * S * nq + hq) * HD;
    load_tile<T, HD>(sQ, q + q_off, i0, S, (size_t)nq * HD);
    load_tile<T, HD>(sdO, dout + q_off, i0, S, (size_t)nq * HD);
    for (int r = tid; r < TILE; r += NT) {
      const int row = i0 + r;
      const size_t o = ((size_t)b * nq + hq) * S + row;
      sL[r] = row < S ? lse[o] : NEG_INF;
      sD[r] = row < S ? delta[o] : 0.f;
    }
    float acc[4][DE];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < DE; ++e) acc[a][e] = 0.f;

    for (int j0 = 0; j0 < kend; j0 += TILE) {
      __syncthreads();  // the last tile's readers of sK / sdS are done
      load_tile<T, HD>(sK, k + kv_off, j0, kend, (size_t)nkv * HD);
      load_tile<T, HD>(sV, v + kv_off, j0, kend, (size_t)nkv * HD);
      for (int c = tid; c < TILE; c += NT) {
        const int j = j0 + c;
        sOk[c] = j < kend && key_valid[(size_t)b * T_ + j] != 0;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      score_block<HD>(sQ, sdO, sK, sV, ty, tx, s, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const float p = prob(s[a][c], scale, sOk[col] != 0, q_offset + i0 + r, j0 + col,
                               causal, sL[r]);
          sdS[r * LDS + col] = round_to<T>(p * (dp[a][c] - sD[r]) * scale);
        }
      }
      __syncthreads();
      // dq rows ty + 16a, dims tx + 16e: += dS . K over this key tile.
#pragma unroll 4
      for (int c = 0; c < TILE; ++c) {
        float kk[DE];
#pragma unroll
        for (int e = 0; e < DE; ++e) kk[e] = sK[c * LD + tx + 16 * e];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float w = sdS[(ty + 16 * a) * LDS + c];
#pragma unroll
          for (int e = 0; e < DE; ++e) acc[a][e] = fmaf(w, kk[e], acc[a][e]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = i0 + ty + 16 * a;
      if (row < S) {
        T* out = dq + q_off + (size_t)row * nq * HD;
#pragma unroll
        for (int e = 0; e < DE; ++e) out[tx + 16 * e] = from_f<T>(acc[a][e]);
      }
    }
    __syncthreads();  // before the next head overwrites sQ / sdO / sL / sD
  }
}

template <int HD, int G>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q,              // [B, S, nkv*G, HD]
                     const float* __restrict__ k,              // [B, T, nkv, HD]
                     const float* __restrict__ v,              // [B, T, nkv, HD]
                     const int32_t* __restrict__ key_valid,    // [B, T]
                     const float* __restrict__ dout,           // [B, S, nkv*G, HD]
                     const float* __restrict__ lse,            // [B, nkv*G, S]
                     const float* __restrict__ delta,          // [B, nkv*G, S]
                     float* __restrict__ dk,                   // [B, T, nkv, HD]
                     float* __restrict__ dv,                   // [B, T, nkv, HD]
                     int S, int T_, int nkv, int causal, int q_offset, float scale) {
  typedef float T;
  constexpr int LD = HD + 1;
  constexpr int DE = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + TILE * LD;
  float* sQ = sV + TILE * LD;
  float* sdO = sQ + TILE * LD;
  float* sP = sdO + TILE * LD;  // [TILE][LDS], p rounded to dO's type
  float* sdS = sP + TILE * LDS;
  float* sL = sdS + TILE * LDS;
  float* sD = sL + TILE;
  int* sOk = reinterpret_cast<int*>(sD + TILE);

  const int nq = nkv * G;
  const int j0 = blockIdx.x * TILE;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t kv_off = ((size_t)b * T_ * nkv + kvh) * HD;

  load_tile<T, HD>(sK, k + kv_off, j0, T_, (size_t)nkv * HD);
  load_tile<T, HD>(sV, v + kv_off, j0, T_, (size_t)nkv * HD);
  for (int c = tid; c < TILE; c += NT) {
    const int j = j0 + c;
    sOk[c] = j < T_ && key_valid[(size_t)b * T_ + j] != 0;
  }
  float dk_acc[4][DE], dv_acc[4][DE];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < DE; ++e) dk_acc[a][e] = dv_acc[a][e] = 0.f;

  // The first local query tile that can see this key tile (local row r sees
  // key j when j <= q_offset + r); at or past S when none can.
  const int i_start = (causal && j0 > q_offset) ? ((j0 - q_offset) / TILE) * TILE : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int hq = kvh * G + gi;
    const size_t q_off = ((size_t)b * S * nq + hq) * HD;
    for (int i0 = i_start; i0 < S; i0 += TILE) {
      __syncthreads();  // the last tile's readers of sQ / sdO / sP / sdS are done
      load_tile<T, HD>(sQ, q + q_off, i0, S, (size_t)nq * HD);
      load_tile<T, HD>(sdO, dout + q_off, i0, S, (size_t)nq * HD);
      for (int r = tid; r < TILE; r += NT) {
        const int row = i0 + r;
        const size_t o = ((size_t)b * nq + hq) * S + row;
        sL[r] = row < S ? lse[o] : NEG_INF;
        sD[r] = row < S ? delta[o] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      score_block<HD>(sQ, sdO, sK, sV, ty, tx, s, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const float p = prob(s[a][c], scale, sOk[col] != 0, q_offset + i0 + r, j0 + col,
                               causal, sL[r]);
          sP[r * LDS + col] = round_to<T>(p);
          sdS[r * LDS + col] = round_to<T>(p * (dp[a][c] - sD[r]) * scale);
        }
      }
      __syncthreads();
      // Keys ty + 16a, dims tx + 16e: dV += P~^T . dO, dK += dS^T . Q.
#pragma unroll 4
      for (int r = 0; r < TILE; ++r) {
        float qv[DE], dov[DE];
#pragma unroll
        for (int e = 0; e < DE; ++e) {
          qv[e] = sQ[r * LD + tx + 16 * e];
          dov[e] = sdO[r * LD + tx + 16 * e];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float pw = sP[r * LDS + ty + 16 * a];
          const float dw = sdS[r * LDS + ty + 16 * a];
#pragma unroll
          for (int e = 0; e < DE; ++e) {
            dv_acc[a][e] = fmaf(pw, dov[e], dv_acc[a][e]);
            dk_acc[a][e] = fmaf(dw, qv[e], dk_acc[a][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j < T_) {
      const size_t o = kv_off + (size_t)j * nkv * HD;
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        dk[o + tx + 16 * e] = from_f<T>(dk_acc[a][e]);
        dv[o + tx + 16 * e] = from_f<T>(dv_acc[a][e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5b for bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_KEYS = 64;      // keys per block: one consumer warpgroup
constexpr int TC_BQ = 64;        // query rows per step of the walk
constexpr int TC_STAGES = 2;     // Q / dO tiles in flight
constexpr int TC_THREADS = 256;  // producer warpgroup + consumer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, byte offsets from a 1024-aligned base: the resident K and V
// tiles, the ring of Q and dO tiles (each 64 swizzled rows, a multiple of
// 1024 bytes), then per stage the rows' lse (times log2 e; +inf marks a dead
// row or one past S, whose p is then exactly 0) and delta, and the barriers.
template <int HD>
struct DkvSmem {
  static constexpr int ROW = 2 * HD;
  static constexpr int TILE = 64 * ROW;
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int Q = 2 * TILE;
  static constexpr int DO = Q + TC_STAGES * TILE;
  static constexpr int LSE = DO + TC_STAGES * TILE;
  static constexpr int DELTA = LSE + TC_STAGES * TC_BQ * 4;
  static constexpr int BAR = DELTA + TC_STAGES * TC_BQ * 4;
  static constexpr int BYTES = BAR + (2 * TC_STAGES + 1) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

template <int HD, int G>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,   // q [B, S, nkv*G, HD]
                           const __grid_constant__ CUtensorMap tk,   // k [B, T, nkv, HD]
                           const __grid_constant__ CUtensorMap tv,   // v [B, T, nkv, HD]
                           const __grid_constant__ CUtensorMap tdo,  // dout [B, S, nkv*G, HD]
                           const int32_t* __restrict__ key_valid,    // [B, T]
                           const float* __restrict__ lse,            // [B, nkv*G, S]
                           const float* __restrict__ delta,          // [B, nkv*G, S]
                           bf16* __restrict__ dk,                    // [B, T, nkv, HD]
                           bf16* __restrict__ dv,                    // [B, T, nkv, HD]
                           int S, int T_, int nkv, int causal, int q_offset, float scale) {
  using L = DkvSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + TC_STAGES;
  uint64_t* kvbar = empty + TC_STAGES;
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int j0 = blockIdx.z * TC_KEYS;  // key block 0, which walks every query tile, first
  const int nq = nkv * G;
  // The first local query tile that can see this key block (local row r
  // sees key j when j <= q_offset + r); none when it is at or past S.
  const int i_start = (causal && j0 > q_offset) ? ((j0 - q_offset) / TC_BQ) * TC_BQ : 0;
  const int per_head = i_start < S ? (S - i_start + TC_BQ - 1) / TC_BQ : 0;
  const int n_steps = G * per_head;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < TC_STAGES; ++i) {
      mbar_init(&full[i], 32);  // the producer warp's lanes (one also expects the bytes)
      mbar_init(&empty[i], 4);  // one lane of each consumer warp
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0 && n_steps > 0) {
        mbar_arrive_expect_tx(kvbar, 2 * TC_KEYS * HD * 2);
        tma_load_4d(smem + L::K, &tk, kvbar, 0, kvh, j0, b);
        tma_load_4d(smem + L::V, &tv, kvbar, 0, kvh, j0, b);
      }
      // Steps in a fixed order: the group's heads, each from i_start on.
      for (int it = 0; it < n_steps; ++it) {
        const int st = it % TC_STAGES;
        mbar_wait(&empty[st], ((it / TC_STAGES) & 1) ^ 1);
        const int hq = kvh * G + it / per_head;
        const int i0 = i_start + (it % per_head) * TC_BQ;
        for (int c = lane; c < TC_BQ; c += 32) {
          const int row = i0 + c;
          const size_t off = ((size_t)b * nq + hq) * S + row;
          const float l = row < S ? lse[off] : NEG_INF;
          lse_s[st * TC_BQ + c] = l <= NEG_INF / 2 ? INFINITY : l * LOG2E;
          delta_s[st * TC_BQ + c] = row < S ? delta[off] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], 2 * TC_BQ * HD * 2);
          tma_load_4d(smem + L::Q + st * L::TILE, &tq, &full[st], 0, hq, i0, b);
          tma_load_4d(smem + L::DO + st * L::TILE, &tdo, &full[st], 0, hq, i0, b);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    const int tid = threadIdx.x - 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g8 = lane / 4, t4 = lane % 4;
    // This thread's two keys (rows of the transposed tiles).
    const int key0 = j0 + warp * 16 + g8, key1 = key0 + 8;
    const bool ok0 = key0 < T_ && key_valid[(size_t)b * T_ + key0] != 0;
    const bool ok1 = key1 < T_ && key_valid[(size_t)b * T_ + key1] != 0;
    const float scale_log2 = scale * LOG2E;

    float dk_acc[HD / 2], dv_acc[HD / 2];
    float sacc[TC_BQ / 2], pacc[TC_BQ / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < TC_BQ / 2; ++i) sacc[i] = pacc[i] = 0.f;

    const uint32_t k_addr = smem_u32(smem + L::K);
    const uint32_t v_addr = smem_u32(smem + L::V);
    if (n_steps > 0) mbar_wait(kvbar, 0);
    for (int it = 0; it < n_steps; ++it) {
      const int st = it % TC_STAGES;
      mbar_wait(&full[st], (it / TC_STAGES) & 1);
      const int i0 = i_start + (it % per_head) * TC_BQ;
      const uint32_t q_addr = smem_u32(smem + L::Q + st * L::TILE);
      const uint32_t do_addr = smem_u32(smem + L::DO + st * L::TILE);

      // S^T = K Q^T and dP^T = V dO^T over hd in k16 slices.
      fence_regs(sacc);
      fence_regs(pacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss<TC_BQ>(sacc, desc_k<HD>(k_addr + kk * 32), desc_k<HD>(q_addr + kk * 32), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss<TC_BQ>(pacc, desc_k<HD>(v_addr + kk * 32), desc_k<HD>(do_addr + kk * 32), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);
      fence_regs(pacc);

      // p = exp(s scale - lse) (0 where masked or dead), dS = p (dP - delta)
      // scale; both rounded to bf16 as the next products' A fragments.
      const bool diag = causal && j0 + TC_KEYS - 1 > q_offset + i0;
      const float* ls = lse_s + st * TC_BQ;
      const float* dl = delta_s + st * TC_BQ;
#pragma unroll
      for (int n = 0; n < TC_BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t4 + e;
          const int pos = q_offset + i0 + c;
          const float lc = ls[c], dc = dl[c];
          const float p0 =
              (ok0 && (!diag || key0 <= pos)) ? exp2f(sacc[4 * n + e] * scale_log2 - lc) : 0.f;
          const float p1 =
              (ok1 && (!diag || key1 <= pos)) ? exp2f(sacc[4 * n + 2 + e] * scale_log2 - lc) : 0.f;
          pacc[4 * n + e] = p0 * (pacc[4 * n + e] - dc) * scale;
          pacc[4 * n + 2 + e] = p1 * (pacc[4 * n + 2 + e] - dc) * scale;
          sacc[4 * n + e] = p0;
          sacc[4 * n + 2 + e] = p1;
        }
      }
      uint32_t pf[TC_BQ / 16][4], sf[TC_BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < TC_BQ / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pf[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
          sf[kk][r] = pack_bf16(pacc[8 * kk + 2 * r], pacc[8 * kk + 2 * r + 1]);
        }
      }

      // dV += P~^T dO and dK += dS^T Q over the tile's query rows.
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BQ / 16; ++kk)
        mma_rs<HD>(dv_acc, pf[kk], desc_mn<HD>(do_addr + kk * 16 * L::ROW));
#pragma unroll
      for (int kk = 0; kk < TC_BQ / 16; ++kk)
        mma_rs<HD>(dk_acc, sf[kk], desc_mn<HD>(q_addr + kk * 16 * L::ROW));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // Every key of the block is written: zeros where no row saw it.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = h ? key1 : key0;
      if (key >= T_) continue;
      const size_t off = (((size_t)b * T_ + key) * nkv + kvh) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * n + 2 * t4) =
            pack_bf16(dk_acc[4 * n + 2 * h], dk_acc[4 * n + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * n + 2 * t4) =
            pack_bf16(dv_acc[4 * n + 2 * h], dv_acc[4 * n + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5a for bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int DQ_ROWS = 128;     // folded query rows per block: 2 consumer warpgroups x 64
constexpr int DQ_BK = 64;        // keys per K/V tile
constexpr int DQ_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int DQ_MASK_WORDS = DQ_BK / 32;

// Shared memory, byte offsets from a 1024-aligned base: the block's Q and dO
// tiles (128 folded rows each), the ring of K and V tiles, then the key
// bits of each stage and the barriers.
template <int HD>
struct DqSmem {
  static constexpr int ROW = 2 * HD;
  static constexpr int Q = 0;
  static constexpr int DO = DQ_ROWS * ROW;
  static constexpr int KV_TILE = DQ_BK * ROW;
  static constexpr int K = 2 * DQ_ROWS * ROW;
  static constexpr int V = K + TC_STAGES * KV_TILE;
  static constexpr int MASK = V + TC_STAGES * KV_TILE;
  static constexpr int BAR = MASK + TC_STAGES * DQ_MASK_WORDS * 4;
  static constexpr int BYTES = BAR + (2 * TC_STAGES + 1) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

template <int HD, int G>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,   // q [B, S, nkv*G, HD]
                          const __grid_constant__ CUtensorMap tk,   // k [B, T, nkv, HD]
                          const __grid_constant__ CUtensorMap tv,   // v [B, T, nkv, HD]
                          const __grid_constant__ CUtensorMap tdo,  // dout [B, S, nkv*G, HD]
                          const int32_t* __restrict__ key_valid,    // [B, T]
                          const float* __restrict__ lse,            // [B, nkv*G, S]
                          const float* __restrict__ delta,          // [B, nkv*G, S]
                          bf16* __restrict__ dq,                    // [B, S, nkv*G, HD]
                          int S, int T_, int nkv, int causal, int q_offset, float scale) {
  using L = DqSmem<HD>;
  constexpr int P = DQ_ROWS / G;  // query positions per block
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + TC_STAGES;
  uint64_t* qbar = empty + TC_STAGES;
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + L::MASK);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int qb = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // longest walks first
  const int s0 = qb * P;
  // Keys any row of this block may see: causality stops at its last row.
  const int kend = causal ? min(T_, q_offset + min(S, s0 + P)) : T_;
  const int n_tiles = (kend + DQ_BK - 1) / DQ_BK;
  const int nq = nkv * G;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < TC_STAGES; ++i) {
      mbar_init(&full[i], 32);  // the producer warp's lanes (one also expects the bytes)
      mbar_init(&empty[i], 8);  // one lane of each consumer warp
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(qbar, 2 * DQ_ROWS * HD * 2);
        tma_load_4d(smem + L::Q, &tq, qbar, 0, kvh * G, s0, b);
        tma_load_4d(smem + L::DO, &tdo, qbar, 0, kvh * G, s0, b);
      }
      // Key tiles from key 0 in steps of DQ_BK, as every launch walks them.
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % TC_STAGES;
        mbar_wait(&empty[st], ((it / TC_STAGES) & 1) ^ 1);
        const int j0 = it * DQ_BK;
#pragma unroll
        for (int w = 0; w < DQ_MASK_WORDS; ++w) {
          const int j = j0 + 32 * w + lane;
          const uint32_t bits =
              __ballot_sync(0xffffffffu, j < kend && key_valid[(size_t)b * T_ + j] != 0);
          if (lane == 0) mask[st * DQ_MASK_WORDS + w] = bits;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], 2 * DQ_BK * HD * 2);
          tma_load_4d(smem + L::K + st * L::KV_TILE, &tk, &full[st], 0, kvh, j0, b);
          tma_load_4d(smem + L::V + st * L::KV_TILE, &tv, &full[st], 0, kvh, j0, b);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g8 = lane / 4, t4 = lane % 4;
    // This thread's two folded rows: local positions, heads, absolute
    // positions, lse (times log2 e; +inf for a dead row or one past S, whose
    // p is then exactly 0) and delta.
    const int r0 = cw * 64 + warp * 16 + g8, r1 = r0 + 8;
    const int sr0 = s0 + r0 / G, sr1 = s0 + r1 / G;
    const int hq0 = kvh * G + r0 % G, hq1 = kvh * G + r1 % G;
    const int pos0 = q_offset + sr0, pos1 = q_offset + sr1;
    const int first_pos = q_offset + s0;
    float ls0 = INFINITY, ls1 = INFINITY, dl0 = 0.f, dl1 = 0.f;
    if (sr0 < S) {
      const size_t o = ((size_t)b * nq + hq0) * S + sr0;
      const float l = lse[o];
      ls0 = l <= NEG_INF / 2 ? INFINITY : l * LOG2E;
      dl0 = delta[o];
    }
    if (sr1 < S) {
      const size_t o = ((size_t)b * nq + hq1) * S + sr1;
      const float l = lse[o];
      ls1 = l <= NEG_INF / 2 ? INFINITY : l * LOG2E;
      dl1 = delta[o];
    }
    const float scale_log2 = scale * LOG2E;

    float sacc[DQ_BK / 2], pacc[DQ_BK / 2], dq_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; ++i) sacc[i] = pacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;

    const uint32_t q_addr = smem_u32(smem + L::Q) + cw * 64 * L::ROW;
    const uint32_t do_addr = smem_u32(smem + L::DO) + cw * 64 * L::ROW;
    mbar_wait(qbar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % TC_STAGES;
      mbar_wait(&full[st], (it / TC_STAGES) & 1);
      const uint32_t k_addr = smem_u32(smem + L::K + st * L::KV_TILE);
      const uint32_t v_addr = smem_u32(smem + L::V + st * L::KV_TILE);

      // S = Q K^T and dP = dO V^T over hd in k16 slices.
      fence_regs(sacc);
      fence_regs(pacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss<DQ_BK>(sacc, desc_k<HD>(q_addr + kk * 32), desc_k<HD>(k_addr + kk * 32), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss<DQ_BK>(pacc, desc_k<HD>(do_addr + kk * 32), desc_k<HD>(v_addr + kk * 32), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);
      fence_regs(pacc);

      // p = exp(s scale - lse), 0 where masked or dead; dS = p (dP - delta)
      // scale, rounded to bf16 as the A fragments of dQ += dS K.
      const int j0 = it * DQ_BK;
      const bool diag = causal && j0 + DQ_BK - 1 > first_pos;
      uint32_t bits[DQ_MASK_WORDS];
#pragma unroll
      for (int w = 0; w < DQ_MASK_WORDS; ++w) bits[w] = mask[st * DQ_MASK_WORDS + w];
#pragma unroll
      for (int n = 0; n < DQ_BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t4 + e;
          const bool ok = (bits[c / 32] >> (c % 32)) & 1u;
          const int j = j0 + c;
          const float p0 =
              (ok && (!diag || j <= pos0)) ? exp2f(sacc[4 * n + e] * scale_log2 - ls0) : 0.f;
          const float p1 =
              (ok && (!diag || j <= pos1)) ? exp2f(sacc[4 * n + 2 + e] * scale_log2 - ls1) : 0.f;
          pacc[4 * n + e] = p0 * (pacc[4 * n + e] - dl0) * scale;
          pacc[4 * n + 2 + e] = p1 * (pacc[4 * n + 2 + e] - dl1) * scale;
        }
      }
      uint32_t sf[DQ_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sf[kk][r] = pack_bf16(pacc[8 * kk + 2 * r], pacc[8 * kk + 2 * r + 1]);

      // dQ += dS K over the tile's keys, K as the transposed (MN-major) operand.
      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk)
        mma_rs<HD>(dq_acc, sf[kk], desc_mn<HD>(k_addr + kk * 16 * L::ROW));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = h ? sr1 : sr0;
      if (s >= S) continue;
      bf16* op = dq + (((size_t)b * S + s) * nq + (h ? hq1 : hq0)) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(op + 8 * n + 2 * t4) =
            pack_bf16(dq_acc[4 * n + 2 * h], dq_acc[4 * n + 2 * h + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *valid, *dout, *lse, *delta;
  void *o0, *o1;  // dq, or dk and dv
  int B, S, T, nkv, causal, q_offset;
  float scale;
  cudaStream_t st;
};

// Shared memory above 48 KB has to be asked for once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD, int G>
int launch_dq(const Args& a) {
  if constexpr (std::is_same<T, float>::value) {
    auto kernel = flash_bwd_dq_kernel<HD, G>;
    constexpr size_t smem = dq_smem_bytes<HD>();
    static const cudaError_t attr = allow_smem(kernel, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((a.S + TILE - 1) / TILE, a.nkv, a.B);
    kernel<<<grid, NT, smem, a.st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const int32_t*>(a.valid),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(a.o0), a.S, a.T, a.nkv,
        a.causal, a.q_offset, a.scale);
  } else {
    auto kernel = flash_bwd_dq_wgmma_kernel<HD, G>;
    constexpr int smem = DqSmem<HD>::ALLOC;
    static const cudaError_t attr = allow_smem(kernel, smem);
    if (attr != cudaSuccess) return (int)attr;
    const int nq = a.nkv * G;
    CUtensorMap tq, tk, tv, tdo;
    if (!make_map(&tq, a.q, HD, nq, a.S, a.B, G, DQ_ROWS / G) ||
        !make_map(&tdo, a.dout, HD, nq, a.S, a.B, G, DQ_ROWS / G) ||
        !make_map(&tk, a.k, HD, a.nkv, a.T, a.B, 1, DQ_BK) ||
        !make_map(&tv, a.v, HD, a.nkv, a.T, a.B, 1, DQ_BK))
      return (int)cudaErrorInvalidValue;
    const int P = DQ_ROWS / G;
    dim3 grid(a.nkv, a.B, (a.S + P - 1) / P);
    kernel<<<grid, DQ_THREADS, smem, a.st>>>(
        tq, tk, tv, tdo, static_cast<const int32_t*>(a.valid), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.o0), a.S, a.T, a.nkv, a.causal,
        a.q_offset, a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int HD, int G>
int launch_dkv(const Args& a) {
  if constexpr (std::is_same<T, float>::value) {
    auto kernel = flash_bwd_dkv_kernel<HD, G>;
    constexpr size_t smem = dkv_smem_bytes<HD>();
    static const cudaError_t attr = allow_smem(kernel, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((a.T + TILE - 1) / TILE, a.nkv, a.B);
    kernel<<<grid, NT, smem, a.st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const int32_t*>(a.valid),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(a.o0),
        static_cast<float*>(a.o1), a.S, a.T, a.nkv, a.causal, a.q_offset, a.scale);
  } else {
    auto kernel = flash_bwd_dkv_wgmma_kernel<HD, G>;
    constexpr int smem = DkvSmem<HD>::ALLOC;
    static const cudaError_t attr = allow_smem(kernel, smem);
    if (attr != cudaSuccess) return (int)attr;
    const int nq = a.nkv * G;
    CUtensorMap tq, tk, tv, tdo;
    if (!make_map(&tq, a.q, HD, nq, a.S, a.B, 1, TC_BQ) ||
        !make_map(&tdo, a.dout, HD, nq, a.S, a.B, 1, TC_BQ) ||
        !make_map(&tk, a.k, HD, a.nkv, a.T, a.B, 1, TC_KEYS) ||
        !make_map(&tv, a.v, HD, a.nkv, a.T, a.B, 1, TC_KEYS))
      return (int)cudaErrorInvalidValue;
    dim3 grid(a.nkv, a.B, (a.T + TC_KEYS - 1) / TC_KEYS);
    kernel<<<grid, TC_THREADS, smem, a.st>>>(
        tq, tk, tv, tdo, static_cast<const int32_t*>(a.valid), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.o0), static_cast<bf16*>(a.o1),
        a.S, a.T, a.nkv, a.causal, a.q_offset, a.scale);
  }
  return (int)cudaGetLastError();
}

template <bool DQ, typename T, int HD>
int by_group(int g, const Args& a) {
  switch (g) {
    case 1: return DQ ? launch_dq<T, HD, 1>(a) : launch_dkv<T, HD, 1>(a);
    case 2: return DQ ? launch_dq<T, HD, 2>(a) : launch_dkv<T, HD, 2>(a);
    case 4: return DQ ? launch_dq<T, HD, 4>(a) : launch_dkv<T, HD, 4>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ, typename T>
int by_head_dim(int hd, int g, const Args& a) {
  switch (hd) {
    case 16: return by_group<DQ, T, 16>(g, a);
    case 32: return by_group<DQ, T, 32>(g, a);
    case 64: return by_group<DQ, T, 64>(g, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
int dispatch(int nq, int hd, int fp32, const Args& a) {
  if (a.nkv <= 0 || nq % a.nkv != 0 || a.S <= 0 || a.T <= 0 || a.B <= 0 || a.q_offset < 0 ||
      (!a.causal && a.q_offset != 0))
    return (int)cudaErrorInvalidValue;
  const int g = nq / a.nkv;
  return fp32 ? by_head_dim<DQ, float>(hd, g, a) : by_head_dim<DQ, bf16>(hd, g, a);
}

}  // namespace

extern "C" {

// q / dout [B,S,nq,hd] and k / v [B,T,nkv,hd] contiguous, all bf16 (fp32 =
// 0) or all fp32 (fp32 = 1); key_valid [B,T] int32; lse and delta [B,nq,S]
// fp32.  hd must be 16, 32 or 64 and nq/nkv one of 1, 2, 4.  q_offset >= 0
// is the absolute position of query row 0 (0 when causal = 0).
//
// K5a: dq [B,S,nq,hd] in the operands' type.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* key_valid,
                 const void* dout, const void* lse, const void* delta, void* dq, int B, int S,
                 int T, int nq, int nkv, int hd, int fp32, int causal, int q_offset,
                 void* stream) {
  const Args a{q, k, v, key_valid, dout, lse, delta, dq, nullptr, B, S, T, nkv, causal,
               q_offset, 1.0f / sqrtf((float)hd), static_cast<cudaStream_t>(stream)};
  return dispatch<true>(nq, hd, fp32, a);
}

// K5b: dk and dv [B,T,nkv,hd] in the operands' type.
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* key_valid,
                  const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                  int B, int S, int T, int nq, int nkv, int hd, int fp32, int causal,
                  int q_offset, void* stream) {
  const Args a{q, k, v, key_valid, dout, lse, delta, dk, dv, B, S, T, nkv, causal, q_offset,
               1.0f / sqrtf((float)hd), static_cast<cudaStream_t>(stream)};
  return dispatch<false>(nq, hd, fp32, a);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
