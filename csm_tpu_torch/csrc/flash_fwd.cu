// GQA flash-attention forward for Hopper (sm_90a), bf16 or fp32, causal or
// not, with an optional per-row log-sum-exp output for the backward.
//
// Replaces csm_tpu/ops/flash_attention.py::_flash_kernel (the Pallas TPU
// forward, launched by _flash_fwd_call) on the backbone prefill and the
// training forward.  Same function: for each query row of each of the G
// query heads that share a kv head, an online softmax in fp32 over key tiles
// that (causal) stops at the diagonal, keys masked by key_valid with the
// finite NEG_INF (so a row with no valid key, left padding, stays finite:
// uniform over the visited keys), probabilities cast to the operands' type
// before the P.V product (bf16 rounds them, fp32 keeps them), fp32
// accumulation, output in the operands' type.  With a non-null lse pointer
// the finalize step also writes lse = m + log(l) in fp32 ([B, nq, S]); for a
// dead row m is NEG_INF and, fp32 having an ulp of 64 there, lse rounds back
// to exactly NEG_INF, which is how the backward kernels (flash_bwd.cu) find
// such rows.
//
// q_offset (causal only) is the absolute position of query row 0: 0 for the
// prefill and one-device training, seq_rank * S_local for a shard of
// sequence-parallel training, whose keys are the whole gathered sequence.
// Key tiles always start at key 0 and go up in the same steps, so a live row
// visits the same tiles in the same order as in the unsharded launch, and the
// tiles that one launch visits and the other does not are wholly masked for
// that row (each adds exactly 0 to l and to the accumulator).  A row's sums
// never depend on the other rows of its block, so a shard's output and lse
// rows are bitwise equal to the unsharded kernel's, dead rows' output
// (garbage by contract: uniform over the visited keys) aside.
//
// Two kernels, dispatched by the operands' type:
//
// bf16, flash_fwd_wgmma_kernel (tensor cores).  One block per (128 folded
// query rows, kv head, batch row): the GQA group is folded into the row axis
// as the TPU kernel folds it, row r = position r / G, head r % G, which is
// what a TMA box {hd, G, 128 / G} over q [B, S, nq, hd] lands, so one K/V
// tile serves all G heads.  A producer warp keeps a ring of 2 K/V stages of
// 128 keys in flight by TMA (rows past T read as zero), with the tile's
// key_valid bits beside them; two consumer warpgroups own 64 folded rows
// each: S = Q.K^T by wgmma from shared memory, the mask and the online
// softmax on the accumulator registers (row max and sum by quad shuffles),
// P rounded to bf16 in registers and O += P.V by wgmma with P from
// registers and V as the transposed (MN-major) operand.  Only tiles that
// reach past the block's first position test causality; tiles past its last
// row are never loaded; causal blocks run latest first, so the long ones
// start first.
//
// fp32, flash_fwd_kernel (CUDA cores: wgmma has no fp32 operands and TF32
// would not hold the fp32 contract).  One block per (64-row query tile, kv
// head, batch row); thread t owns query row t % 64 of head t / 64 of the
// group, with its q row and accumulator in registers; 16-key K/V tiles in
// shared memory, read once per block for all G heads; the scores of a tile
// sit in shared memory between the max pass and the exp / P.V pass.
//
// Bound on the H100: at the prefill shapes (S = 32..2048 frames, T = the
// cache window, hd = 64, 32 query / 8 kv heads, bf16) the bytes (q and out
// once each, ~8 KB per query frame, and k, v of the keys the causal rows can
// see, ~2 KB per key) over 3.35 TB/s exceed the causal FLOPs
// (4 * hd * nq * S^2 / 2) over 989 TFLOP/s up to S ~ 750 frames; longer
// prompts, and training at S = 2048, are operation-bound, which only the
// tensor cores reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using namespace hopper;

constexpr float NEG_INF = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per block, per head of the group
constexpr int BK32 = 16;  // keys per tile (shared memory < 48 KB)

template <int HD, int G>
__global__ void __launch_bounds__(G * BQ)
flash_fwd_kernel(const float* __restrict__ q,              // [B, S, nkv*G, HD]
                 const float* __restrict__ k,              // [B, T, nkv, HD]
                 const float* __restrict__ v,              // [B, T, nkv, HD]
                 const int32_t* __restrict__ key_valid,    // [B, T]
                 float* __restrict__ o,                    // [B, S, nkv*G, HD]
                 float* __restrict__ lse,                  // [B, nkv*G, S] or null
                 int S, int T_, int nkv, int causal, int q_offset, float scale) {
  constexpr int NT = G * BQ;
  constexpr int BK = BK32;
  const int nq = nkv * G;
  const int i0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int s = i0 + tid % BQ;  // this thread's query row (local)
  const int pos = q_offset + s;  // and its absolute position
  const int hq = kvh * G + tid / BQ;
  const bool row_ok = s < S;

  __shared__ __align__(16) float ks[BK][HD];
  __shared__ __align__(16) float vs[BK][HD];
  __shared__ int key_ok[BK];
  __shared__ float sc[NT][BK + 1];  // +1: rows fall in distinct banks

  float qr[HD];
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (row_ok) {
    const float* qp = q + (((size_t)b * S + s) * nq + hq) * HD;
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      *reinterpret_cast<float4*>(qr + d) = *reinterpret_cast<const float4*>(qp + d);
  }
  float m = NEG_INF, l = 0.f;

  // Keys any row of this tile may see: causality stops at the tile's last
  // row, so window slots past its position are never read.
  const int kend = causal ? min(T_, q_offset + min(S, i0 + BQ)) : T_;
  for (int j0 = 0; j0 < kend; j0 += BK) {
    for (int idx = tid; idx < BK * HD / 4; idx += NT) {
      const int jj = idx / (HD / 4), dd = (idx % (HD / 4)) * 4;
      const int j = j0 + jj;
      float4 kz = make_float4(0.f, 0.f, 0.f, 0.f), vz = kz;
      if (j < kend) {
        const size_t off = (((size_t)b * T_ + j) * nkv + kvh) * HD + dd;
        kz = *reinterpret_cast<const float4*>(k + off);
        vz = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(&ks[jj][dd]) = kz;
      *reinterpret_cast<float4*>(&vs[jj][dd]) = vz;
    }
    for (int jj = tid; jj < BK; jj += NT) {
      const int j = j0 + jj;
      key_ok[jj] = (j < kend) && key_valid[(size_t)b * T_ + j] != 0;
    }
    __syncthreads();

    const int jn = min(BK, kend - j0);
    float mt = NEG_INF;
    for (int jj = 0; jj < jn; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 2) {
        const float2 kf = *reinterpret_cast<const float2*>(&ks[jj][d]);
        dot = fmaf(qr[d], kf.x, dot);
        dot = fmaf(qr[d + 1], kf.y, dot);
      }
      const bool ok = key_ok[jj] && (!causal || j0 + jj <= pos);
      const float sv = ok ? dot * scale : NEG_INF;
      sc[tid][jj] = sv;
      mt = fmaxf(mt, sv);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
    for (int jj = 0; jj < jn; ++jj) {
      const float p = expf(sc[tid][jj] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; d += 2) {
        const float2 vf = *reinterpret_cast<const float2*>(&vs[jj][d]);
        acc[d] = fmaf(p, vf.x, acc[d]);
        acc[d + 1] = fmaf(p, vf.y, acc[d + 1]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    const float l_safe = l > 0.f ? l : 1.f;
    float* op = o + (((size_t)b * S + s) * nq + hq) * HD;
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      *reinterpret_cast<float4*>(op + d) = make_float4(
          acc[d] / l_safe, acc[d + 1] / l_safe, acc[d + 2] / l_safe, acc[d + 3] / l_safe);
    if (lse != nullptr) lse[((size_t)b * nq + hq) * S + s] = m + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 128;   // folded query rows per block: 2 consumer warpgroups x 64
constexpr int TC_BK = 128;     // keys per K/V tile
constexpr int TC_STAGES = 2;   // K/V tiles in flight
constexpr int TC_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int TC_MASK_WORDS = TC_BK / 32;

// Shared memory, byte offsets from a 1024-aligned base: the swizzled tiles
// first (each a multiple of 1024 bytes), then the key bits and barriers.
template <int HD>
struct FwdSmem {
  static constexpr int ROW = 2 * HD;
  static constexpr int Q = 0;
  static constexpr int K = Q + TC_ROWS * ROW;
  static constexpr int KV_TILE = TC_BK * ROW;
  static constexpr int V = K + TC_STAGES * KV_TILE;
  static constexpr int MASK = V + TC_STAGES * KV_TILE;
  static constexpr int BAR = MASK + TC_STAGES * TC_MASK_WORDS * 4;
  static constexpr int BYTES = BAR + (2 * TC_STAGES + 1) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

template <int HD, int G>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,  // q [B, S, nkv*G, HD]
                       const __grid_constant__ CUtensorMap tk,  // k [B, T, nkv, HD]
                       const __grid_constant__ CUtensorMap tv,  // v [B, T, nkv, HD]
                       const int32_t* __restrict__ key_valid,   // [B, T]
                       bf16* __restrict__ o,                    // [B, S, nkv*G, HD]
                       float* __restrict__ lse,                 // [B, nkv*G, S] or null
                       int S, int T_, int nkv, int causal, int q_offset, float scale) {
  using L = FwdSmem<HD>;
  constexpr int P = TC_ROWS / G;  // query positions per block
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + TC_STAGES;
  uint64_t* qbar = empty + TC_STAGES;
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + L::MASK);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int qb = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // latest first
  const int s0 = qb * P;
  const int kend = causal ? min(T_, q_offset + min(S, s0 + P)) : T_;
  const int n_tiles = (kend + TC_BK - 1) / TC_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < TC_STAGES; ++i) {
      mbar_init(&full[i], 32);     // the producer warp's lanes (one also expects the bytes)
      mbar_init(&empty[i], 8);     // one lane of each consumer warp
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: warp 0 issues the loads.
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(qbar, TC_ROWS * HD * 2);
        tma_load_4d(smem + L::Q, &tq, qbar, 0, kvh * G, s0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % TC_STAGES;
        mbar_wait(&empty[st], ((it / TC_STAGES) & 1) ^ 1);
        const int j0 = it * TC_BK;
#pragma unroll
        for (int w = 0; w < TC_MASK_WORDS; ++w) {
          const int j = j0 + 32 * w + lane;
          const uint32_t bits =
              __ballot_sync(0xffffffffu, j < kend && key_valid[(size_t)b * T_ + j] != 0);
          if (lane == 0) mask[st * TC_MASK_WORDS + w] = bits;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], 2 * TC_BK * HD * 2);
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
    // This thread's two folded rows and their positions.
    const int r0 = cw * 64 + warp * 16 + g8, r1 = r0 + 8;
    const int pos0 = q_offset + s0 + r0 / G, pos1 = q_offset + s0 + r1 / G;
    const int first_pos = q_offset + s0;

    float sacc[TC_BK / 2];
    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < TC_BK / 2; ++i) sacc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    const uint32_t q_addr = smem_u32(smem + L::Q) + cw * 64 * L::ROW;
    mbar_wait(qbar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % TC_STAGES;
      mbar_wait(&full[st], (it / TC_STAGES) & 1);
      const uint32_t k_addr = smem_u32(smem + L::K + st * L::KV_TILE);
      const uint32_t v_addr = smem_u32(smem + L::V + st * L::KV_TILE);

      // S = Q K^T over hd in k16 slices.
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss<TC_BK>(sacc, desc_k<HD>(q_addr + kk * 32), desc_k<HD>(k_addr + kk * 32), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // Mask, scale, the tile's row max.
      const int j0 = it * TC_BK;
      const bool diag = causal && j0 + TC_BK - 1 > first_pos;
      uint32_t bits[TC_MASK_WORDS];
#pragma unroll
      for (int w = 0; w < TC_MASK_WORDS; ++w) bits[w] = mask[st * TC_MASK_WORDS + w];
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < TC_BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t4 + e;
          const bool ok = (bits[n / 4] >> (c % 32)) & 1u;
          const int j = j0 + c;
          const float x0 = (ok && (!diag || j <= pos0)) ? sacc[4 * n + e] * scale : NEG_INF;
          const float x1 = (ok && (!diag || j <= pos1)) ? sacc[4 * n + 2 + e] * scale : NEG_INF;
          sacc[4 * n + e] = x0;
          sacc[4 * n + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float alpha0 = exp2f((m0 - mx0) * LOG2E);
      const float alpha1 = exp2f((m1 - mx1) * LOG2E);
      m0 = mx0;
      m1 = mx1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        oacc[4 * n] *= alpha0;
        oacc[4 * n + 1] *= alpha0;
        oacc[4 * n + 2] *= alpha1;
        oacc[4 * n + 3] *= alpha1;
      }
      // P: fp32 into the row sums, bf16 into the A fragments of P.V.
      uint32_t pf[TC_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float mr = (r & 1) ? m1 : m0;
          const float pa = exp2f((sacc[8 * kk + 2 * r] - mr) * LOG2E);
          const float pb = exp2f((sacc[8 * kk + 2 * r + 1] - mr) * LOG2E);
          if (r & 1) l1 += pa + pb;
          else l0 += pa + pb;
          pf[kk][r] = pack_bf16(pa, pb);
        }
      }

      // O += P V over the tile's keys in k16 slices.
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)
        mma_rs<HD>(oacc, pf[kk], desc_mn<HD>(v_addr + kk * 16 * L::ROW));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oacc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // Row sums over the quad, then out = O / l and lse = m + log(l).
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int nq = nkv * G;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      const int s = s0 + r / G;
      if (s >= S) continue;
      const int hq = kvh * G + r % G;
      const float l = h ? l1 : l0;
      const float inv = 1.f / (l > 0.f ? l : 1.f);
      bf16* op = o + (((size_t)b * S + s) * nq + hq) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(op + 8 * n + 2 * t4) =
            pack_bf16(oacc[4 * n + 2 * h] * inv, oacc[4 * n + 2 * h + 1] * inv);
      if (lse != nullptr && t4 == 0)
        lse[((size_t)b * nq + hq) * S + s] = (h ? m1 : m0) + logf(l > 0.f ? l : 1.f);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *valid;
  void *o, *lse;
  int B, S, T, nkv, causal, q_offset;
  float scale;
  cudaStream_t st;
};

template <int HD, int G>
int launch_f32(const Args& a) {
  dim3 grid((a.S + BQ - 1) / BQ, a.nkv, a.B);
  flash_fwd_kernel<HD, G><<<grid, G * BQ, 0, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const int32_t*>(a.valid),
      static_cast<float*>(a.o), static_cast<float*>(a.lse), a.S, a.T, a.nkv, a.causal,
      a.q_offset, a.scale);
  return (int)cudaGetLastError();
}

template <int HD, int G>
int launch_bf16(const Args& a) {
  auto kernel = flash_fwd_wgmma_kernel<HD, G>;
  constexpr int smem = FwdSmem<HD>::ALLOC;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int nq = a.nkv * G;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, a.q, HD, nq, a.S, a.B, G, TC_ROWS / G) ||
      !make_map(&tk, a.k, HD, a.nkv, a.T, a.B, 1, TC_BK) ||
      !make_map(&tv, a.v, HD, a.nkv, a.T, a.B, 1, TC_BK))
    return (int)cudaErrorInvalidValue;
  const int P = TC_ROWS / G;
  dim3 grid(a.nkv, a.B, (a.S + P - 1) / P);
  kernel<<<grid, TC_THREADS, smem, a.st>>>(tq, tk, tv, static_cast<const int32_t*>(a.valid),
                                           static_cast<bf16*>(a.o), static_cast<float*>(a.lse),
                                           a.S, a.T, a.nkv, a.causal, a.q_offset, a.scale);
  return (int)cudaGetLastError();
}

template <bool F32, int HD>
int by_group(int g, const Args& a) {
  switch (g) {
    case 1: return F32 ? launch_f32<HD, 1>(a) : launch_bf16<HD, 1>(a);
    case 2: return F32 ? launch_f32<HD, 2>(a) : launch_bf16<HD, 2>(a);
    case 4: return F32 ? launch_f32<HD, 4>(a) : launch_bf16<HD, 4>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool F32>
int by_head_dim(int hd, int g, const Args& a) {
  switch (hd) {
    case 16: return by_group<F32, 16>(g, a);
    case 32: return by_group<F32, 32>(g, a);
    case 64: return by_group<F32, 64>(g, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B,S,nq,hd], k/v [B,T,nkv,hd] contiguous, all bf16 (fp32 = 0; 16-byte
// aligned, as TMA reads them) or all fp32 (fp32 = 1); key_valid [B,T] int32;
// o [B,S,nq,hd] in the same type; lse [B,nq,S] fp32, or null for no
// log-sum-exp output.  hd must be 16, 32 or 64 and nq/nkv one of 1, 2, 4.
// causal = 0 lets every query see every valid key.  q_offset >= 0 is the
// absolute position of query row 0, and must be 0 when causal = 0.
int flash_fwd(const void* q, const void* k, const void* v, const void* key_valid, void* o,
              void* lse, int B, int S, int T, int nq, int nkv, int hd, int fp32, int causal,
              int q_offset, void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || S <= 0 || T <= 0 || B <= 0 || q_offset < 0 ||
      (!causal && q_offset != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, key_valid, o, lse, B, S, T, nkv, causal, q_offset,
               1.0f / sqrtf((float)hd), static_cast<cudaStream_t>(stream)};
  const int g = nq / nkv;
  return fp32 ? by_head_dim<true>(hd, g, a) : by_head_dim<false>(hd, g, a);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
