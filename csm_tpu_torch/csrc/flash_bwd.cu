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
// element is summed by one thread in a fixed order, so two runs give
// bitwise-equal gradients.
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
// Design (simple first version): 256 threads per block, 64-row tiles staged
// in shared memory as fp32 with a row stride of hd + 1 (column reads across
// a warp fall in distinct banks); each thread holds a 4 x 4 block of the
// 64 x 64 score tile (rows ty + 16a, keys tx + 16c) and a 4 x hd/16 block of
// its 64 x hd accumulator.  K5a: one block per (64-row query tile, kv head,
// batch row), walking the group's g heads in turn with that head's q / dO
// tile resident.  K5b: one block per (64-key tile, kv head, batch row).
// Scalar fp32 FMAs on the CUDA cores, no tensor cores, no TMA.
//
// Bound on the H100: at CSM-1B training shapes (S = T = 2048, hd = 64, 32
// query / 8 kv heads) the backward does 14 * hd * nq * (causal pairs) flops
// (60 GFLOP a layer at B = 1) against ~34 MB of inputs and outputs, so it is
// operation-bound (0.061 ms at 989 TFLOP/s bf16).  This version runs on the
// CUDA cores, far from that: mma / wgmma tiles and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q,                // [B, S, nkv*G, HD]
                    const T* __restrict__ k,                // [B, T, nkv, HD]
                    const T* __restrict__ v,                // [B, T, nkv, HD]
                    const int32_t* __restrict__ key_valid,  // [B, T]
                    const T* __restrict__ dout,             // [B, S, nkv*G, HD]
                    const float* __restrict__ lse,          // [B, nkv*G, S]
                    const float* __restrict__ delta,        // [B, nkv*G, S]
                    T* __restrict__ dq,                     // [B, S, nkv*G, HD]
                    int S, int T_, int nkv, int causal, int q_offset, float scale) {
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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q,                // [B, S, nkv*G, HD]
                     const T* __restrict__ k,                // [B, T, nkv, HD]
                     const T* __restrict__ v,                // [B, T, nkv, HD]
                     const int32_t* __restrict__ key_valid,  // [B, T]
                     const T* __restrict__ dout,             // [B, S, nkv*G, HD]
                     const float* __restrict__ lse,          // [B, nkv*G, S]
                     const float* __restrict__ delta,        // [B, nkv*G, S]
                     T* __restrict__ dk,                     // [B, T, nkv, HD]
                     T* __restrict__ dv,                     // [B, T, nkv, HD]
                     int S, int T_, int nkv, int causal, int q_offset, float scale) {
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
  auto kernel = flash_bwd_dq_kernel<T, HD, G>;
  constexpr size_t smem = dq_smem_bytes<HD>();
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.S + TILE - 1) / TILE, a.nkv, a.B);
  kernel<<<grid, NT, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int32_t*>(a.valid), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.o0), a.S, a.T, a.nkv, a.causal, a.q_offset, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD, int G>
int launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<T, HD, G>;
  constexpr size_t smem = dkv_smem_bytes<HD>();
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.T + TILE - 1) / TILE, a.nkv, a.B);
  kernel<<<grid, NT, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int32_t*>(a.valid), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.S, a.T, a.nkv, a.causal, a.q_offset,
      a.scale);
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
