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
// that row (each adds exactly 0 to l and to the accumulator).  A shard's
// output and lse rows are therefore bitwise equal to the unsharded kernel's,
// dead rows' output (garbage by contract: uniform over the visited keys)
// aside.
//
// Design (simple first version): one block per (64-row query tile, kv head,
// batch row); thread t owns query row t % 64 of head t / 64 of the group, with
// its q row and output accumulator in registers.  K/V tiles (32 keys in bf16,
// 16 in fp32) are staged in shared memory (read once per block for all G
// heads, as the TPU kernel folds the group into its row axis) and the scores
// of the tile sit in shared memory between the max pass and the exp / P.V
// pass.  Scalar fp32 FMAs, no tensor cores, no TMA.
//
// Bound on the H100: at the prefill shapes (S = 32..2048 frames, T = the
// cache window, hd = 64, 32 query / 8 kv heads, bf16) the bytes (q and out
// once each, ~8 KB per query frame, and k, v of the keys the causal rows can
// see, ~2 KB per key) over 3.35 TB/s exceed the causal FLOPs
// (4 * hd * nq * S^2 / 2) over 989 TFLOP/s up to S ~ 750 frames; longer
// prompts are operation-bound.  This version runs on the CUDA cores, not the
// tensor cores, so it is far from either bound: wgmma / TMA tiles are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;  // query rows per block, per head of the group
constexpr float NEG_INF = -1e9f;

// Elements of T in one 16-byte load, widened to fp32.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    if constexpr (std::is_same<T, bf16>::value) {
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < N / 2; ++e) {
        const float2 f = __bfloat1622float2(p2[e]);
        out[2 * e] = f.x;
        out[2 * e + 1] = f.y;
      }
    } else {
      const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
      for (int e = 0; e < N; ++e) out[e] = f[e];
    }
  }
  __device__ __forceinline__ static void store(T* p, const float* in) {
    uint4 u;
    if constexpr (std::is_same<T, bf16>::value) {
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < N / 2; ++e) p2[e] = __floats2bfloat162_rn(in[2 * e], in[2 * e + 1]);
    } else {
      float* f = reinterpret_cast<float*>(&u);
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = in[e];
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// Two adjacent elements of a shared-memory row, as fp32.
__device__ __forceinline__ float2 pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The probability as the P.V product takes it: in the operands' type.
template <typename T>
__device__ __forceinline__ float as_operand(float p) {
  if constexpr (std::is_same<T, bf16>::value) return __bfloat162float(__float2bfloat16_rn(p));
  return p;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(G * BQ)
flash_fwd_kernel(const T* __restrict__ q,                // [B, S, nkv*G, HD]
                 const T* __restrict__ k,                // [B, T, nkv, HD]
                 const T* __restrict__ v,                // [B, T, nkv, HD]
                 const int32_t* __restrict__ key_valid,  // [B, T]
                 T* __restrict__ o,                      // [B, S, nkv*G, HD]
                 float* __restrict__ lse,                // [B, nkv*G, S] or null
                 int S, int T_, int nkv, int causal, int q_offset, float scale) {
  constexpr int NT = G * BQ;
  constexpr int BK = sizeof(T) == 2 ? 32 : 16;  // keys per tile (shared memory < 48 KB)
  constexpr int VN = Vec<T>::N;
  const int nq = nkv * G;
  const int i0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int s = i0 + tid % BQ;  // this thread's query row (local)
  const int pos = q_offset + s;  // and its absolute position
  const int hq = kvh * G + tid / BQ;
  const bool row_ok = s < S;

  __shared__ __align__(16) T ks[BK][HD];
  __shared__ __align__(16) T vs[BK][HD];
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
    const T* qp = q + (((size_t)b * S + s) * nq + hq) * HD;
#pragma unroll
    for (int d = 0; d < HD; d += VN) Vec<T>::load(qp + d, qr + d);
  }
  float m = NEG_INF, l = 0.f;

  // Keys any row of this tile may see: causality stops at the tile's last
  // row, so window slots past its position are never read.
  const int kend = causal ? min(T_, q_offset + min(S, i0 + BQ)) : T_;
  for (int j0 = 0; j0 < kend; j0 += BK) {
    for (int idx = tid; idx < BK * HD / VN; idx += NT) {
      const int jj = idx / (HD / VN), dd = (idx % (HD / VN)) * VN;
      const int j = j0 + jj;
      uint4 kz = make_uint4(0, 0, 0, 0), vz = make_uint4(0, 0, 0, 0);
      if (j < kend) {
        const size_t off = (((size_t)b * T_ + j) * nkv + kvh) * HD + dd;
        kz = *reinterpret_cast<const uint4*>(k + off);
        vz = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[jj][dd]) = kz;
      *reinterpret_cast<uint4*>(&vs[jj][dd]) = vz;
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
        const float2 kf = pair(&ks[jj][d]);
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
      const float pv = as_operand<T>(p);
#pragma unroll
      for (int d = 0; d < HD; d += 2) {
        const float2 vf = pair(&vs[jj][d]);
        acc[d] = fmaf(pv, vf.x, acc[d]);
        acc[d + 1] = fmaf(pv, vf.y, acc[d + 1]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    const float l_safe = l > 0.f ? l : 1.f;
    T* op = o + (((size_t)b * S + s) * nq + hq) * HD;
#pragma unroll
    for (int d = 0; d < HD; d += VN) {
      float out[VN];
#pragma unroll
      for (int e = 0; e < VN; ++e) out[e] = acc[d + e] / l_safe;
      Vec<T>::store(op + d, out);
    }
    if (lse != nullptr) lse[((size_t)b * nq + hq) * S + s] = m + logf(l_safe);
  }
}

struct Args {
  const void *q, *k, *v, *valid;
  void *o, *lse;
  int B, S, T, nkv, causal, q_offset;
  float scale;
  cudaStream_t st;
};

template <typename T, int HD, int G>
int launch(const Args& a) {
  dim3 grid((a.S + BQ - 1) / BQ, a.nkv, a.B);
  flash_fwd_kernel<T, HD, G><<<grid, G * BQ, 0, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int32_t*>(a.valid), static_cast<T*>(a.o), static_cast<float*>(a.lse),
      a.S, a.T, a.nkv, a.causal, a.q_offset, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int by_group(int g, const Args& a) {
  switch (g) {
    case 1: return launch<T, HD, 1>(a);
    case 2: return launch<T, HD, 2>(a);
    case 4: return launch<T, HD, 4>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_head_dim(int hd, int g, const Args& a) {
  switch (hd) {
    case 16: return by_group<T, 16>(g, a);
    case 32: return by_group<T, 32>(g, a);
    case 64: return by_group<T, 64>(g, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B,S,nq,hd], k/v [B,T,nkv,hd] contiguous, all bf16 (fp32 = 0) or all
// fp32 (fp32 = 1); key_valid [B,T] int32; o [B,S,nq,hd] in the same type;
// lse [B,nq,S] fp32, or null for no log-sum-exp output.  hd must be 16, 32
// or 64 and nq/nkv one of 1, 2, 4.  causal = 0 lets every query see every
// valid key.  q_offset >= 0 is the absolute position of query row 0, and
// must be 0 when causal = 0.
int flash_fwd(const void* q, const void* k, const void* v, const void* key_valid, void* o,
              void* lse, int B, int S, int T, int nq, int nkv, int hd, int fp32, int causal,
              int q_offset, void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || S <= 0 || T <= 0 || B <= 0 || q_offset < 0 ||
      (!causal && q_offset != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, key_valid, o, lse, B, S, T, nkv, causal, q_offset,
               1.0f / sqrtf((float)hd), static_cast<cudaStream_t>(stream)};
  const int g = nq / nkv;
  return fp32 ? by_head_dim<float>(hd, g, a) : by_head_dim<bf16>(hd, g, a);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
