// One backbone decode step of the int8 and int4 tiers for Hopper (sm_90a).
//
// Replaces csm_tpu/ops/bb_kernel.py::bb_decode_step with bits=8 and bits=4
// (the Pallas TPU kernel built by _make_kernel; its arithmetic is the
// emulator's int8 and int4 branches, emulate_bb_decode_step).  Same function: from the frame's embedding
// sum h0, for B <= 32 streams, 16 Llama layers with int8 per-output-channel
// weights (W8A16) whose RMSNorm weights are folded in, so each pre-norm
// product runs on bf16(h) of the raw f32 residual and RMSNorm's per-row scale
// rs = rsqrt(mean(h^2) + eps) multiplies its output: qkv = (x W) s rs; RoPE in
// f32 at each stream's own position; GQA over the stream's biased KV window
// plus its new row with bf16 operands, f32 scores and softmax, bf16
// probabilities; h += (bf16(attn) Wo) s; gated = silu(g) u in f32; h +=
// (bf16(gated) Wdown) s.  Then nh = h rs final_norm and the c0 logits
// bf16((bf16(h) Whead) s rs) (the final norm folded into the head).  It
// returns nh, the logits and the new K/V rows, and never writes the cache.
//
// The int4 tier (bb_decode_q4_step) stores the four layer families as
// row-packed int4 (byte row i = K-rows 2i and 2i+1, sign-extended nibbles)
// with a per-column scale s and a per-row equilibration u that multiplies
// the product's activation before its bf16 rounding: qkv = (bf16(h u_qkv) W)
// s rs, h += (bf16(attn u_wo) Wo) s, gate|up from bf16(h u_gu), h +=
// (bf16(gated u_down) Wdown) s, attn and gated kept in f32 until then.  The
// products stage x' = bf16(x u) while loading their activations; the c0
// head stays int8.  Bound: ~0.49 GB of int4 layer weights plus the 4.2 MB
// head at CSM-1B width, at least ~0.15 ms at 3.35 TB/s.
//
// What the TPU kernel did for its hardware (VMEM weight rings, permuted rotary
// columns, pltpu.bitcast to int4, one-hot head split/merge matmuls) is not
// carried over: heads keep the standard layout.
//
// Bound on the H100: the step must read every int8 weight once, ~0.97 GB of
// layer weights plus the 4.2 MB head at CSM-1B width, plus the usable KV rows
// (2 KB per slot per stream per layer): at least ~0.29 ms at 3.35 TB/s.  Its
// operations (2 B x 0.98 G) are far below the tensor cores' rate, but this
// first version runs them as fp32 FMAs on the CUDA cores, whose time passes
// the bytes' above B ~ 10.  The products use w8a16::gemm_item (weights
// streamed once into registers, applied to all B rows).  Each
// product is one launch split over K into enough blocks to fill the card,
// with fixed-order f32 partial sums reduced by the epilogue kernel that
// follows (residual, SwiGLU, attention, logits); the whole step is launched
// from one C call, as the exact tier's is.

#include <type_traits>

#include "w8a16.cuh"

namespace {

using namespace w8a16;

template <typename WT>
__global__ void __launch_bounds__(NT)
gemm_kernel(const int8_t* __restrict__ W, int K, int N, const float* x, const float* u, int R,
            int KC, float* part) {
  extern __shared__ float smem[];
  gemm_item<WT>(W, K, N, x, R, KC, blockIdx.x, blockIdx.y, part, smem, u);
}

// h = h0, xb = bf16(h), rs = RMSNorm scale; one block per stream.
__global__ void __launch_bounds__(NT)
init_kernel(const float* h0, float* h, int D, float eps, float* rs, float* xb) {
  __shared__ float red[NWARP];
  set_row(h, h0 + (size_t)blockIdx.x * D, blockIdx.x, D, eps, rs, xb, red);
}

__global__ void __launch_bounds__(NT)
residual_kernel(float* h, const float* part, int KS, int B, int D, const float* s, float eps,
                float* rs, float* xb) {
  __shared__ float red[NWARP];
  residual_row(h, part, KS, B, blockIdx.x, D, s, eps, rs, xb, red);
}

// gated = bf16(silu(g) u), or with ``raw`` (int4: the product's prescale
// rounds) the f32 value.
__global__ void __launch_bounds__(NT)
swiglu_kernel(const float* part, int KS, int B, int F, const float* s, const float* rs, int raw,
              float* gated) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e < B * F) {
    const float g = swiglu_f32(part, KS, B, F, e / F, e % F, s, __ldcg(rs + e / F));
    gated[e] = raw ? g : bf16r(g);
  }
}

// nh = h rs final_norm with rs of the final h; xb = bf16(h) for the head.
__global__ void __launch_bounds__(NT)
final_kernel(const float* h, int D, const float* fnw, float eps, float* rs, float* xb, float* nh) {
  __shared__ float red[NWARP];
  const float* hr = h + (size_t)blockIdx.x * D;
  float ss = 0.f;
  for (int n = threadIdx.x; n < D; n += NT) ss = fmaf(hr[n], hr[n], ss);
  const float rsr = __frsqrt_rn(block_sum(ss, red) / (float)D + eps);
  for (int n = threadIdx.x; n < D; n += NT) {
    nh[(size_t)blockIdx.x * D + n] = hr[n] * rsr * fnw[n];
    xb[(size_t)blockIdx.x * D + n] = bf16r(hr[n]);
  }
  if (threadIdx.x == 0) rs[blockIdx.x] = rsr;
}

__global__ void logits_kernel(const float* part, int KS, int B, int N, const float* s,
                              const float* rs, float* logits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < B * N)
    logits[e] = bf16r(split_sum(part, KS, B, N, e / N, e % N) * s[e % N] * rs[e / N]);
}

// RoPE, the new K/V rows and attention of (kv head, stream) over the
// stream's W cached keys (bias >= 0 usable) plus its new key.  The output is
// bf16-rounded unless ``raw_out`` (int4: the o-projection's prescale rounds).
__global__ void __launch_bounds__(NT)
attn_kernel(const float* part, int KS, const float* __restrict__ sq, const float* rs,
            const float* cosb, const float* sinb, const float* bias, const bf16* kc,
            const bf16* vc, bf16* nk, bf16* nv, float* attn, int B, int W, int nq, int nkv,
            int hd, float scale, int raw_out) {
  extern __shared__ float smem[];
  const int G = nq / nkv, half = hd / 2, QKVN = (nq + 2 * nkv) * hd;
  const int kvh = blockIdx.x, b = blockIdx.y;
  float* raw = smem;              // [G + 2][hd]
  float* qb = raw + (G + 2) * hd; // [G][hd]
  float* kb = qb + G * hd;        // [hd]
  float* vb = kb + hd;            // [hd]
  float* sc = vb + hd;            // [G][W + 1]
  const float rsb = rs[b];
  for (int i = threadIdx.x; i < (G + 2) * hd; i += NT) {
    const int hh = i / hd, d = i % hd;
    const int col = hh < G ? (kvh * G + hh) * hd + d
                           : (hh == G ? nq : nq + nkv) * hd + kvh * hd + d;
    raw[i] = split_sum(part, KS, B, QKVN, b, col) * sq[col] * rsb;
  }
  __syncthreads();
  const size_t row = ((size_t)b * nkv + kvh) * hd;
  for (int i = threadIdx.x; i < (G + 2) * hd; i += NT) {
    const int hh = i / hd, d = i % hd;
    const float* x = raw + hh * hd;
    if (hh == G + 1) {
      vb[d] = bf16r(x[d]);
      nv[row + d] = __float2bfloat16_rn(x[d]);
      continue;
    }
    const float xr = d < half ? -x[d + half] : x[d - half];
    const float y = __fadd_rn(__fmul_rn(x[d], cosb[b * hd + d]), __fmul_rn(xr, sinb[b * hd + d]));
    if (hh < G) {
      qb[hh * hd + d] = bf16r(y);
    } else {
      kb[d] = bf16r(y);
      nk[row + d] = __float2bfloat16_rn(y);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int w = warp; w < G * (W + 1); w += NWARP) {
    const int g = w / (W + 1), j = w % (W + 1);
    const bool ok = j == W || bias[(size_t)b * W + j] >= 0.f;
    float s = 0.f;
    for (int d = lane; d < hd; d += 32) {
      const float k = j == W ? kb[d] : __bfloat162float(kc[(((size_t)b * W + j) * nkv + kvh) * hd + d]);
      s = fmaf(qb[g * hd + d], k, s);
    }
    s = warp_sum(s);
    if (lane == 0) sc[g * (W + 1) + j] = ok ? s * scale : NEG_INF;
  }
  __syncthreads();
  if (warp < G) {
    float* sg = sc + warp * (W + 1);
    float m = -INFINITY;
    for (int j = lane; j <= W; j += 32) m = fmaxf(m, sg[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j <= W; j += 32) {
      const float e = expf(sg[j] - m);
      sg[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j <= W; j += 32) sg[j] = bf16r(sg[j] / sum);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += NT) {
    const int g = i / hd, d = i % hd;
    const float* pg = sc + g * (W + 1);
    const bf16* vp = vc + ((size_t)b * W * nkv + kvh) * hd + d;
    float acc = 0.f;
    for (int j = 0; j < W; ++j) acc = fmaf(pg[j], __bfloat162float(vp[(size_t)j * nkv * hd]), acc);
    acc = fmaf(pg[W], vb[d], acc);
    attn[(size_t)b * nq * hd + (kvh * G + g) * hd + d] = raw_out ? acc : bf16r(acc);
  }
}

#define RETURN_IF_ERR(expr)                      \
  do {                                           \
    const cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

struct Ctx {
  int B, nb;
  float* part;
  long long part_floats;
  cudaStream_t st;
};

cudaError_t n_blocks(int* nb) {
  int dev = 0, sms = 0;
  RETURN_IF_ERR(cudaGetDevice(&dev));
  RETURN_IF_ERR(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  *nb = 2 * sms;
  return cudaSuccess;
}

template <typename WT>
inline int kc_for(int K, int N, int B, int nb) {
  return pick_kc(K, N, B, Wv<WT>::MAXRW * Wv<WT>::ROWS, nb);
}

// part = x'[B, K] W[K, N] split over K (x' = bf16(x u) with a prescale u);
// returns the number of splits.  An Int4 W is row-packed, [K/2, N] bytes.
template <typename WT>
cudaError_t gemm(const Ctx& c, const float* x, const float* u, const int8_t* w, int K, int N,
                 int* ks) {
  const int kc = kc_for<WT>(K, N, c.B, c.nb);
  if (kc % (NWARP * Wv<WT>::ROWS) != 0 || (long long)(K / kc) * c.B * N > c.part_floats)
    return cudaErrorInvalidValue;
  const dim3 grid((N + TILE - 1) / TILE, K / kc);
  gemm_kernel<WT><<<grid, NT, GEMM_SMEM_FLOATS * sizeof(float), c.st>>>(w, K, N, x, u, c.B, kc,
                                                                       c.part);
  *ks = K / kc;
  return cudaGetLastError();
}

inline dim3 blocks_for(long long n) { return dim3((unsigned)((n + NT - 1) / NT)); }

// The layer weights are int8 [K, N] per layer, or with INT4 row-packed
// [K/2, N] bytes with prescales u (uqkv [L, D], uo [L, nq hd], ugu [L, D],
// udown [L, F]); the head is int8 either way.
template <bool INT4>
cudaError_t step(const float* h0, const float* cosb, const float* sinb, const float* bias,
                 const bf16* kc, const bf16* vc, const int8_t* wqkv, const int8_t* wo,
                 const int8_t* wgu, const int8_t* wdown, const int8_t* head, const float* sqkv,
                 const float* so, const float* sgu, const float* sdown, const float* shead,
                 const float* uqkv, const float* uo, const float* ugu, const float* udown,
                 const float* fnw, float* nh, float* logits, bf16* new_k, bf16* new_v, float* h,
                 float* xb, float* rs, float* attn, float* gated, const Ctx& c, int L, int D,
                 int F, int nq, int nkv, int hd, int W, int n_head, float eps) {
  typedef typename std::conditional<INT4, Int4, int8_t>::type WT;
  const int B = c.B, G = nq / nkv, QKVN = (nq + 2 * nkv) * hd, nqh = nq * hd;
  const int P = INT4 ? 2 : 1;  // K rows per stored byte row
  const float scale = (float)(1.0 / sqrt((double)hd));
  const size_t kv_layer = (size_t)B * W * nkv * hd, row_layer = (size_t)B * nkv * hd;
  const size_t att_smem = (size_t)((G + 2) * hd + G * hd + 2 * hd + G * (W + 1)) * sizeof(float);
  RETURN_IF_ERR(cudaFuncSetAttribute(gemm_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)(GEMM_SMEM_FLOATS * sizeof(float))));
  RETURN_IF_ERR(cudaFuncSetAttribute(gemm_kernel<int8_t>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)(GEMM_SMEM_FLOATS * sizeof(float))));
  RETURN_IF_ERR(cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)att_smem));
  // The operand each product stages: the int4 products read the raw f32
  // activation and round it after the prescale; the int8 ones read bf16(x).
  const float* x_pre = INT4 ? h : xb;
  auto u_at = [](const float* u, size_t off) { return INT4 ? u + off : nullptr; };
  int ks = 0;
  init_kernel<<<B, NT, 0, c.st>>>(h0, h, D, eps, rs, xb);
  RETURN_IF_ERR(cudaGetLastError());
  for (int l = 0; l < L; ++l) {
    RETURN_IF_ERR(gemm<WT>(c, x_pre, u_at(uqkv, (size_t)l * D), wqkv + (size_t)l * D / P * QKVN,
                           D, QKVN, &ks));
    attn_kernel<<<dim3(nkv, B), NT, att_smem, c.st>>>(
        c.part, ks, sqkv + (size_t)l * QKVN, rs, cosb, sinb, bias, kc + l * kv_layer,
        vc + l * kv_layer, new_k + l * row_layer, new_v + l * row_layer, attn, B, W, nq, nkv, hd,
        scale, (int)INT4);
    RETURN_IF_ERR(cudaGetLastError());
    RETURN_IF_ERR(gemm<WT>(c, attn, u_at(uo, (size_t)l * nqh), wo + (size_t)l * nqh / P * D, nqh,
                           D, &ks));
    residual_kernel<<<B, NT, 0, c.st>>>(h, c.part, ks, B, D, so + (size_t)l * D, eps, rs, xb);
    RETURN_IF_ERR(cudaGetLastError());
    RETURN_IF_ERR(gemm<WT>(c, x_pre, u_at(ugu, (size_t)l * D), wgu + (size_t)l * D / P * 2 * F,
                           D, 2 * F, &ks));
    swiglu_kernel<<<blocks_for((long long)B * F), NT, 0, c.st>>>(
        c.part, ks, B, F, sgu + (size_t)l * 2 * F, rs, (int)INT4, gated);
    RETURN_IF_ERR(cudaGetLastError());
    RETURN_IF_ERR(gemm<WT>(c, gated, u_at(udown, (size_t)l * F), wdown + (size_t)l * F / P * D, F,
                           D, &ks));
    residual_kernel<<<B, NT, 0, c.st>>>(h, c.part, ks, B, D, sdown + (size_t)l * D, eps, rs, xb);
    RETURN_IF_ERR(cudaGetLastError());
  }
  final_kernel<<<B, NT, 0, c.st>>>(h, D, fnw, eps, rs, xb, nh);
  RETURN_IF_ERR(cudaGetLastError());
  RETURN_IF_ERR(gemm<int8_t>(c, xb, nullptr, head, D, n_head, &ks));
  logits_kernel<<<blocks_for((long long)B * n_head), NT, 0, c.st>>>(c.part, ks, B, n_head, shead,
                                                                    rs, logits);
  return cudaGetLastError();
}

bool shapes_ok(int B, int D, int F, int nq, int nkv, int hd, int W, int n_head) {
  return !(B < 1 || B > 32 || nkv <= 0 || nq % nkv != 0 || hd % 2 != 0 || W < 0 ||
           D % 32 != 0 || F % 32 != 0 || (nq * hd) % 32 != 0 || ((nq + 2 * nkv) * hd) % 4 != 0 ||
           n_head % 4 != 0);
}

}  // namespace

extern "C" {

// Floats of partial-sum scratch a step needs at these shapes, for the int8
// (bits 8) or int4 (bits 4) layer weights (negative: a CUDA error code,
// negated).
long long bbq_part_floats(int B, int D, int nq, int nkv, int hd, int F, int n_head, int bits) {
  int nb = 0;
  const cudaError_t e = n_blocks(&nb);
  if (e != cudaSuccess) return -(long long)e;
  const int QKVN = (nq + 2 * nkv) * hd;
  const int rw = bits == 4 ? Wv<Int4>::MAXRW * Wv<Int4>::ROWS : Wv<int8_t>::MAXRW;
  const long long c[5] = {part_floats(D, QKVN, B, rw, nb), part_floats(nq * hd, D, B, rw, nb),
                          part_floats(D, 2 * F, B, rw, nb), part_floats(F, D, B, rw, nb),
                          part_floats(D, n_head, B, Wv<int8_t>::MAXRW, nb)};
  long long m = 0;
  for (long long x : c) m = x > m ? x : m;
  return m;
}

// All tensors contiguous on the current device.  f32: h0 [B,D], cos/sin
// [B,hd], bias [B,W], scales sqkv [L,QKVN], so [L,D], sgu [L,2F], sdown [L,D],
// shead [n_head], final_nw [D], outputs nh [B,D] and logits [B,n_head],
// scratch h, xb [B,D], rs [B], attn [B,nq hd], gated [B,F], part.  bf16: caches
// [L,B,W,nkv,hd], outputs new_k/new_v [L,B,nkv,hd].  int8: wqkv [L,D,QKVN],
// wo [L,nq hd,D], wgu [L,D,2F], wdown [L,F,D], head [D,n_head].
int bb_decode_q_step(const void* h0, const void* cosb, const void* sinb, const void* bias,
                     const void* kc, const void* vc, const void* wqkv, const void* wo,
                     const void* wgu, const void* wdown, const void* head, const void* sqkv,
                     const void* so, const void* sgu, const void* sdown, const void* shead,
                     const void* final_nw, void* nh, void* logits, void* new_k, void* new_v,
                     void* h, void* xb, void* rs, void* attn, void* gated, void* part,
                     long long part_floats_given, int L, int B, int D, int F, int nq, int nkv,
                     int hd, int W, int n_head, float eps, void* stream) {
  if (!shapes_ok(B, D, F, nq, nkv, hd, W, n_head)) return (int)cudaErrorInvalidValue;
  int nb = 0;
  const cudaError_t e = n_blocks(&nb);
  if (e != cudaSuccess) return (int)e;
  const Ctx c{B, nb, static_cast<float*>(part), part_floats_given, static_cast<cudaStream_t>(stream)};
  return (int)step<false>(
      static_cast<const float*>(h0), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<const float*>(bias),
      static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      static_cast<const int8_t*>(wqkv), static_cast<const int8_t*>(wo),
      static_cast<const int8_t*>(wgu), static_cast<const int8_t*>(wdown),
      static_cast<const int8_t*>(head), static_cast<const float*>(sqkv),
      static_cast<const float*>(so), static_cast<const float*>(sgu),
      static_cast<const float*>(sdown), static_cast<const float*>(shead), nullptr, nullptr,
      nullptr, nullptr, static_cast<const float*>(final_nw), static_cast<float*>(nh),
      static_cast<float*>(logits), static_cast<bf16*>(new_k), static_cast<bf16*>(new_v),
      static_cast<float*>(h), static_cast<float*>(xb), static_cast<float*>(rs),
      static_cast<float*>(attn), static_cast<float*>(gated), c, L, D, F, nq, nkv, hd, W, n_head,
      eps);
}

// The int4 step: as bb_decode_q_step, with wqkv [L,D/2,QKVN], wo [L,nq hd/2,D],
// wgu [L,D/2,2F], wdown [L,F/2,D] row-packed int4 bytes and the f32
// prescales uqkv [L,D], uo [L,nq hd], ugu [L,D], udown [L,F].
int bb_decode_q4_step(const void* h0, const void* cosb, const void* sinb, const void* bias,
                      const void* kc, const void* vc, const void* wqkv, const void* wo,
                      const void* wgu, const void* wdown, const void* head, const void* sqkv,
                      const void* so, const void* sgu, const void* sdown, const void* shead,
                      const void* uqkv, const void* uo, const void* ugu, const void* udown,
                      const void* final_nw, void* nh, void* logits, void* new_k, void* new_v,
                      void* h, void* xb, void* rs, void* attn, void* gated, void* part,
                      long long part_floats_given, int L, int B, int D, int F, int nq, int nkv,
                      int hd, int W, int n_head, float eps, void* stream) {
  if (!shapes_ok(B, D, F, nq, nkv, hd, W, n_head)) return (int)cudaErrorInvalidValue;
  int nb = 0;
  const cudaError_t e = n_blocks(&nb);
  if (e != cudaSuccess) return (int)e;
  const Ctx c{B, nb, static_cast<float*>(part), part_floats_given, static_cast<cudaStream_t>(stream)};
  return (int)step<true>(
      static_cast<const float*>(h0), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<const float*>(bias),
      static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      static_cast<const int8_t*>(wqkv), static_cast<const int8_t*>(wo),
      static_cast<const int8_t*>(wgu), static_cast<const int8_t*>(wdown),
      static_cast<const int8_t*>(head), static_cast<const float*>(sqkv),
      static_cast<const float*>(so), static_cast<const float*>(sgu),
      static_cast<const float*>(sdown), static_cast<const float*>(shead),
      static_cast<const float*>(uqkv), static_cast<const float*>(uo),
      static_cast<const float*>(ugu), static_cast<const float*>(udown),
      static_cast<const float*>(final_nw), static_cast<float*>(nh), static_cast<float*>(logits),
      static_cast<bf16*>(new_k), static_cast<bf16*>(new_v), static_cast<float*>(h),
      static_cast<float*>(xb), static_cast<float*>(rs), static_cast<float*>(attn),
      static_cast<float*>(gated), c, L, D, F, nq, nkv, hd, W, n_head, eps);
}

const char* bbq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
