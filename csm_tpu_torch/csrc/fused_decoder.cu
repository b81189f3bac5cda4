// The fused codebook loop for Hopper (sm_90a): all codebooks of one frame in
// one persistent cooperative kernel.
//
// Replaces csm_tpu/ops/fused_decoder.py::fused_decode_codebooks (the Pallas
// TPU kernel built by _make_kernel).  Same function: sample c0 from the
// backbone's bf16-rounded logits, prefill the 4-layer decoder with
// [proj(h); proj(embed(c0))] at positions 0..1, then for each codebook i in
// 1..N-1 apply head slice i-1 to the last hidden, draw (top-k by a 16-step
// bisection over the logits' bf16 bit patterns, then Gumbel-max with the
// given noise; greedy is a first-index argmax), honour the forced prefix, and
// (except after the last codebook) run one decoder pass on the drawn token's
// pre-projected embedding.  Weights are int8 per output channel with the
// RMSNorm weights folded in (W8A16): each pre-norm product runs on the raw
// residual and RMSNorm's per-row scale multiplies its output; the residual
// stream is f32.  Attention has bf16 operands (q, the K/V scratch, the
// probabilities) with f32 scores and softmax, as the TPU kernel's.
//
// What the TPU kernel did for its hardware is not carried over: there it kept
// ~106 MB of int8 weights resident in VMEM for all 31 passes.  An H100 has a
// 50 MB L2 and 227 KB of shared memory per block, so here every pass streams
// the weights from device memory, and the kernel is bound by those bytes:
// 31 passes x the decoder's int8 weights plus 31 head slices, ~1.07 ms per
// frame at 3.35 TB/s (bf16 head; ~1.05 ms int8).  Design: one cooperative
// launch (every block resident, sized from the occupancy API) walks the
// frame's stages with a grid-wide barrier between dependent ones: per layer
// QKV product | RoPE, K/V write and attention per (stream, kv head) | o-proj |
// residual and RMSNorm scale per row | gate-up | SwiGLU | down | residual;
// per codebook the head product | the draw, one block per stream.  Products
// are w8a16::gemm_item work items spread over all blocks, with fixed-order
// f32 partial sums, so the result does not depend on the grid.  The K/V
// scratch ([L, B, nkv, NP, hd] bf16), the activations and the noise rows
// live in global memory; data another block wrote is read through L2
// (__ldcg).

#include "w8a16.cuh"

namespace {

using namespace w8a16;

constexpr int HD_MAX = 128;
constexpr int G_MAX = 8;
constexpr int NP_MAX = 64;

struct Params {
  int B, N, Va, Va_pad, D, L, nq, nkv, hd, F, NP;
  int greedy, head_kind, emb_bf16;  // head_kind: 0 bf16, 1 int8 (+ scale), 2 f32
  float eps, scale;
  const float* temp;    // [B]
  const int* topk;      // [B], in [1, Va]
  const int* forced;    // [B, N], -1 = draw
  const float* x0;      // [B, D]
  const float* c0lg;    // [B, Va], bf16-rounded
  const int8_t *wqkv, *wo, *wgu, *wdown;  // [L, K, N]
  const float *sqkv, *so, *sgu, *sdown;   // [L, N]
  const float *cosb, *sinb;               // [P, hd]
  const void* head;                       // [N-1, D, Va_pad]
  const float* head_scale;                // [N-1, Va_pad] (int8 head)
  const float* gumbel;                    // [N, B, Va]
  const void* emb;                        // [rows, D] bf16 or f32
  int* samples;                           // [B, N]
  float* out_logits;                      // [N, B, Va_pad] or null
  int* out_draws;                         // [B, N] or null
  float *h, *xb, *rs, *attn, *gated, *hx, *part;  // scratch
  bf16 *kc, *vc;                          // [L, B, nkv, NP, hd]
  unsigned* bar;                          // [2], zero
};

// Grid-wide barrier (every block is resident: cooperative launch).  bar[0]
// counts arrivals, bar[1] is the generation the last arrival advances.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename WT>
__device__ void gemm_stage(const WT* W, int K, int N, const float* x, int R, float* part,
                           float* smem) {
  const int kc = pick_kc(K, N, R, Wv<WT>::MAXRW, gridDim.x);
  const int tiles = (N + TILE - 1) / TILE, items = tiles * (K / kc);
  for (int it = blockIdx.x; it < items; it += gridDim.x)
    gemm_item<WT>(W, K, N, x, R, kc, it % tiles, it / tiles, part, smem);
}

__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// One draw from lg[0..Va) (shared memory): first-index argmax of the raw
// logits (greedy), else of top-k(lg) / max(temp, 1e-6) + gumbel, the top k
// kept with ties at the k-th value.
__device__ int draw(const float* lg, int Va, const float* gum, float temp, int topk, bool greedy,
                    float* redf, int* redi) {
  unsigned kth = 0u;
  const float t = fmaxf(temp, 1e-6f);
  if (!greedy) {
    for (int bit = 0; bit < 16; ++bit) {
      const unsigned cand = kth | (1u << (31 - bit));
      int cnt = 0;
      for (int v = threadIdx.x; v < Va; v += NT) cnt += order_key(lg[v]) >= cand;
      if ((int)block_sum((float)cnt, redf) >= topk) kth = cand;
    }
  }
  float best = -INFINITY;
  int bidx = 1 << 30;
  for (int v = threadIdx.x; v < Va; v += NT) {
    float val = lg[v];
    if (!greedy) val = (order_key(val) >= kth ? val / t : NEG_INF) + __ldg(gum + v);
    if (val > best) { best = val; bidx = v; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
    if (ov > best || (ov == best && oi < bidx)) { best = ov; bidx = oi; }
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) { redf[threadIdx.x / 32] = best; redi[threadIdx.x / 32] = bidx; }
  __syncthreads();
  best = redf[0];
  bidx = redi[0];
  for (int w = 1; w < NWARP; ++w)
    if (redf[w] > best || (redf[w] == best && redi[w] < bidx)) { best = redf[w]; bidx = redi[w]; }
  __syncthreads();
  return bidx;
}

// Codebook i of stream b from its logits lg[Va_pad] (shared memory): record
// logits and draw where asked, apply the forced token, store the sample.
__device__ int sample_codebook(const Params& p, const float* lg, int b, int i, float* redf,
                               int* redi) {
  if (p.out_logits != nullptr)
    for (int v = threadIdx.x; v < p.Va_pad; v += NT)
      p.out_logits[((size_t)i * p.B + b) * p.Va_pad + v] = lg[v];
  const float* gum = p.gumbel + ((size_t)i * p.B + b) * p.Va;
  const int d = draw(lg, p.Va, gum, p.temp[b], p.topk[b], p.greedy != 0, redf, redi);
  const int f = p.forced[b * p.N + i];
  const int c = f >= 0 ? f : d;
  if (threadIdx.x == 0) {
    if (p.out_draws != nullptr) p.out_draws[b * p.N + i] = d;
    p.samples[b * p.N + i] = c;
  }
  return c;
}

// Row r of the next pass from the pre-projected embedding row ``row``.
__device__ void embed_row(const Params& p, int r, int row, float* src, float* red) {
  for (int n = threadIdx.x; n < p.D; n += NT)
    src[n] = p.emb_bf16 ? __bfloat162float(static_cast<const bf16*>(p.emb)[(size_t)row * p.D + n])
                        : static_cast<const float*>(p.emb)[(size_t)row * p.D + n];
  __syncthreads();
  set_row(p.h, src, r, p.D, p.eps, p.rs, p.xb, red);
}

// RoPE, the K/V write and attention of (stream b, kv head kvh) for T rows at
// positions pos0.., layer l.  qkv comes as partials of the fused product.
__device__ void attention_item(const Params& p, int l, int b, int kvh, int T, int pos0, int KS,
                               float* smem) {
  const int hd = p.hd, G = p.nq / p.nkv, half = hd / 2, R = p.B * T;
  const int QKVN = (p.nq + 2 * p.nkv) * hd;
  float* raw = smem;                   // [T][G + 2][hd]
  float* qb = raw + T * (G + 2) * hd;  // [T][G][hd]
  float* kb = qb + T * G * hd;         // [T][hd]
  float* vb = kb + T * hd;             // [T][hd]
  float* sc = vb + T * hd;             // [T][G][NP]
  const float* sq = p.sqkv + (size_t)l * QKVN;
  for (int i = threadIdx.x; i < T * (G + 2) * hd; i += NT) {
    const int t = i / ((G + 2) * hd), hh = i / hd % (G + 2), d = i % hd;
    const int col = hh < G ? (kvh * G + hh) * hd + d
                           : (hh == G ? p.nq : p.nq + p.nkv) * hd + kvh * hd + d;
    const int r = b * T + t;
    raw[i] = split_sum(p.part, KS, R, QKVN, r, col) * __ldg(sq + col) * __ldcg(p.rs + r);
  }
  __syncthreads();
  const size_t cache_row = (((size_t)l * p.B + b) * p.nkv + kvh) * p.NP;
  for (int i = threadIdx.x; i < T * (G + 2) * hd; i += NT) {
    const int t = i / ((G + 2) * hd), hh = i / hd % (G + 2), d = i % hd;
    const float* x = raw + (t * (G + 2) + hh) * hd;
    const size_t at = (cache_row + pos0 + t) * hd + d;
    if (hh == G + 1) {
      vb[t * hd + d] = bf16r(x[d]);
      p.vc[at] = __float2bfloat16_rn(x[d]);
      continue;
    }
    const int pos = pos0 + t;
    const float xr = d < half ? -x[d + half] : x[d - half];
    const float y = __fadd_rn(__fmul_rn(x[d], __ldg(p.cosb + pos * hd + d)),
                              __fmul_rn(xr, __ldg(p.sinb + pos * hd + d)));
    if (hh < G) {
      qb[(t * G + hh) * hd + d] = bf16r(y);
    } else {
      kb[t * hd + d] = bf16r(y);
      p.kc[at] = __float2bfloat16_rn(y);
    }
  }
  __syncthreads();
  // Scores: a warp per (row, head, key); keys below pos0 from the scratch.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = pos0 + T;
  for (int w = warp; w < T * G * nk; w += NWARP) {
    const int t = w / (G * nk), g = w / nk % G, j = w % nk;
    if (j > pos0 + t) continue;
    const float* q = qb + (t * G + g) * hd;
    float s = 0.f;
    for (int d = lane; d < hd; d += 32) {
      const float k = j >= pos0 ? kb[(j - pos0) * hd + d]
                                : __bfloat162float(p.kc[(cache_row + j) * hd + d]);
      s = fmaf(q[d], k, s);
    }
    s = warp_sum(s);
    if (lane == 0) sc[(t * G + g) * p.NP + j] = s * p.scale;
  }
  __syncthreads();
  // Softmax over keys 0..pos0+t: a warp per (row, head); bf16 probabilities.
  for (int w = warp; w < T * G; w += NWARP) {
    const int t = w / G, n = pos0 + t + 1;
    float* sg = sc + w * p.NP;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sg[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sg[j] - m);
      sg[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) sg[j] = bf16r(sg[j] / sum);
  }
  __syncthreads();
  // P.V: a thread per (row, head, dim); the output rounds to bf16, the
  // o-proj operand.
  for (int i = threadIdx.x; i < T * G * hd; i += NT) {
    const int t = i / (G * hd), g = i / hd % G, d = i % hd;
    const float* pg = sc + (t * G + g) * p.NP;
    float acc = 0.f;
    for (int j = 0; j <= pos0 + t; ++j) {
      const float v = j >= pos0 ? vb[(j - pos0) * hd + d]
                                : __bfloat162float(p.vc[(cache_row + j) * hd + d]);
      acc = fmaf(pg[j], v, acc);
    }
    p.attn[(size_t)(b * T + t) * p.nq * hd + (kvh * G + g) * hd + d] = bf16r(acc);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT) fused_decoder_kernel(Params p) {
  extern __shared__ float smem[];
  float* redf = smem;                                   // [NWARP]
  int* redi = reinterpret_cast<int*>(smem + NWARP);     // [NWARP]
  float* work = smem + 2 * NWARP;
  const int D = p.D, F = p.F, nqh = p.nq * p.hd;
  const int QKVN = (p.nq + 2 * p.nkv) * p.hd;
  const int nb = gridDim.x;

  // c0, and the prefill rows (b, 0) = x0[b], (b, 1) = embedding of c0.
  for (int b = blockIdx.x; b < p.B; b += nb) {
    for (int v = threadIdx.x; v < p.Va_pad; v += NT)
      work[v] = v < p.Va ? p.c0lg[(size_t)b * p.Va + v] : NEG_INF;
    __syncthreads();
    const int c = sample_codebook(p, work, b, 0, redf, redi);
    set_row(p.h, p.x0 + (size_t)b * D, 2 * b, D, p.eps, p.rs, p.xb, redf);
    embed_row(p, 2 * b + 1, c, work, redf);
  }
  grid_sync(p.bar);

  for (int i = 0; i + 1 < p.N; ++i) {
    const int T = i == 0 ? 2 : 1, pos0 = i == 0 ? 0 : i + 1, R = p.B * T;
    for (int l = 0; l < p.L; ++l) {
      gemm_stage<int8_t>(p.wqkv + (size_t)l * D * QKVN, D, QKVN, p.xb, R, p.part, work);
      grid_sync(p.bar);
      const int ks_qkv = D / pick_kc(D, QKVN, R, Wv<int8_t>::MAXRW, nb);
      for (int it = blockIdx.x; it < p.B * p.nkv; it += nb)
        attention_item(p, l, it / p.nkv, it % p.nkv, T, pos0, ks_qkv, work);
      grid_sync(p.bar);
      gemm_stage<int8_t>(p.wo + (size_t)l * nqh * D, nqh, D, p.attn, R, p.part, work);
      grid_sync(p.bar);
      const int ks_o = nqh / pick_kc(nqh, D, R, Wv<int8_t>::MAXRW, nb);
      for (int r = blockIdx.x; r < R; r += nb)
        residual_row(p.h, p.part, ks_o, R, r, D, p.so + (size_t)l * D, p.eps, p.rs, p.xb, redf);
      grid_sync(p.bar);
      gemm_stage<int8_t>(p.wgu + (size_t)l * D * 2 * F, D, 2 * F, p.xb, R, p.part, work);
      grid_sync(p.bar);
      const int ks_gu = D / pick_kc(D, 2 * F, R, Wv<int8_t>::MAXRW, nb);
      for (int e = blockIdx.x * NT + threadIdx.x; e < R * F; e += nb * NT) {
        const int r = e / F;
        p.gated[e] = swiglu(p.part, ks_gu, R, F, r, e % F, p.sgu + (size_t)l * 2 * F,
                            __ldcg(p.rs + r));
      }
      grid_sync(p.bar);
      gemm_stage<int8_t>(p.wdown + (size_t)l * F * D, F, D, p.gated, R, p.part, work);
      grid_sync(p.bar);
      const int ks_d = F / pick_kc(F, D, R, Wv<int8_t>::MAXRW, nb);
      for (int r = blockIdx.x; r < R; r += nb) {
        const float rsr = residual_row(p.h, p.part, ks_d, R, r, D, p.sdown + (size_t)l * D,
                                       p.eps, p.rs, p.xb, redf);
        if (l + 1 == p.L && r % T == T - 1) {
          // The stream's last row, final-normed: the head's operand.
          float* hx = p.hx + (size_t)(r / T) * D;
          for (int n = threadIdx.x; n < D; n += NT) {
            const float y = __ldcg(p.h + (size_t)r * D + n) * rsr;
            hx[n] = p.head_kind == 2 ? y : bf16r(y);
          }
        }
      }
      grid_sync(p.bar);
    }

    // Codebook ci = i + 1 from head slice i.
    const int ci = i + 1;
    const size_t hoff = (size_t)i * D * p.Va_pad;
    int head_maxrw;
    if (p.head_kind == 0) {
      gemm_stage<bf16>(static_cast<const bf16*>(p.head) + hoff, D, p.Va_pad, p.hx, p.B, p.part, work);
      head_maxrw = Wv<bf16>::MAXRW;
    } else if (p.head_kind == 1) {
      gemm_stage<int8_t>(static_cast<const int8_t*>(p.head) + hoff, D, p.Va_pad, p.hx, p.B, p.part, work);
      head_maxrw = Wv<int8_t>::MAXRW;
    } else {
      gemm_stage<float>(static_cast<const float*>(p.head) + hoff, D, p.Va_pad, p.hx, p.B, p.part, work);
      head_maxrw = Wv<float>::MAXRW;
    }
    grid_sync(p.bar);
    const int ks_h = D / pick_kc(D, p.Va_pad, p.B, head_maxrw, nb);
    const float* hs = p.head_scale + (size_t)i * p.Va_pad;
    for (int b = blockIdx.x; b < p.B; b += nb) {
      for (int v = threadIdx.x; v < p.Va_pad; v += NT) {
        float a = split_sum(p.part, ks_h, p.B, p.Va_pad, b, v);
        if (p.head_kind == 1) a *= __ldg(hs + v);
        work[v] = v < p.Va ? bf16r(a) : NEG_INF;
      }
      __syncthreads();
      const int c = sample_codebook(p, work, b, ci, redf, redi);
      if (ci + 1 < p.N) embed_row(p, b, c + ci * p.Va, work, redf);
      __syncthreads();
    }
    grid_sync(p.bar);
  }
}

size_t smem_bytes(int Va_pad, int hd, int G, int NP) {
  const size_t gemm = GEMM_SMEM_FLOATS;
  const size_t att = 2 * (G + 2) * hd + 2 * G * hd + 4 * hd + 2 * G * NP;
  size_t w = gemm > att ? gemm : att;
  if ((size_t)Va_pad > w) w = Va_pad;
  return (2 * NWARP + w) * sizeof(float);
}

// Blocks of the cooperative grid: at most 2 per SM, all resident.
cudaError_t grid_blocks(size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fused_decoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_decoder_kernel, NT, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *out = (per_sm < 2 ? per_sm : 2) * sms;
  return cudaSuccess;
}

long long max_part(int B, int D, int QKVN, int nqh, int F, int Va_pad, int head_maxrw, int nb) {
  long long m = 0;
  for (int T = 1; T <= 2; ++T) {
    const int R = B * T;
    const long long c[4] = {part_floats(D, QKVN, R, 32, nb), part_floats(nqh, D, R, 32, nb),
                            part_floats(D, 2 * F, R, 32, nb), part_floats(F, D, R, 32, nb)};
    for (long long x : c) m = x > m ? x : m;
  }
  const long long hp = part_floats(D, Va_pad, B, head_maxrw, nb);
  return hp > m ? hp : m;
}

int head_maxrw(int head_kind) {
  return head_kind == 0 ? Wv<bf16>::MAXRW : head_kind == 1 ? Wv<int8_t>::MAXRW : Wv<float>::MAXRW;
}

}  // namespace

extern "C" {

// Floats of partial-sum scratch fused_decode needs for these shapes on the
// current device (negative: a CUDA error code, negated).
long long fd_part_floats(int B, int D, int nq, int nkv, int hd, int F, int Va_pad, int NP,
                         int head_kind) {
  int nb = 0;
  const cudaError_t e = grid_blocks(smem_bytes(Va_pad, hd, nq / nkv, NP), &nb);
  if (e != cudaSuccess) return -(long long)e;
  return max_part(B, D, (nq + 2 * nkv) * hd, nq * hd, F, Va_pad, head_maxrw(head_kind), nb);
}

// One frame.  Shapes and types as in Params; every pointer on the current
// device, contiguous.  Launches one cooperative kernel on ``stream``.
int fused_decode(const void* temp, const void* topk, const void* forced, const void* x0,
                 const void* c0lg, const void* wqkv, const void* wo, const void* wgu,
                 const void* wdown, const void* sqkv, const void* so, const void* sgu,
                 const void* sdown, const void* cosb, const void* sinb, const void* head,
                 const void* head_scale, const void* gumbel, const void* emb, void* samples,
                 void* out_logits, void* out_draws, void* h, void* xb, void* rs, void* attn,
                 void* gated, void* hx, void* part, long long part_floats_given, void* kc,
                 void* vc, void* bar, int B, int N, int Va, int Va_pad, int D, int L, int nq,
                 int nkv, int hd, int F, int NP, int greedy, int head_kind, int emb_bf16,
                 float eps, void* stream) {
  const int G = nkv > 0 ? nq / nkv : 0;
  const int QKVN = (nq + 2 * nkv) * hd;
  if (B < 1 || B > 32 || nkv <= 0 || nq % nkv != 0 || G > G_MAX || hd > HD_MAX || hd % 2 != 0 ||
      NP < N || NP > NP_MAX || D % 32 != 0 || F % 32 != 0 || (nq * hd) % 32 != 0 ||
      QKVN % 4 != 0 || Va_pad % TILE != 0 || Va > Va_pad || head_kind < 0 || head_kind > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Va_pad, hd, G, NP);
  int nb = 0;
  cudaError_t e = grid_blocks(smem, &nb);
  if (e != cudaSuccess) return (int)e;
  if (max_part(B, D, QKVN, nq * hd, F, Va_pad, head_maxrw(head_kind), nb) > part_floats_given)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.B = B; p.N = N; p.Va = Va; p.Va_pad = Va_pad; p.D = D; p.L = L; p.nq = nq; p.nkv = nkv;
  p.hd = hd; p.F = F; p.NP = NP; p.greedy = greedy; p.head_kind = head_kind;
  p.emb_bf16 = emb_bf16; p.eps = eps; p.scale = (float)(1.0 / sqrt((double)hd));
  p.temp = static_cast<const float*>(temp);
  p.topk = static_cast<const int*>(topk);
  p.forced = static_cast<const int*>(forced);
  p.x0 = static_cast<const float*>(x0);
  p.c0lg = static_cast<const float*>(c0lg);
  p.wqkv = static_cast<const int8_t*>(wqkv);
  p.wo = static_cast<const int8_t*>(wo);
  p.wgu = static_cast<const int8_t*>(wgu);
  p.wdown = static_cast<const int8_t*>(wdown);
  p.sqkv = static_cast<const float*>(sqkv);
  p.so = static_cast<const float*>(so);
  p.sgu = static_cast<const float*>(sgu);
  p.sdown = static_cast<const float*>(sdown);
  p.cosb = static_cast<const float*>(cosb);
  p.sinb = static_cast<const float*>(sinb);
  p.head = head;
  p.head_scale = static_cast<const float*>(head_scale);
  p.gumbel = static_cast<const float*>(gumbel);
  p.emb = emb;
  p.samples = static_cast<int*>(samples);
  p.out_logits = static_cast<float*>(out_logits);
  p.out_draws = static_cast<int*>(out_draws);
  p.h = static_cast<float*>(h);
  p.xb = static_cast<float*>(xb);
  p.rs = static_cast<float*>(rs);
  p.attn = static_cast<float*>(attn);
  p.gated = static_cast<float*>(gated);
  p.hx = static_cast<float*>(hx);
  p.part = static_cast<float*>(part);
  p.kc = static_cast<bf16*>(kc);
  p.vc = static_cast<bf16*>(vc);
  p.bar = static_cast<unsigned*>(bar);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)fused_decoder_kernel, dim3(nb), dim3(NT), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int fd_grid_blocks(int Va_pad, int hd, int G, int NP) {
  int nb = 0;
  const cudaError_t e = grid_blocks(smem_bytes(Va_pad, hd, G, NP), &nb);
  return e == cudaSuccess ? nb : -(int)e;
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
