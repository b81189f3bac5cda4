// One backbone decode step of the exact (bf16) tier for Hopper (sm_90a): one
// persistent cooperative launch per step.
//
// Replaces csm_tpu/ops/bb_kernel.py::bb_decode_step with bits=16 (the Pallas
// TPU kernel built by _make_kernel, exact body layer_body_exact).  Same
// function: from the frame's embedding sum h0, for B <= 8 streams, 16 Llama
// layers (RMSNorm, QKV, RoPE at each stream's own position, GQA over the
// stream's biased KV window plus its new row, o-proj, SwiGLU), then the final
// norm and the codebook-0 head.  It returns the normed hidden, the c0 logits
// and the new K/V rows, and never writes the cache (the caller scatters the
// rows).  It rounds to bf16 exactly where the plain bf16 path rounds: the
// residual is bf16-valued f32; RMSNorm rounds the normed vector and again
// after the weight, rnd(rnd(h r) w) with r = rsqrt(mean(h^2) + eps) over the
// whole row; every product accumulates in fp32 over its whole depth and
// rounds once; RoPE runs in fp32 (no FMA contraction) and rounds; attention
// has fp32 scores and softmax with bf16 probabilities rounded after the
// normalisation, and rounds its output; h = rnd(h + rnd(x W)); gated =
// rnd(rnd(g * rnd(sigmoid(g))) * u), g and u each rnd(sum); the logits are
// rnd(bf16(nh) W_head), nh the twice-rounded final norm.
//
// Bound on the H100: the step must read every bf16 weight once, about
// 1.95 GB at CSM-1B width (16 layers x 121.6 MB + an 8.9 MB head), plus the
// usable KV rows (2 KB per slot per stream per layer), so at 3.35 TB/s it
// takes at least ~0.58 ms; its operations (2 B x 0.98 G) are far below the
// tensor cores' rate.
//
// The step's machinery (schedule, flags, weight ring, attention, main loop,
// traces) is csrc/bb_step.cuh's, shared with the int8 / int4 tiers
// (bb_decode_q.cu).  What is this tier's:
//
// - Nothing is folded into the weights, so RMSNorm comes before its product:
//   a QKV, gate-up or head split waits on every residual tile of the stage
//   before it, sums the tiles' sums of squares of each row in order, and
//   stages its operand rows as rnd(rnd(h r) w) from the f32 residual.  The
//   residual epilogues write h and its tile sums of squares only.
// - Products: the bf16 weights feed mma.sync as they are.  A chunk is 64 K
//   rows of 256 bytes (128 columns); ldmatrix .trans loads each warp's 16
//   columns by 16 K rows as the A fragment (rows of 16 pieces of 16 bytes,
//   stored at piece ^ (row % 8)).  B <= 8: one 8-column operand.  The sums
//   are compensated (mma_item) so that they land within a few f32 ulps of
//   exact: a plain f32 sum in another order flips the bf16 rounding of a
//   near-tie now and then, and at full depth such flips carry on.
// - RMSNorm's scale from f64 tile sums of squares (exact for the bf16-valued
//   residual), then the plain path's f32 steps (row_scales_exact).
// - Epilogues round where the plain version rounds (above); the new K rows
//   and q are RoPE'd from the rounded sums.
//
// Traces: chip_smoke phase 3 and tools/bbq_profile.py --items.

#include "bb_step.cuh"

namespace {

constexpr int KR = CHUNK_ROWS / 2;  // K rows of a bf16 chunk
static_assert(KR == 64, "mma_item adds a chunk's four k16 slices");

// Rows [0, R) x K indices [k0, k0 + n) of RMSNorm's bf16 output rnd(rnd(h
// r) w) into X (row stride XS), rows R..rows - 1 zeroed: h [R, D] the f32
// residual, r per row in rsv, w the norm weight [D].  32-byte loads of h
// and w, 4 pieces in flight a thread.
__device__ void stage_norm(const float* h, int D, int R, int rows, int k0, int n, int XS,
                           const float* rsv, const float* w, bf16* X) {
  constexpr int SB = 4;
  const int per = n / 8, total = rows * per;
  csync();  // the previous readers of X are done
  for (int i0 = threadIdx.x; i0 < total; i0 += SB * NT) {
    float4 v[SB][2], wv[SB][2];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * NT, r = i / per, c = i % per;
      const bool ld = i < total && r < R;
      const float4* hp = reinterpret_cast<const float4*>(h + (size_t)r * D + k0 + c * 8);
      const float4* wp = reinterpret_cast<const float4*>(w + k0 + c * 8);
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      v[u][0] = ld ? __ldcg(hp) : z;
      v[u][1] = ld ? __ldcg(hp + 1) : z;
      wv[u][0] = ld ? __ldg(wp) : z;
      wv[u][1] = ld ? __ldg(wp + 1) : z;
    }
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * NT;
      if (i >= total) break;
      const int r = i / per;
      const float rs = r < R ? rsv[r] : 0.f;
      const float a[8] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w,
                          v[u][1].x, v[u][1].y, v[u][1].z, v[u][1].w};
      const float b[8] = {wv[u][0].x, wv[u][0].y, wv[u][0].z, wv[u][0].w,
                          wv[u][1].x, wv[u][1].y, wv[u][1].z, wv[u][1].w};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = pack_bf16(bf16r(a[2 * e] * rs) * b[2 * e], bf16r(a[2 * e + 1] * rs) * b[2 * e + 1]);
      *reinterpret_cast<uint4*>(X + r * XS + (i % per) * 8) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  csync();
}

// One work item's sums on the tensor cores: ct[r][c] = sum over split ks of
// x[r, k] W[k, col c] for the tile's 128 columns, rows r < 8.  The operand
// is staged from ``x`` (bf16 [B, K]) or, with a norm weight ``nw``, as
// RMSNorm's output of the residual (stage_norm).  A fragment row m of warp
// w is tile column 16 w + m.
__device__ void mma_item(const Params& p, Ring& ring, const Prod& q, int idx, const bf16* x,
                         const float* nw, const float* rsv, bf16* X, float* ct) {
  const int ks = idx / q.tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  int gch = (X_BYTES / 2 / 8 - 8) / KR;  // chunks staged together
  gch = gch > q.nch ? q.nch : gch;
  const int XS = gch * KR + 8;
  // ldmatrix .trans, lane's row address: matrices 0-3 are (K rows 0-7,
  // columns 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) of the warp's 16
  // columns: the A fragment's a0..a3.
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lpiece = 2 * warp + ((lane >> 3) & 1);
  // Each k16 slice is its own mma (a 16-term sum of exact products); a
  // chunk's four are added pairwise in f32 and the chunk's sum joins the
  // running sum with its rounding error kept (TwoSum): the sums come out
  // within a few f32 ulps of exact, as the plain version's f64 evaluation.
  // (Chained mma accumulation truncates at every step: its drift flipped
  // bf16 roundings the plain path's f32 sums do not.)
  float sum[4] = {0.f, 0.f, 0.f, 0.f}, err[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ch0 = 0; ch0 < q.nch; ch0 += gch) {
    const int nj = min(gch, q.nch - ch0);
    const int k0 = ks * q.kc + ch0 * KR;
    if (nw != nullptr) stage_norm(p.h, p.s.D, p.s.B, 8, k0, nj * KR, XS, rsv, nw, X);
    else stage_x<false>(x, q.K, p.s.B, 8, k0, nj * KR, XS, X);
    for (int j = 0; j < nj; ++j) {
      const uint8_t* w = front(ring);
      const bf16* xr = X + g * XS + j * KR + 2 * t;
      float d[KR / 16][4];
#pragma unroll
      for (int s = 0; s < KR / 16; ++s) {
        uint32_t a[4];
        const int row = 16 * s + lrow;
        ldsm_x4_t(a, w + row * 2 * COLS + ((lpiece ^ (row & 7)) * 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) d[s][e] = 0.f;
        mma16816(d[s], a, *reinterpret_cast<const uint32_t*>(xr + 16 * s),
                 *reinterpret_cast<const uint32_t*>(xr + 16 * s + 8));
      }
      pop(ring);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c = (d[0][e] + d[1][e]) + (d[2][e] + d[3][e]);
        const float s = sum[e] + c, z = s - sum[e];
        err[e] += (sum[e] - (s - z)) + (c - z);
        sum[e] = s;
      }
    }
  }
  // (column 16 w + g, stream 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
  const int c0 = 16 * warp + g;
  ct[2 * t * CT_STRIDE + c0] = sum[0] + err[0];
  ct[(2 * t + 1) * CT_STRIDE + c0] = sum[1] + err[1];
  ct[2 * t * CT_STRIDE + c0 + 8] = sum[2] + err[2];
  ct[(2 * t + 1) * CT_STRIDE + c0 + 8] = sum[3] + err[3];
  csync();
}

// The epilogue of a finished product tile (sums in ct), once per tile, with
// the residual tile in ht (combine); ``tmp`` is free shared memory.  Row
// loops are not unrolled: at small B most of an unrolled body would be
// fetched for nothing.
__device__ void epilogue(const Params& p, int kind, int l, int cti, float* ct, const float* ht,
                         float* tmp) {
  const Shape& s = p.s;
  const int B = s.B;
  const int c = threadIdx.x % COLS, r0 = threadIdx.x / COLS, n = cti * COLS + c;
  switch (kind) {
    case K_QKV: {
      const int half = s.hd / 2, kv0 = s.nqh, v0 = s.nqh + s.nkv * s.hd, d = n % s.hd;
      // cos / sin of every stream into shared memory, issued first.
      float* cs = tmp;
      float* sn = tmp + B * s.hd;
#pragma unroll 4
      for (int i = threadIdx.x; i < B * s.hd; i += NT) {
        cs[i] = __ldg(p.cosb + i);
        sn[i] = __ldg(p.sinb + i);
      }
      for (int r = r0; r < B; r += 2) ct[r * CT_STRIDE + c] = bf16r(ct[r * CT_STRIDE + c]);
      csync();
      if (n >= v0) {
        const size_t at = (size_t)l * B * s.nkv * s.hd + (size_t)((n - v0) / s.hd) * s.hd + d;
        for (int r = r0; r < B; r += 2)
          p.new_v[at + (size_t)r * s.nkv * s.hd] = __float2bfloat16_rn(ct[r * CT_STRIDE + c]);
        break;
      }
      const int pc = d < half ? c + half : c - half;
      for (int r = r0; r < B; r += 2) {
        const float x = ct[r * CT_STRIDE + c];
        const float xr = d < half ? -ct[r * CT_STRIDE + pc] : ct[r * CT_STRIDE + pc];
        const bf16 y = __float2bfloat16_rn(
            __fadd_rn(__fmul_rn(x, cs[r * s.hd + d]), __fmul_rn(xr, sn[r * s.hd + d])));
        if (n < kv0) p.qb[(size_t)r * s.nqh + n] = y;
        else p.new_k[(((size_t)l * B + r) * s.nkv + (n - kv0) / s.hd) * s.hd + d] = y;
      }
      break;
    }
    case K_O:
    case K_DOWN: {
      for (int r = r0; r < B; r += 2)
        ct[r * CT_STRIDE + c] = bf16r(ht[r * CT_STRIDE + c] + bf16r(ct[r * CT_STRIDE + c]));
      csync();
      residual_out<true>(p, cti, ct, nullptr, false, 1.f, kind == K_O ? p.ss_m : p.ss_a);
      break;
    }
    case K_GU: {
      // Thread i: gate column j = i % 64 of the pair tile, rows i / 64 + 4e.
      const int j = threadIdx.x % 64, f = cti * 64 + j;
      for (int r = threadIdx.x / 64; r < B; r += 4) {
        const float gt = bf16r(ct[r * CT_STRIDE + j]);
        const float up = bf16r(ct[r * CT_STRIDE + 64 + j]);
        const float sg = bf16r(1.f / (1.f + expf(-gt)));
        p.xd[(size_t)r * s.F + f] = __float2bfloat16_rn(bf16r(gt * sg) * up);
      }
      break;
    }
    default:  // K_HEAD
      for (int r = r0; r < B; r += 2)
        p.logits[(size_t)r * s.n_head + n] = bf16r(ct[r * CT_STRIDE + c]);
      break;
  }
}

__device__ void product_item(const Params& p, Ring& ring, const Item& it, uint8_t* work,
                             float* rsv, int* flag, unsigned long long* tready) {
  const Shape& s = p.s;
  const Prod q = prod_of<true>(p, it.kind, it.l);
  const int cti = it.idx % q.tiles, ks = it.idx / q.tiles;
  wait_operand<true>(p, it.kind, it.l, q, ks);
  mark(p, tready, 0);
  bf16* X = reinterpret_cast<bf16*>(work);
  float* ct = reinterpret_cast<float*>(work + X_BYTES);
  const float* nw = it.kind == K_QKV ? p.attn_nw + (size_t)it.l * s.D
                  : it.kind == K_GU  ? p.mlp_nw + (size_t)it.l * s.D
                  : it.kind == K_HEAD ? p.fnw
                                      : nullptr;
  // RMSNorm's scale of each row, from the residual's tile sums of squares
  // (the ct area is free until the sums).
  if (nw != nullptr)
    row_scales_exact(p, it.kind == K_GU ? p.ss_m : p.ss_a, reinterpret_cast<double*>(ct), rsv);
  mma_item(p, ring, q, it.idx, it.kind == K_O ? p.xo : p.xd, nw, rsv, X, ct);
  mark(p, tready, 1);
  // The staging area is free now: h's tile.
  float* ht = reinterpret_cast<float*>(work);
  const bool res = it.kind == K_O || it.kind == K_DOWN;
  if (!combine(p, q, it.idx, ct, flag, nullptr, nullptr, res ? p.h : nullptr, ht)) return;
  mark(p, tready, 2);
  epilogue(p, it.kind, it.l, cti, ct, ht, ht + 32 * CT_STRIDE);
  mark(p, tready, 3);
  tile_done(p, it, cti);
}

// The bf16 tier for run_step.
struct ExactTier {
  static constexpr bool EXACT = true;
  static constexpr int PIECES = 16;  // chunk rows of 256 bytes
  static __device__ __forceinline__ void product(const Params& p, Ring& ring, const Item& it,
                                                 uint8_t* work, float* rsv, int* flag,
                                                 unsigned long long* tready) {
    product_item(p, ring, it, work, rsv, flag, tready);
  }
  static __device__ __forceinline__ void row(const Params& p, const Item& it, uint8_t* work,
                                             float* rsv, unsigned long long* tready) {
    row_item<true>(p, it, work, rsv, tready);
  }
};

__global__ void __launch_bounds__(BLOCK, 1) bb_step_kernel(const Params p) {
  run_step<ExactTier>(p);
}

}  // namespace

extern "C" {

// Bytes of scratch a step takes at these shapes (Layout; zeroed once when
// allocated).
long long bb_scratch_bytes(int B, int D, int nq, int nkv, int hd, int F, int n_head, int L) {
  if (nkv <= 0 || nq % nkv != 0 || hd <= 0) return -(long long)REFUSED_SHAPES;
  return layout_of(shape_of(B, L, D, F, nq, nkv, hd, n_head, 0, 1)).total;
}

// Work items of a step at these shapes (an item trace takes TRACE_SLOTS,
// 8, int64 per item).
long long bb_item_count(int B, int D, int nq, int nkv, int hd, int F, int n_head, int L) {
  if (nkv <= 0 || nq % nkv != 0 || hd <= 0) return -(long long)REFUSED_SHAPES;
  return sched_of(shape_of(B, L, D, F, nq, nkv, hd, n_head, 0, 1)).total;
}

// All tensors contiguous on the current device.  f32: h0 [B,D], cos/sin
// [B,hd], bias [B,W], norm weights attn_nw / mlp_nw [L,D] and final_nw [D],
// outputs nh [B,D] and logits [B,n_head].  bf16: caches [L,B,W,nkv,hd],
// wqkv [L,D,(nq+2nkv)hd], wo [L,nq hd,D], wgu [L,D,2F], wdown [L,F,D], head
// [D,n_head], outputs new_k/new_v [L,B,nkv,hd].  scratch: bb_scratch_bytes
// bytes, zeroed when allocated, kept across calls with ``epoch`` one more
// each launch (modulo 2^32); stamps: null or 5 L + 4 int64 (block 0's clock
// in ns at its start and as it leaves each stage: init, per layer QKV,
// attention, o-proj, gate-up, down, then head, final); item_ns: null or
// item_ns_len int64, at least TRACE_SLOTS (8) per work item (bb_item_count).
// One cooperative launch on stream.  Returns 0, a cudaError_t, or a code of
// arguments the kernel refuses.
int bb_decode_step(const void* h0, const void* cosb, const void* sinb, const void* bias,
                   const void* kc, const void* vc, const void* wqkv, const void* wo,
                   const void* wgu, const void* wdown, const void* head, const void* attn_nw,
                   const void* mlp_nw, const void* final_nw, void* nh, void* logits, void* new_k,
                   void* new_v, void* scratch, void* stamps, void* item_ns,
                   long long scratch_bytes, long long item_ns_len, int L, int B, int D, int F,
                   int nq, int nkv, int hd, int W, int n_head, int epoch, float eps,
                   void* stream) {
  if (nkv <= 0 || nq % nkv != 0) return REFUSED_SHAPES;
  Params p;
  int sms = 0;
  const int rc = bind(p, shape_of(B, L, D, F, nq, nkv, hd, n_head, 0, 1), &sms, h0, cosb, sinb,
                      bias, kc, vc, final_nw, nh, logits, new_k, new_v, scratch, scratch_bytes,
                      stamps, item_ns, item_ns_len, W, epoch, eps);
  if (rc != 0) return rc;
  p.wqkv = static_cast<const int8_t*>(wqkv);
  p.wo = static_cast<const int8_t*>(wo);
  p.wgu = static_cast<const int8_t*>(wgu);
  p.wdown = static_cast<const int8_t*>(wdown);
  p.head = static_cast<const int8_t*>(head);
  p.attn_nw = static_cast<const float*>(attn_nw);
  p.mlp_nw = static_cast<const float*>(mlp_nw);
  return (int)launch(bb_step_kernel, p, sms, static_cast<cudaStream_t>(stream));
}

const char* bb_error_string(int code) { return refused_string(code); }

}  // extern "C"
