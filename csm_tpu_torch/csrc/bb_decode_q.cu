// One backbone decode step of the int8 and int4 tiers for Hopper (sm_90a):
// one persistent cooperative launch per step.
//
// Replaces csm_tpu/ops/bb_kernel.py::bb_decode_step with bits=8 and bits=4
// (the Pallas TPU kernel built by _make_kernel; its arithmetic is the
// emulator's int8 and int4 branches, emulate_bb_decode_step).  Same
// function: from the frame's embedding sum h0, for B <= 32 streams, 16 Llama
// layers with int8 per-output-channel weights (W8A16) whose RMSNorm weights
// are folded in, so each pre-norm product runs on bf16(h) of the raw f32
// residual and RMSNorm's per-row scale rs = rsqrt(mean(h^2) + eps)
// multiplies its output: qkv = (x W) s rs; RoPE in f32 at each stream's own
// position; GQA over the stream's biased KV window plus its new row with
// bf16 operands, f32 scores and softmax, bf16 probabilities; h += (bf16(attn)
// Wo) s; gated = silu(g) u in f32; h += (bf16(gated) Wdown) s.  Then nh = h
// rs final_norm and the c0 logits bf16((bf16(h) Whead) s rs) (the final norm
// folded into the head).  It returns nh, the logits and the new K/V rows,
// and never writes the cache.
//
// The int4 tier stores the four layer families as row-packed int4 (byte row
// i = K-rows 2i and 2i+1, sign-extended nibbles) with a per-column scale s
// and a per-row equilibration u that multiplies the product's activation
// before its bf16 rounding: qkv = (bf16(h u_qkv) W) s rs, h += (bf16(attn
// u_wo) Wo) s, gate|up from bf16(h u_gu), h += (bf16(gated u_down) Wdown) s,
// attn and gated kept in f32 until then.  The c0 head stays int8.
//
// Bound on the H100: the step reads every weight once (~0.97 GB of int8
// layer weights at CSM-1B width, ~0.49 GB of int4, plus the 4.5 MB head) and
// the usable KV rows: at least ~0.29 ms (int8) / ~0.15 ms (int4) at 3.35
// TB/s.  Its operations (2 B x 0.98 G) are far below the tensor cores' rate.
// The step's machinery (schedule, flags, weight ring, attention, main loop)
// and its products are csrc/bb_step.cuh's, shared with the exact bf16 tier
// (bb_decode.cu) and the fused codebook loop (fused_decoder.cu).  The
// products widen the int8 weights (or sign-extended int4 nibbles) to bf16 in
// registers, exactly, after ldmatrix .trans (int8 / int4 x bf16 products are
// exact in f32, so only the order of the f32 sums differs from the plain
// version; B = 32 takes four 8-column operands over one weight fragment).
// What is this tier's: the epilogues apply the scales and rs: RoPE and the
// bf16 K/V rows for QKV (a tile holds whole heads), the residual add with the
// tile's sums of squares and the next product's bf16 operand (times its u
// for int4) for o-proj and down, SwiGLU for gate-up.  Traces: chip_smoke
// phases 4 / 10 and tools/bbq_profile.py --items.

#include "bb_step.cuh"

namespace {

// The per-column constants of a tile's epilogue for this thread's column,
// loaded when the item starts (before its waits): the scale s (gate-up: of
// the gate and the up column) and the prescale u of the next product (int4).
struct EpiConst {
  float s0, s1, u;
  bool has_u;
};

__device__ EpiConst epi_const(const Params& p, int kind, int l, int cti) {
  const Shape& s = p.s;
  const int c = threadIdx.x % COLS, n = cti * COLS + c;
  EpiConst e{0.f, 0.f, 1.f, false};
  switch (kind) {
    case K_QKV: e.s0 = __ldg(p.sqkv + (size_t)l * s.QKVN + n); break;
    case K_O:
      e.s0 = __ldg(p.so + (size_t)l * s.D + n);
      if (s.int4) e.u = __ldg(p.ugu + (size_t)l * s.D + n), e.has_u = true;
      break;
    case K_DOWN:
      e.s0 = __ldg(p.sdown + (size_t)l * s.D + n);
      if (s.int4 && l + 1 < s.L) e.u = __ldg(p.uqkv + (size_t)(l + 1) * s.D + n), e.has_u = true;
      break;
    case K_GU: {
      const int f = cti * 64 + threadIdx.x % 64;
      e.s0 = __ldg(p.sgu + (size_t)l * 2 * s.F + f);
      e.s1 = __ldg(p.sgu + (size_t)l * 2 * s.F + s.F + f);
      if (s.int4) e.u = __ldg(p.udown + (size_t)l * s.F + f), e.has_u = true;
      break;
    }
    default: e.s0 = __ldg(p.shead + n); break;
  }
  return e;
}

// The epilogue of a finished product tile (sums in ct), once per tile, with
// the tile sums of squares in ssm and the residual tile in ht (combine);
// ``tmp`` is free shared memory.  Row loops are not unrolled: at small B
// most of an unrolled body would be fetched for nothing.
__device__ void epilogue(const Params& p, int kind, int l, int cti, float* ct, float* rsv,
                         const float* ssm, const float* ht, const EpiConst& ec, float* tmp) {
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
      row_scales(p, ssm, rsv);  // synchronises the block
      for (int r = r0; r < B; r += 2) ct[r * CT_STRIDE + c] = ct[r * CT_STRIDE + c] * ec.s0 * rsv[r];
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
        ct[r * CT_STRIDE + c] = __fadd_rn(ht[r * CT_STRIDE + c], __fmul_rn(ct[r * CT_STRIDE + c], ec.s0));
      csync();
      residual_out<false>(p, cti, ct, kind == K_O ? p.xm : p.xa, ec.has_u, ec.u,
                   kind == K_O ? p.ss_m : p.ss_a);
      break;
    }
    case K_GU: {
      // Thread i: gate column j = i % 64 of the pair tile, rows i / 64 + 4e.
      row_scales(p, ssm, rsv);
      const int j = threadIdx.x % 64, f = cti * 64 + j;
      for (int r = threadIdx.x / 64; r < B; r += 4) {
        const float gt = ct[r * CT_STRIDE + j] * ec.s0 * rsv[r];
        const float up = ct[r * CT_STRIDE + 64 + j] * ec.s1 * rsv[r];
        const float v = gt * (1.f / (1.f + expf(-gt))) * up;
        p.xd[(size_t)r * s.F + f] = __float2bfloat16_rn(s.int4 ? v * ec.u : v);
      }
      break;
    }
    default: {  // K_HEAD
      row_scales(p, ssm, rsv);
      for (int r = r0; r < B; r += 2)
        p.logits[(size_t)r * s.n_head + n] = bf16r(ct[r * CT_STRIDE + c] * ec.s0 * rsv[r]);
      break;
    }
  }
}

template <bool INT4>
__device__ void product_item(const Params& p, Ring& ring, const Item& it, uint8_t* work,
                             float* rsv, int* flag, unsigned long long* tready) {
  const Prod q = prod_of<false>(p, it.kind, it.l);
  const int cti = it.idx % q.tiles, ks = it.idx / q.tiles;
  const EpiConst ec = epi_const(p, it.kind, it.l, cti);
  wait_operand<false>(p, it.kind, it.l, q, ks);
  mark(p, tready, 0);
  const bf16* x = it.kind == K_QKV || it.kind == K_HEAD ? p.xa
                : it.kind == K_O                        ? p.xo
                : it.kind == K_GU                       ? p.xm
                                                        : p.xd;
  bf16* X = reinterpret_cast<bf16*>(work);
  float* ct = reinterpret_cast<float*>(work + X_BYTES);
  if constexpr (INT4) {
    if (it.kind != K_HEAD) run_mma<1>(p, ring, q, it.idx, x, X, ct);
    else run_mma<0>(p, ring, q, it.idx, x, X, ct);
  } else {
    run_mma<0>(p, ring, q, it.idx, x, X, ct);
  }
  mark(p, tready, 1);
  // The staging area is free now: the tile sums of squares, then h's tile.
  float* ssm = reinterpret_cast<float*>(work);
  float* ht = ssm + SS_MAX;
  const bool res = it.kind == K_O || it.kind == K_DOWN;
  const float* ss = res ? nullptr : it.kind == K_GU ? p.ss_m : p.ss_a;
  if (!combine(p, q, it.idx, ct, flag, ss, ssm, res ? p.h : nullptr, ht)) return;
  mark(p, tready, 2);
  epilogue(p, it.kind, it.l, cti, ct, rsv, ssm, ht, ec, ht + 32 * CT_STRIDE);
  mark(p, tready, 3);
  tile_done(p, it, cti);
}

// The int8 / int4 tier for run_step.
template <bool INT4>
struct QTier {
  static constexpr bool EXACT = false;
  static constexpr int PIECES = 8;  // chunk rows of 128 bytes
  static __device__ __forceinline__ void product(const Params& p, Ring& ring, const Item& it,
                                                 uint8_t* work, float* rsv, int* flag,
                                                 unsigned long long* tready) {
    product_item<INT4>(p, ring, it, work, rsv, flag, tready);
  }
  static __device__ __forceinline__ void row(const Params& p, const Item& it, uint8_t* work,
                                             float* rsv, unsigned long long* tready) {
    row_item<false>(p, it, work, rsv, tready);
  }
};

template <bool INT4>
__global__ void __launch_bounds__(BLOCK, 1) bbq_step_kernel(const Params p) {
  run_step<QTier<INT4>>(p);
}

int step(bool int4, const void* h0, const void* cosb, const void* sinb, const void* bias,
         const void* kc, const void* vc, const void* wqkv, const void* wo, const void* wgu,
         const void* wdown, const void* head, const void* sqkv, const void* so, const void* sgu,
         const void* sdown, const void* shead, const void* uqkv, const void* uo, const void* ugu,
         const void* udown, const void* final_nw, void* nh, void* logits, void* new_k,
         void* new_v, void* scratch, long long scratch_bytes, void* stamps, void* item_ns,
         long long item_ns_len, int L, int B, int D, int F, int nq, int nkv, int hd, int W,
         int n_head, int epoch, float eps, void* stream) {
  if (nkv <= 0 || nq % nkv != 0) return REFUSED_SHAPES;
  Params p;
  int sms = 0;
  const int rc = bind(p, shape_of(B, L, D, F, nq, nkv, hd, n_head, int4 ? 1 : 0, 0), &sms, h0,
                      cosb, sinb, bias, kc, vc, final_nw, nh, logits, new_k, new_v, scratch,
                      scratch_bytes, stamps, item_ns, item_ns_len, W, epoch, eps);
  if (rc != 0) return rc;
  p.wqkv = static_cast<const int8_t*>(wqkv);
  p.wo = static_cast<const int8_t*>(wo);
  p.wgu = static_cast<const int8_t*>(wgu);
  p.wdown = static_cast<const int8_t*>(wdown);
  p.head = static_cast<const int8_t*>(head);
  p.sqkv = static_cast<const float*>(sqkv);
  p.so = static_cast<const float*>(so);
  p.sgu = static_cast<const float*>(sgu);
  p.sdown = static_cast<const float*>(sdown);
  p.shead = static_cast<const float*>(shead);
  p.uqkv = static_cast<const float*>(uqkv);
  p.uo = static_cast<const float*>(uo);
  p.ugu = static_cast<const float*>(ugu);
  p.udown = static_cast<const float*>(udown);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(int4 ? launch(bbq_step_kernel<true>, p, sms, st)
                    : launch(bbq_step_kernel<false>, p, sms, st));
}


}  // namespace

extern "C" {

// Bytes of scratch a step takes at these shapes, for the int8 (bits 8) or
// int4 (bits 4) layer weights (Layout; zeroed once when allocated).
long long bbq_scratch_bytes(int B, int D, int nq, int nkv, int hd, int F, int n_head, int L,
                            int bits) {
  if (nkv <= 0 || nq % nkv != 0 || hd <= 0) return -(long long)REFUSED_SHAPES;
  return layout_of(shape_of(B, L, D, F, nq, nkv, hd, n_head, bits == 4 ? 1 : 0, 0)).total;
}

// Work items of a step at these shapes (an item trace takes TRACE_SLOTS,
// 8, int64 per item).
long long bbq_item_count(int B, int D, int nq, int nkv, int hd, int F, int n_head, int L,
                         int bits) {
  if (nkv <= 0 || nq % nkv != 0 || hd <= 0) return -(long long)REFUSED_SHAPES;
  return sched_of(shape_of(B, L, D, F, nq, nkv, hd, n_head, bits == 4 ? 1 : 0, 0)).total;
}

// All tensors contiguous on the current device.  f32: h0 [B,D], cos/sin
// [B,hd], bias [B,W], scales sqkv [L,QKVN], so [L,D], sgu [L,2F], sdown [L,D],
// shead [n_head], final_nw [D], outputs nh [B,D] and logits [B,n_head].
// bf16: caches [L,B,W,nkv,hd], outputs new_k/new_v [L,B,nkv,hd].  int8: wqkv
// [L,D,QKVN], wo [L,nq hd,D], wgu [L,D,2F], wdown [L,F,D], head [D,n_head].
// scratch: bbq_scratch_bytes bytes, zeroed when allocated, kept across
// calls with ``epoch`` one more each launch (modulo 2^32); stamps: null or
// 5 L + 4 int64 (block 0's clock in ns at its start and as it leaves each
// stage: init, per layer QKV, attention, o-proj, gate-up, down, then head,
// final); item_ns: null or item_ns_len int64, at least TRACE_SLOTS (8) per
// work item (bbq_item_count).  One cooperative launch on stream.  Returns 0,
// a cudaError_t, or a code of arguments the kernel refuses.
int bb_decode_q_step(const void* h0, const void* cosb, const void* sinb, const void* bias,
                     const void* kc, const void* vc, const void* wqkv, const void* wo,
                     const void* wgu, const void* wdown, const void* head, const void* sqkv,
                     const void* so, const void* sgu, const void* sdown, const void* shead,
                     const void* final_nw, void* nh, void* logits, void* new_k, void* new_v,
                     void* scratch, void* stamps, void* item_ns, long long scratch_bytes,
                     long long item_ns_len, int L, int B, int D, int F, int nq, int nkv, int hd,
                     int W, int n_head, int epoch, float eps, void* stream) {
  return step(false, h0, cosb, sinb, bias, kc, vc, wqkv, wo, wgu, wdown, head, sqkv, so, sgu,
              sdown, shead, nullptr, nullptr, nullptr, nullptr, final_nw, nh, logits, new_k,
              new_v, scratch, scratch_bytes, stamps, item_ns, item_ns_len, L, B, D, F, nq, nkv, hd,
              W, n_head, epoch, eps, stream);
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
                      void* scratch, void* stamps, void* item_ns, long long scratch_bytes,
                      long long item_ns_len, int L, int B, int D, int F, int nq, int nkv, int hd,
                      int W, int n_head, int epoch, float eps, void* stream) {
  return step(true, h0, cosb, sinb, bias, kc, vc, wqkv, wo, wgu, wdown, head, sqkv, so, sgu,
              sdown, shead, uqkv, uo, ugu, udown, final_nw, nh, logits, new_k, new_v, scratch,
              scratch_bytes, stamps, item_ns, item_ns_len, L, B, D, F, nq, nkv, hd, W, n_head,
              epoch, eps, stream);
}

const char* bbq_error_string(int code) { return refused_string(code); }

}  // extern "C"
