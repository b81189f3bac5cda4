// The fused codebook loop for Hopper (sm_90a): all codebooks of one frame in
// one persistent cooperative kernel.
//
// Replaces csm_tpu/ops/fused_decoder.py::fused_decode_codebooks (the Pallas
// TPU kernel built by _make_kernel).  Same function: sample c0 from the
// backbone's bf16-rounded logits, prefill the 4-layer decoder with
// [proj(h); proj(embed(c0))] at positions 0..1, then for each codebook i in
// 1..N-1 apply head slice i-1 to the last hidden, draw (top-k over the
// logits' bf16 bit patterns, then Gumbel-max with the given noise; greedy is
// a first-index argmax), honour the forced prefix, and (except after the
// last codebook) run one decoder pass on the drawn token's pre-projected
// embedding.  Weights are int8 per output channel with the RMSNorm weights
// folded in (W8A16): each pre-norm product runs on the raw residual and
// RMSNorm's per-row scale multiplies its output; the residual stream is f32.
// Attention has bf16 operands (q, the K/V scratch, the probabilities) with
// f32 scores and softmax, as the TPU kernel's.
//
// What the TPU kernel did for its hardware is not carried over: there it kept
// ~106 MB of int8 weights resident in VMEM for all 31 passes.  An H100 has a
// 50 MB L2 and 227 KB of shared memory per block, so every pass streams the
// weights from device memory: 31 passes x the decoder's int8 weights plus 31
// head slices, ~1.07 ms per frame at 3.35 TB/s.  Between dependent stages
// the whole grid waits at a barrier, so the frame's time is the barriers'
// latency as much as the bytes.  The design:
//
// - Stages.  Per layer QKV product | RoPE, K/V write and attention per
//   (stream, query head) | o-proj | gate-up | down, a grid barrier after
//   each; per codebook the head product, then the draws, which wait on the
//   head items' arrival counter (not a grid barrier), then one barrier.  The
//   epilogues are folded into the next product's operand staging: the
//   residual add goes into gate-up's and the next layer's QKV staging (the
//   items of column tile 0 write the residual slice and the per-row sum of
//   squares of their K slice, from which RMSNorm's scale is summed), SwiGLU
//   into the down product's staging, the final residual and norm into the
//   head's, the drawn token's embedding row into the next pass's QKV
//   staging.  1 + 31 x 21 - 1 = 651 grid barriers a frame (none after the
//   last draw); the old design took 1,055.
// - Weights streamed into shared memory.  The order of every block's work
//   items is fixed by the shapes, so each block keeps a ring of RING weight
//   chunks (16 KB: 128 K rows x 128 columns int8, or 64 x 128 bf16) in
//   flight by cp.async, refilled as it consumes them across stage, layer
//   and pass boundaries.  The ring is shallow and is not topped up right
//   before a barrier: deeper rings, and refills before the wait, measured
//   slower on the H100 (PERF.md), as the bytes in flight delay the next
//   stage's latency-bound loads of its operand rows.
// - Shallow, fixed K splits.  A product's K split (KS <= 8, pick_ks) is a
//   function of its shape only, so a row's sums run in the same order at
//   every batch size and every grid size.
// - Tensor cores.  mma.sync m16n8k16 bf16 with f32 accumulation: the
//   weights widened to bf16 in registers as the 16-row operand (16 output
//   columns), up to 8 activation rows as the 8-column operand.  int8 and
//   bf16 values are exact in bf16, so only the order of the f32 sums
//   differs from the plain version.  The f32 head keeps FMAs.
// - The draw: top-k's k-th value by a radix select over the 16 high bits of
//   the order keys (2 rounds of 8 bits with a 256-bin shared histogram),
//   which finds the bisection's value with its tie rule.
// - The barrier: arrive by a release add; a block that finds it still
//   closed polls an acquire load every ~100 ns; a lost arrival traps after
//   ~2^35 cycles instead of hanging the card.  One block per SM.
// - The trace: with a stamps buffer, block 0 records its clock as it leaves
//   each barrier, which gives every stage's time (chip_smoke phase 5).
//
// Data another block wrote is read through L2 (__ldcg).  Scratch (one f32
// buffer, laid out by Layout) and the K/V scratch are the caller's, and may be
// kept across calls: every value is written before it is read.  bar[0]
// (arrivals) re-arms itself at each barrier, bar[1] (the generation) only
// has to change, bar[2] (head arrivals) is zeroed by block 0 before the
// first barrier, and bar[3] receives the launch's count of grid barriers.

#include "sync.cuh"
#include "w8a16.cuh"

namespace {

using namespace w8a16;
using namespace sync_ptx;

constexpr int HD_MAX = 128;
constexpr int G_MAX = 8;
constexpr int NP_MAX = 64;
constexpr int COLS = 128;            // output columns of a work item
constexpr int RING = 2;              // weight chunks in flight per block
constexpr int CHUNK_BYTES = 16384;
constexpr int X_BYTES = 49152;       // staged bf16 operand rows of a product
constexpr int HEAD_KINDS = 3;        // 0 bf16, 1 int8 (+ scale), 2 f32

// ---------------------------------------------------------------------------
// Shapes: K splits, chunks, scratch layout (host and device agree)
// ---------------------------------------------------------------------------

// K splits of a [K, N] product: 8, halved while the items would still number
// 64 or more (enough to spread the weights over the grid; every split is one
// more partial for the next stage's staging to sum), or while 16-row slices
// do not divide K.  Shapes only.
__host__ __device__ inline int pick_ks(int K, int N) {
  const int tiles = N / COLS;
  int ks = 8;
  while (ks > 1 && (K % (16 * ks) != 0 || tiles * (ks / 2) >= 64)) ks /= 2;
  return ks;
}

// K rows of one chunk of a split of kc rows, by weight type (0 int8, 1 bf16).
__host__ __device__ inline int chunk_rows(int kc, int wkind) {
  const int cap = wkind == 0 ? 128 : 64;
  return kc < cap ? kc : cap;
}

struct Layout {
  long long ha, hm, attn, p_qkv, p_o, p_gu, p_down, p_head, ss_a, ss_m, total;
};

__host__ __device__ inline Layout layout(int B, int D, int QKVN, int nqh, int F, int Va_pad,
                                         int ks_qkv, int ks_o, int ks_gu, int ks_down,
                                         int ks_head) {
  const long long R = 2 * B;
  Layout o;
  long long at = 0;
  auto take = [&](long long n) { const long long x = at; at += (n + 31) / 32 * 32; return x; };
  o.ha = take(R * D);
  o.hm = take(R * D);
  o.attn = take(R * nqh);
  o.p_qkv = take(ks_qkv * R * QKVN);
  o.p_o = take(ks_o * R * D);
  o.p_gu = take(ks_gu * R * 2 * F);
  o.p_down = take(ks_down * R * D);
  o.p_head = take(ks_head * B * Va_pad);
  o.ss_a = take(ks_qkv * R);
  o.ss_m = take(ks_gu * R);
  o.total = at;
  return o;
}

struct Params {
  int B, N, Va, Va_pad, D, L, nq, nkv, hd, F, NP;
  int greedy, head_kind, emb_bf16;  // head_kind: 0 bf16, 1 int8 (+ scale), 2 f32
  int ks_qkv, ks_o, ks_gu, ks_down, ks_head;
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
  // Scratch (Layout): residual stream in and mid layer [2B, D], attention
  // output [2B, nq hd], each product's K-split partials [KS, R, N], the
  // per-slice sums of squares of h_in and h_mid [KS, R].
  float *ha, *hm, *attn, *p_qkv, *p_o, *p_gu, *p_down, *p_head, *ss_a, *ss_m;
  bf16 *kc, *vc;                          // [L, B, nkv, NP, hd]
  unsigned* bar;                          // [4]
  unsigned long long* stamps;             // [>= barriers + 1] or null: the trace
};

// One product of the frame's plan: stage st of a pass (4 per layer: QKV,
// o-proj, gate-up, down; then 4L: the head slice of the pass).  Item it is
// column tile it % tiles of K split it / tiles, kc rows of W streamed in nch
// chunks of CR rows.
struct Prod {
  const char* W;
  float* part;
  int K, N, KS, kc, CR, nch, tiles, items, wkind;  // wkind 0 int8, 1 bf16, 2 f32
  int elt;
};

__device__ __forceinline__ Prod prod(const Params& p, int st, int pass) {
  Prod q;
  const int QKVN = (p.nq + 2 * p.nkv) * p.hd, nqh = p.nq * p.hd;
  if (st < 4 * p.L) {
    const int l = st >> 2;
    q.wkind = 0;
    q.elt = 1;
    switch (st & 3) {
      case 0: q.W = (const char*)(p.wqkv + (size_t)l * p.D * QKVN); q.K = p.D; q.N = QKVN;
              q.KS = p.ks_qkv; q.part = p.p_qkv; break;
      case 1: q.W = (const char*)(p.wo + (size_t)l * nqh * p.D); q.K = nqh; q.N = p.D;
              q.KS = p.ks_o; q.part = p.p_o; break;
      case 2: q.W = (const char*)(p.wgu + (size_t)l * p.D * 2 * p.F); q.K = p.D; q.N = 2 * p.F;
              q.KS = p.ks_gu; q.part = p.p_gu; break;
      default: q.W = (const char*)(p.wdown + (size_t)l * p.F * p.D); q.K = p.F; q.N = p.D;
               q.KS = p.ks_down; q.part = p.p_down; break;
    }
  } else {
    q.wkind = p.head_kind == 0 ? 1 : p.head_kind == 1 ? 0 : 2;
    q.elt = q.wkind == 0 ? 1 : q.wkind == 1 ? 2 : 4;
    q.W = static_cast<const char*>(p.head) + (size_t)pass * p.D * p.Va_pad * q.elt;
    q.K = p.D;
    q.N = p.Va_pad;
    q.KS = p.ks_head;
    q.part = p.p_head;
  }
  q.kc = q.K / q.KS;
  q.CR = q.wkind == 2 ? q.kc : chunk_rows(q.kc, q.wkind);
  q.nch = q.kc / q.CR;
  q.tiles = q.N / COLS;
  q.items = q.tiles * q.KS;
  return q;
}

// The block's ring of weight chunks.  The issue cursor (st, pass, it, ch)
// walks the block's chunks in the order the stages consume them, across
// layers and passes; top_up keeps RING chunks in flight.  Block-uniform.
struct Ring {
  uint8_t* buf;  // RING x CHUNK_BYTES, 128-aligned
  int issued, consumed;
  int st, pass, it, ch;
};

// Moves the cursor to the next stage holding an item of this block whose
// weights go through the ring (the f32 head reads its weights directly).
__device__ void settle(const Params& p, Ring& r) {
  while (r.pass < p.N - 1) {
    const Prod q = prod(p, r.st, r.pass);
    if (q.wkind != 2 && r.it < q.items) return;
    r.it = blockIdx.x;
    r.ch = 0;
    if (++r.st > 4 * p.L) {
      r.st = 0;
      ++r.pass;
    }
  }
}

// Chunk ch of item it: CR rows x 128 columns, each row's 16-byte pieces
// stored at piece c ^ 2 ((row / 4) % 4), so the fragment reads of a warp
// fall in distinct banks.
__device__ void issue_one(const Params& p, Ring& r) {
  const Prod q = prod(p, r.st, r.pass);
  uint8_t* dst = r.buf + (r.issued % RING) * CHUNK_BYTES;
  const int ct = r.it % q.tiles, ks = r.it / q.tiles;
  const int k0 = ks * q.kc + r.ch * q.CR;
  const int row_bytes = COLS * q.elt, per_row = row_bytes / 16;
  const char* src = q.W + ((size_t)k0 * q.N + (size_t)ct * COLS) * q.elt;
  for (int i = threadIdx.x; i < q.CR * per_row; i += NT) {
    const int row = i / per_row, c = i % per_row;
    cp_async16(dst + row * row_bytes + ((c ^ (2 * ((row >> 2) & 3))) * 16),
               src + (size_t)row * q.N * q.elt + c * 16);
  }
  cp_async_commit();
  ++r.issued;
  if (++r.ch == q.nch) {
    r.ch = 0;
    r.it += gridDim.x;
    settle(p, r);
  }
}

__device__ __forceinline__ void top_up(const Params& p, Ring& r) {
  while (r.issued - r.consumed < RING && r.pass < p.N - 1) issue_one(p, r);
}

// The oldest chunk in flight, once it has landed for every thread.  Past
// the barrier every thread is done with the chunk before it, whose slot then
// takes the next chunk of the cursor.
__device__ __forceinline__ const uint8_t* front(const Params& p, Ring& r) {
  cp_async_wait(r.issued - r.consumed - 1);
  __syncthreads();
  top_up(p, r);
  return r.buf + (r.consumed % RING) * CHUNK_BYTES;
}

__device__ __forceinline__ void pop(Ring& r) { ++r.consumed; }

// ---------------------------------------------------------------------------
// Products: operand staging with the folded epilogues, mma work items
// ---------------------------------------------------------------------------

// Sum of the KS (<= 8) partials of element (r, n) of an [R, N] product, in
// order; the loads are issued together.
__device__ __forceinline__ float split8(const float* part, int KS, int R, int N, int r, int n) {
  float v[8];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    v[ks] = ks < KS ? __ldcg(part + ((size_t)ks * R + r) * N + n) : 0.f;
  float a = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    if (ks < KS) a += v[ks];
  return a;
}

// SwiGLU of element (r, n) from gate | up split sums [KS, R, 2F], scales s
// and the row's RMS scale, rounded to bf16: the down product's operand.
__device__ __forceinline__ float swiglu8(const float* part, int KS, int R, int F, int r, int n,
                                         const float* __restrict__ s, float rsr) {
  const float g = split8(part, KS, R, 2 * F, r, n) * __ldg(s + n) * rsr;
  const float u = split8(part, KS, R, 2 * F, r, F + n) * __ldg(s + F + n) * rsr;
  return bf16r(g * (1.f / (1.f + expf(-g))) * u);
}

enum OpKind { OP_INPUT, OP_RES, OP_ATTN, OP_SWIGLU, OP_HEAD };

// The operand of a product, row r and K index k, in f32.
//   OP_INPUT: the pass's input row (pass 0: x0 and the embedding of c0;
//             then the embedding of the codebook drawn last);
//   OP_RES:   h_src + (the previous product's split sum) s: the residual;
//   OP_ATTN:  the attention output (bf16-valued);
//   OP_SWIGLU: SwiGLU of the gate-up split sums, RMS scale rsv[r] (bf16-valued);
//   OP_HEAD:  stream r's last row of the final residual, times rsv[r].
struct Operand {
  int kind, R, T, pass;
  int Rp;              // rows of the partials read (OP_RES, OP_HEAD: the pass's R)
  const float* h_src;  // OP_RES, OP_HEAD
  const float* part;   // split sums read (OP_RES, OP_SWIGLU, OP_HEAD)
  int ks;              // their K splits
  const float* s;      // their per-column scales
  float* h_dst;        // OP_INPUT, OP_RES: the residual slice written by column tile 0
  float* ss;           // and the per-row sums of squares of the slice, [KS, R]
  const float* rsv;    // shared: per-row RMS scales (OP_SWIGLU, OP_HEAD)
};

__device__ __forceinline__ float emb_at(const Params& p, int row, int k) {
  return p.emb_bf16 ? __bfloat162float(static_cast<const bf16*>(p.emb)[(size_t)row * p.D + k])
                    : static_cast<const float*>(p.emb)[(size_t)row * p.D + k];
}

template <int KIND>
__device__ __forceinline__ float operand_at(const Params& p, const Operand& op, int r, int k) {
  switch (KIND) {
    case OP_INPUT: {
      if (op.T == 2) {
        const int b = r >> 1;
        return (r & 1) ? emb_at(p, __ldcg(p.samples + b * p.N), k) : __ldg(p.x0 + (size_t)b * p.D + k);
      }
      return emb_at(p, __ldcg(p.samples + r * p.N + op.pass) + op.pass * p.Va, k);
    }
    case OP_RES:
      return __ldcg(op.h_src + (size_t)r * p.D + k) +
             split8(op.part, op.ks, op.Rp, p.D, r, k) * __ldg(op.s + k);
    case OP_ATTN:
      return __ldcg(p.attn + (size_t)r * p.nq * p.hd + k);
    case OP_SWIGLU:
      return swiglu8(op.part, op.ks, op.R, p.F, r, k, op.s, op.rsv[r]);
    default: {
      const int rr = r * op.T + op.T - 1;
      return (__ldcg(op.h_src + (size_t)rr * p.D + k) +
              split8(op.part, op.ks, op.Rp, p.D, rr, k) * __ldg(op.s + k)) * op.rsv[r];
    }
  }
}

// Rows [0, R) x K indices [k0, k0 + W) of the operand into X (bf16, row
// stride XS); with h_dst, the f32 values into the residual.  Rows of X past
// R are left as they are: they meet only output columns that are never
// written.  Each thread computes SB elements before it stores any, so their
// loads are in flight together.
template <int KIND>
__device__ void stage_x(const Params& p, const Operand& op, float* h_dst, int k0, int W, int XS,
                        bf16* X) {
  constexpr int SB = 4;
  const int n = op.R * W;
  __syncthreads();  // the last chunk's readers of X are done
  for (int i0 = threadIdx.x; i0 < n; i0 += SB * NT) {
    float v[SB];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * NT;
      v[u] = i < n ? operand_at<KIND>(p, op, i / W, k0 + i % W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * NT;
      if (i >= n) break;
      const int r = i / W, c = i % W;
      if (h_dst != nullptr) h_dst[(size_t)r * p.D + k0 + c] = v[u];
      X[r * XS + c] = __float2bfloat16_rn(v[u]);
    }
  }
}

__device__ void stage_any(const Params& p, const Operand& op, float* h_dst, int k0, int W, int XS,
                          bf16* X) {
  switch (op.kind) {
    case OP_INPUT: stage_x<OP_INPUT>(p, op, h_dst, k0, W, XS, X); break;
    case OP_RES: stage_x<OP_RES>(p, op, h_dst, k0, W, XS, X); break;
    case OP_ATTN: stage_x<OP_ATTN>(p, op, h_dst, k0, W, XS, X); break;
    case OP_SWIGLU: stage_x<OP_SWIGLU>(p, op, h_dst, k0, W, XS, X); break;
    default: stage_x<OP_HEAD>(p, op, h_dst, k0, W, XS, X); break;
  }
}

// The A fragment of k16 slice s for this warp's 16 columns: weights W[k][n]
// widened to bf16, column m = g <-> tile column 16 warp + 2g, m = g + 8 <->
// 16 warp + 2g + 1; the k slots 2t, 2t+1, 2t+8, 2t+9 <-> rows 16s + 4t + 0..3
// (the activations' B fragment is then one 8-byte load of 4 adjacent k).
template <int WK>
__device__ __forceinline__ void load_a(const uint8_t* w, int s, int warp, int g, int t,
                                       uint32_t (&a)[4]) {
  uint32_t v[4];
  if constexpr (WK == 0) {
    const int off = ((warp ^ (2 * t)) * 16) + 2 * g;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *reinterpret_cast<const uint16_t*>(w + (16 * s + 4 * t + i) * COLS + off);
    auto lo = [](uint32_t x) { return (float)(int8_t)(x & 0xff); };
    auto hi = [](uint32_t x) { return (float)(int8_t)(x >> 8); };
    a[0] = pack_bf16(lo(v[0]), lo(v[1]));
    a[1] = pack_bf16(hi(v[0]), hi(v[1]));
    a[2] = pack_bf16(lo(v[2]), lo(v[3]));
    a[3] = pack_bf16(hi(v[2]), hi(v[3]));
  } else {
    const int off = (((2 * warp + (g >> 2)) ^ (2 * t)) * 16) + 4 * (g & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *reinterpret_cast<const uint32_t*>(w + (16 * s + 4 * t + i) * 2 * COLS + off);
    a[0] = __byte_perm(v[0], v[1], 0x5410);
    a[1] = __byte_perm(v[0], v[1], 0x7632);
    a[2] = __byte_perm(v[2], v[3], 0x5410);
    a[3] = __byte_perm(v[2], v[3], 0x7632);
  }
}

// Per-row sums of squares of the residual slice this item wrote, in a fixed
// order (lanes along K, then the warp's butterfly).
__device__ void slice_ss(const Params& p, const Operand& op, int k0, int kc, int ks) {
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < op.R; r += NWARP) {
    float s = 0.f;
#pragma unroll 8
    for (int k = lane; k < kc; k += 32) {
      const float v = __ldcg(op.h_dst + (size_t)r * p.D + k0 + k);
      s = fmaf(v, v, s);
    }
    s = warp_sum(s);
    if (lane == 0) op.ss[ks * op.R + r] = s;
  }
}

// One work item on the tensor cores: part[ks, r, n] = sum over split ks of
// x[r, k] W[k, n] for the tile's 128 columns, NRB blocks of 8 rows.
template <int NRB, int WK>
__device__ void mma_item(const Params& p, Ring& ring, const Prod& q, int it, const Operand& op,
                         bf16* X) {
  const int ct = it % q.tiles, ks = it / q.tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  // Chunks whose operand rows are staged together: as many as X holds.
  const int gch = max(1, min(q.nch, (X_BYTES / (2 * 8 * NRB) - 8) / q.CR));
  const int XS = gch * q.CR + 8;
  float* h_dst = ct == 0 ? op.h_dst : nullptr;
  float acc[NRB][4];
#pragma unroll
  for (int rb = 0; rb < NRB; ++rb)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[rb][c] = 0.f;
  for (int ch0 = 0; ch0 < q.nch; ch0 += gch) {
    const int nj = min(gch, q.nch - ch0);
    stage_any(p, op, h_dst, ks * q.kc + ch0 * q.CR, nj * q.CR, XS, X);
    for (int j = 0; j < nj; ++j) {
      const uint8_t* w = front(p, ring);
      const bf16* xj = X + j * q.CR;
#pragma unroll 4
      for (int s = 0; s < q.CR / 16; ++s) {
        uint32_t a[4];
        load_a<WK>(w, s, warp, g, t, a);
#pragma unroll
        for (int rb = 0; rb < NRB; ++rb) {
          const uint2 x =
              *reinterpret_cast<const uint2*>(xj + (rb * 8 + g) * XS + 16 * s + 4 * t);
          mma16816(acc[rb], a, x.x, x.y);
        }
      }
      pop(ring);
    }
  }
  const int n0 = ct * COLS + 16 * warp + 2 * g;
#pragma unroll
  for (int rb = 0; rb < NRB; ++rb) {
    const int r0 = rb * 8 + 2 * t;
    if (r0 < op.R)
      *reinterpret_cast<float2*>(q.part + ((size_t)ks * op.R + r0) * q.N + n0) =
          make_float2(acc[rb][0], acc[rb][2]);
    if (r0 + 1 < op.R)
      *reinterpret_cast<float2*>(q.part + ((size_t)ks * op.R + r0 + 1) * q.N + n0) =
          make_float2(acc[rb][1], acc[rb][3]);
  }
  if (h_dst != nullptr) slice_ss(p, op, ks * q.kc, q.kc, ks);
}

// The f32 head's work item (CUDA cores): a thread per column, the split's
// f32 operand rows staged whole, W read directly.
__device__ void f32_item(const Params& p, const Prod& q, int it, const Operand& op, float* Xf) {
  const int ct = it % q.tiles, ks = it / q.tiles;
  __syncthreads();
  for (int i = threadIdx.x; i < op.R * q.kc; i += NT)
    Xf[i] = operand_at<OP_HEAD>(p, op, i / q.kc, ks * q.kc + i % q.kc);
  __syncthreads();
  if (threadIdx.x < COLS) {
    const int col = ct * COLS + threadIdx.x;
    const float* W = reinterpret_cast<const float*>(q.W) + (size_t)ks * q.kc * q.N + col;
    for (int r = 0; r < op.R; ++r) {
      float a = 0.f;
      for (int k = 0; k < q.kc; ++k) a = fmaf(Xf[r * q.kc + k], __ldg(W + (size_t)k * q.N), a);
      q.part[((size_t)ks * op.R + r) * q.N + col] = a;
    }
  }
  __syncthreads();
}

// Every item of stage st that falls to this block.
__device__ void gemm_stage(const Params& p, Ring& ring, int st, int pass, const Operand& op,
                           void* work) {
  const Prod q = prod(p, st, pass);
  const int nrb = (op.R + 7) / 8;
  for (int it = blockIdx.x; it < q.items; it += gridDim.x) {
    bf16* X = static_cast<bf16*>(work);
    if (q.wkind == 2) f32_item(p, q, it, op, static_cast<float*>(work));
    else if (q.wkind == 0) {
      if (nrb <= 1) mma_item<1, 0>(p, ring, q, it, op, X);
      else if (nrb <= 2) mma_item<2, 0>(p, ring, q, it, op, X);
      else if (nrb <= 4) mma_item<4, 0>(p, ring, q, it, op, X);
      else mma_item<8, 0>(p, ring, q, it, op, X);
    } else {
      if (nrb <= 1) mma_item<1, 1>(p, ring, q, it, op, X);
      else if (nrb <= 2) mma_item<2, 1>(p, ring, q, it, op, X);
      else mma_item<4, 1>(p, ring, q, it, op, X);  // the head: R = B <= 32
    }
  }
}

// ---------------------------------------------------------------------------
// Attention, the draw
// ---------------------------------------------------------------------------

// RoPE, the K/V write and attention of (stream b, query head hq) for T rows
// at positions pos0.., layer l.  qkv comes as the fused product's split sums
// times its scales and the rows' RMS scale (from the slices' sums of
// squares).  The item of the group's first head writes the K/V scratch; every
// item takes its own rows' keys from its registers of k and v and the
// earlier positions from the scratch.
__device__ void attention_item(const Params& p, int l, int b, int hq, int T, int pos0, int R,
                               float* smem) {
  const int hd = p.hd, G = p.nq / p.nkv, kvh = hq / G, half = hd / 2;
  const int QKVN = (p.nq + 2 * p.nkv) * hd;
  float* raw = smem;                // [T][3][hd]: q, k, v
  float* rnd = raw + T * 3 * hd;    // [T][3][hd]: RoPE'd and bf16-rounded
  float* sc = rnd + T * 3 * hd;     // [T][NP]
  float* rs = sc + T * p.NP;        // [T]
  float* kf = rs + 2;               // [pos0][hd]: the scratch's earlier keys
  float* vf = kf + pos0 * hd;       // [pos0][hd]: and values
  __syncthreads();
  if (threadIdx.x < T) {
    const int r = b * T + threadIdx.x;
    rs[threadIdx.x] = __frsqrt_rn(split8(p.ss_a, p.ks_qkv, R, 1, r, 0) / (float)p.D + p.eps);
  }
  __syncthreads();
  const float* sq = p.sqkv + (size_t)l * QKVN;
  const size_t cache_row = (((size_t)l * p.B + b) * p.nkv + kvh) * p.NP;
#pragma unroll 4
  for (int i = threadIdx.x; i < pos0 * hd; i += NT) {
    kf[i] = __bfloat162float(p.kc[cache_row * hd + i]);
    vf[i] = __bfloat162float(p.vc[cache_row * hd + i]);
  }
  for (int i = threadIdx.x; i < T * 3 * hd; i += NT) {
    const int t = i / (3 * hd), w = i / hd % 3, d = i % hd;
    const int col = w == 0 ? hq * hd + d : (p.nq + (w - 1) * p.nkv + kvh) * hd + d;
    raw[i] = split8(p.p_qkv, p.ks_qkv, R, QKVN, b * T + t, col) * __ldg(sq + col) * rs[t];
  }
  __syncthreads();
  const bool writer = hq % G == 0;
  for (int i = threadIdx.x; i < T * 3 * hd; i += NT) {
    const int t = i / (3 * hd), w = i / hd % 3, d = i % hd;
    const float* x = raw + (t * 3 + w) * hd;
    const size_t at = (cache_row + pos0 + t) * hd + d;
    if (w == 2) {
      rnd[i] = bf16r(x[d]);
      if (writer) p.vc[at] = __float2bfloat16_rn(x[d]);
      continue;
    }
    const int pos = pos0 + t;
    const float xr = d < half ? -x[d + half] : x[d - half];
    const float y = __fadd_rn(__fmul_rn(x[d], __ldg(p.cosb + pos * hd + d)),
                              __fmul_rn(xr, __ldg(p.sinb + pos * hd + d)));
    rnd[i] = bf16r(y);
    if (w == 1 && writer) p.kc[at] = __float2bfloat16_rn(y);
  }
  __syncthreads();
  // Scores: a warp per (row, key); keys below pos0 from the scratch (staged).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = pos0 + T;
  for (int w = warp; w < T * nk; w += NWARP) {
    const int t = w / nk, j = w % nk;
    if (j > pos0 + t) continue;
    const float* q = rnd + t * 3 * hd;
    float s = 0.f;
    for (int d = lane; d < hd; d += 32) {
      const float k = j >= pos0 ? rnd[((j - pos0) * 3 + 1) * hd + d] : kf[j * hd + d];
      s = fmaf(q[d], k, s);
    }
    s = warp_sum(s);
    if (lane == 0) sc[t * p.NP + j] = s * p.scale;
  }
  __syncthreads();
  // Softmax over keys 0..pos0+t: a warp per row; bf16 probabilities.
  for (int t = warp; t < T; t += NWARP) {
    const int n = pos0 + t + 1;
    float* sg = sc + t * p.NP;
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
  // P.V: a thread per (row, dim); the output rounds to bf16, the o-proj operand.
  for (int i = threadIdx.x; i < T * hd; i += NT) {
    const int t = i / hd, d = i % hd;
    const float* pg = sc + t * p.NP;
    float acc = 0.f;
    for (int j = 0; j <= pos0 + t; ++j) {
      const float v = j >= pos0 ? rnd[((j - pos0) * 3 + 2) * hd + d] : vf[j * hd + d];
      acc = fmaf(pg[j], v, acc);
    }
    p.attn[(size_t)(b * T + t) * p.nq * hd + hq * hd + d] = bf16r(acc);
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// One draw from lg[0..Va) (shared memory): first-index argmax of the raw
// logits (greedy), else of top-k(lg) / max(temp, 1e-6) + gumbel, the top k
// kept with ties at the k-th value.  The k-th value is the k-th largest of
// the order keys' 16 high bits (exact on bf16-rounded logits), found by a
// radix select: two rounds of an 8-bit digit, each a 256-bin histogram in
// shared memory and a scan of it from the top by one warp.
__device__ int draw(const float* lg, int Va, const float* gum, float temp, int topk, bool greedy,
                    int* hist, float* redf, int* redi) {
  unsigned kth = 0u;
  const float t = fmaxf(temp, 1e-6f);
  if (!greedy) {
    int need = topk;
    unsigned prefix = 0u;
    for (int round = 0; round < 2; ++round) {
      const int shift = round == 0 ? 24 : 16;
      for (int i = threadIdx.x; i < 256; i += NT) hist[i] = 0;
      __syncthreads();
      for (int v = threadIdx.x; v < Va; v += NT) {
        const unsigned key = order_key(lg[v]);
        if (round == 0 || (key >> 24) == prefix) atomicAdd(&hist[(key >> shift) & 0xff], 1);
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        int s = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += hist[8 * lane + i];
        int S = s;  // keys in the bins of this lane and every lane above
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_down_sync(0xffffffffu, S, o);
          if (lane + o < 32) S += y;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, S >= need);
        if (lane == 31 - __clz(mask)) {
          int cum = S - s;
          for (int bin = 8 * lane + 7; bin >= 8 * lane; --bin) {
            cum += hist[bin];
            if (cum >= need) {
              redi[0] = bin;
              redi[1] = cum - hist[bin];  // keys in the bins above
              break;
            }
          }
        }
      }
      __syncthreads();
      prefix = (prefix << 8) | (unsigned)redi[0];
      need -= redi[1];
      __syncthreads();
    }
    kth = prefix << 16;
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
__device__ void sample_codebook(const Params& p, const float* lg, int b, int i, int* hist,
                                float* redf, int* redi) {
  if (p.out_logits != nullptr)
    for (int v = threadIdx.x; v < p.Va_pad; v += NT)
      p.out_logits[((size_t)i * p.B + b) * p.Va_pad + v] = lg[v];
  const float* gum = p.gumbel + ((size_t)i * p.B + b) * p.Va;
  const int d = draw(lg, p.Va, gum, p.temp[b], p.topk[b], p.greedy != 0, hist, redf, redi);
  const int f = p.forced[b * p.N + i];
  if (threadIdx.x == 0) {
    if (p.out_draws != nullptr) p.out_draws[b * p.N + i] = d;
    p.samples[b * p.N + i] = f >= 0 ? f : d;
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

constexpr int SMALL_FLOATS = 2 * NWARP + 256 + 64;  // redf, redi, hist, rsv

__global__ void __launch_bounds__(NT, 1) fused_decoder_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  float* redf = reinterpret_cast<float*>(smem_raw + RING * CHUNK_BYTES);
  int* redi = reinterpret_cast<int*>(redf + NWARP);
  int* hist = redi + NWARP;
  float* rsv = reinterpret_cast<float*>(hist + 256);
  float* work = rsv + 64;
  const int nb = gridDim.x, bid = blockIdx.x;
  const int D = p.D, L = p.L;

  Ring ring{smem_raw, 0, 0, 0, 0, bid, 0};
  settle(p, ring);
  top_up(p, ring);  // the first stages' weights stream during c0's draws
  // The trace: block 0's clock (ns) at its start and as it leaves each grid
  // barrier, so stamp n - stamp n-1 is the stage that ends at barrier n.
  int n_sync = 0;
  const bool trace = p.stamps != nullptr && bid == 0 && threadIdx.x == 0;
  if (trace) p.stamps[0] = globaltimer();
  auto sync = [&] {
    grid_sync(p.bar);
    ++n_sync;
    if (trace) p.stamps[n_sync] = globaltimer();
  };
  if (bid == 0 && threadIdx.x == 0) atomicExch(p.bar + 2, 0u);

  // c0 from the backbone's logits.
  for (int b = bid; b < p.B; b += nb) {
    for (int v = threadIdx.x; v < p.Va_pad; v += NT)
      work[v] = v < p.Va ? p.c0lg[(size_t)b * p.Va + v] : NEG_INF;
    __syncthreads();
    sample_codebook(p, work, b, 0, hist, redf, redi);
  }
  sync();

  const Prod head = prod(p, 4 * L, 0);
  for (int i = 0; i + 1 < p.N; ++i) {
    const int T = i == 0 ? 2 : 1, pos0 = i == 0 ? 0 : i + 1, R = p.B * T;
    for (int l = 0; l < L; ++l) {
      // QKV on h_in = the pass's input (layer 0) or h_mid + down's split sums.
      Operand op{};
      op.R = op.Rp = R;
      op.T = T;
      op.pass = i;
      op.h_dst = p.ha;
      op.ss = p.ss_a;
      if (l == 0) {
        op.kind = OP_INPUT;
      } else {
        op.kind = OP_RES;
        op.h_src = p.hm;
        op.part = p.p_down;
        op.ks = p.ks_down;
        op.s = p.sdown + (size_t)(l - 1) * D;
      }
      gemm_stage(p, ring, 4 * l, i, op, work);
      sync();
      for (int it = bid; it < p.B * p.nq; it += nb)
        attention_item(p, l, it / p.nq, it % p.nq, T, pos0, R, work);
      sync();
      // o-proj on the attention output.
      op = Operand{};
      op.kind = OP_ATTN;
      op.R = op.Rp = R;
      gemm_stage(p, ring, 4 * l + 1, i, op, work);
      sync();
      // gate-up on h_mid = h_in + o-proj's split sums.
      op = Operand{};
      op.kind = OP_RES;
      op.R = op.Rp = R;
      op.h_src = p.ha;
      op.part = p.p_o;
      op.ks = p.ks_o;
      op.s = p.so + (size_t)l * D;
      op.h_dst = p.hm;
      op.ss = p.ss_m;
      gemm_stage(p, ring, 4 * l + 2, i, op, work);
      sync();
      // down on SwiGLU of gate-up's split sums, h_mid's RMS scale.
      op = Operand{};
      op.kind = OP_SWIGLU;
      op.R = op.Rp = R;
      op.part = p.p_gu;
      op.ks = p.ks_gu;
      op.s = p.sgu + (size_t)l * 2 * p.F;
      op.rsv = rsv;
      if (bid < prod(p, 4 * l + 3, i).items) {
        for (int r = threadIdx.x; r < R; r += NT) {
          rsv[r] = __frsqrt_rn(split8(p.ss_m, p.ks_gu, R, 1, r, 0) / (float)D + p.eps);
        }
        __syncthreads();
      }
      gemm_stage(p, ring, 4 * l + 3, i, op, work);
      sync();
    }

    // The head on each stream's last row of h_out = h_mid + down's split
    // sums, final-normed (the norm weight is folded into the head).
    Operand op{};
    op.kind = OP_HEAD;
    op.R = p.B;
    op.Rp = R;
    op.T = T;
    op.h_src = p.hm;
    op.part = p.p_down;
    op.ks = p.ks_down;
    op.s = p.sdown + (size_t)(L - 1) * D;
    op.rsv = rsv;
    if (bid < head.items) {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int b = warp; b < p.B; b += NWARP) {
        const int rr = b * T + T - 1;
        float ss = 0.f;
#pragma unroll 8
        for (int k = lane; k < D; k += 32) {
          const float v = __ldcg(p.hm + (size_t)rr * D + k) +
                          split8(p.p_down, p.ks_down, R, D, rr, k) * __ldg(op.s + k);
          ss = fmaf(v, v, ss);
        }
        ss = warp_sum(ss);
        if (lane == 0) rsv[b] = __frsqrt_rn(ss / (float)D + p.eps);
      }
      __syncthreads();
      gemm_stage(p, ring, 4 * L, i, op, work);
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        add_release(p.bar + 2, (unsigned)((head.items - 1 - bid) / nb + 1));
      }
    }
    // Codebook i + 1: each stream's draw waits for every head item.
    const float* hs = p.head_scale + (size_t)i * p.Va_pad;
    for (int b = bid; b < p.B; b += nb) {
      wait_count(p.bar + 2, (unsigned)((i + 1) * head.items));
      for (int v = threadIdx.x; v < p.Va_pad; v += NT) {
        float a = split8(p.p_head, p.ks_head, p.B, p.Va_pad, b, v);
        if (p.head_kind == 1) a *= __ldg(hs + v);
        work[v] = v < p.Va ? bf16r(a) : NEG_INF;
      }
      __syncthreads();
      sample_codebook(p, work, b, i + 1, hist, redf, redi);
    }
    if (i + 2 < p.N) sync();  // the next pass reads the draws
  }
  if (bid == 0 && threadIdx.x == 0) p.bar[3] = (unsigned)n_sync;
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

struct Splits {
  int qkv, o, gu, down, head;
};

Splits splits(int D, int QKVN, int nqh, int F, int Va_pad) {
  return Splits{pick_ks(D, QKVN), pick_ks(nqh, D), pick_ks(D, 2 * F), pick_ks(F, D),
                pick_ks(D, Va_pad)};
}

Layout layout_of(int B, int D, int QKVN, int nqh, int F, int Va_pad) {
  const Splits k = splits(D, QKVN, nqh, F, Va_pad);
  return layout(B, D, QKVN, nqh, F, Va_pad, k.qkv, k.o, k.gu, k.down, k.head);
}

// Whether every product's K split streams in whole chunks (and, for the f32
// head, fits the staging area).
bool shapes_ok(int D, int QKVN, int nqh, int F, int Va_pad, int head_kind) {
  const Splits k = splits(D, QKVN, nqh, F, Va_pad);
  const int Ks[5] = {D, nqh, D, F, D}, KS[5] = {k.qkv, k.o, k.gu, k.down, k.head};
  const int Ns[5] = {QKVN, D, 2 * F, D, Va_pad};
  const int hw = head_kind == 0 ? 1 : head_kind == 1 ? 0 : 2;
  for (int i = 0; i < 5; ++i) {
    const int wk = i == 4 ? hw : 0;
    if (Ks[i] % 16 != 0 || Ns[i] % COLS != 0 || Ks[i] % (16 * KS[i]) != 0) return false;
    const int kc = Ks[i] / KS[i];
    if (wk != 2 && kc % chunk_rows(kc, wk) != 0) return false;
  }
  return true;
}

size_t smem_bytes(int D, int Va_pad, int hd, int NP, int head_kind) {
  const size_t x = X_BYTES;
  const size_t att = (2 * 2 * 3 * hd + 2 * NP + 2 + 2 * (size_t)NP * hd) * sizeof(float);
  const size_t lg = (size_t)Va_pad * sizeof(float);
  const size_t f32 = head_kind == 2 ? 32 * (size_t)(D / pick_ks(D, Va_pad)) * sizeof(float) : 0;
  size_t w = x > att ? x : att;
  w = w > lg ? w : lg;
  w = w > f32 ? w : f32;
  return RING * CHUNK_BYTES + SMALL_FLOATS * sizeof(float) + w;
}

// Blocks of the cooperative grid: one per SM (the ring and the staged
// operand take most of its shared memory; 255 registers a thread leave the
// products unspilled), all resident.
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
  *out = sms;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of the f32 scratch fused_decode takes at these shapes (Layout).
long long fd_scratch_floats(int B, int D, int nq, int nkv, int hd, int F, int Va_pad) {
  return layout_of(B, D, (nq + 2 * nkv) * hd, nq * hd, F, Va_pad).total;
}

// One frame.  Shapes and types as in Params; every pointer on the current
// device, contiguous; scratch holds scratch_floats floats (at least
// fd_scratch_floats); bar holds 4 words, zeroed once when allocated (the
// kernel re-arms them; bar[3] then holds the launch's count of grid
// barriers); stamps, if not null, receives block 0's clock (ns, 64 bits) at
// its start and as it leaves each grid barrier.  Launches one cooperative
// kernel on ``stream``.
int fused_decode(const void* temp, const void* topk, const void* forced, const void* x0,
                 const void* c0lg, const void* wqkv, const void* wo, const void* wgu,
                 const void* wdown, const void* sqkv, const void* so, const void* sgu,
                 const void* sdown, const void* cosb, const void* sinb, const void* head,
                 const void* head_scale, const void* gumbel, const void* emb, void* samples,
                 void* out_logits, void* out_draws, void* scratch, long long scratch_floats,
                 void* kc, void* vc, void* bar, void* stamps, int B, int N, int Va, int Va_pad, int D, int L,
                 int nq, int nkv, int hd, int F, int NP, int greedy, int head_kind, int emb_bf16,
                 float eps, void* stream) {
  const int QKVN = (nq + 2 * nkv) * hd, nqh = nq * hd;
  if (B < 1 || B > 32 || N < 2 || nkv <= 0 || nq % nkv != 0 || nq / nkv > G_MAX ||
      hd > HD_MAX || hd % 2 != 0 || NP < N || NP > NP_MAX || Va > Va_pad || head_kind < 0 ||
      head_kind >= HEAD_KINDS || !shapes_ok(D, QKVN, nqh, F, Va_pad, head_kind))
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout_of(B, D, QKVN, nqh, F, Va_pad);
  if (lay.total > scratch_floats) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, Va_pad, hd, NP, head_kind);
  int nb = 0;
  cudaError_t e = grid_blocks(smem, &nb);
  if (e != cudaSuccess) return (int)e;
  const Splits k = splits(D, QKVN, nqh, F, Va_pad);
  Params p;
  p.B = B; p.N = N; p.Va = Va; p.Va_pad = Va_pad; p.D = D; p.L = L; p.nq = nq; p.nkv = nkv;
  p.hd = hd; p.F = F; p.NP = NP; p.greedy = greedy; p.head_kind = head_kind;
  p.emb_bf16 = emb_bf16;
  p.ks_qkv = k.qkv; p.ks_o = k.o; p.ks_gu = k.gu; p.ks_down = k.down; p.ks_head = k.head;
  p.eps = eps; p.scale = (float)(1.0 / sqrt((double)hd));
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
  float* s = static_cast<float*>(scratch);
  p.ha = s + lay.ha; p.hm = s + lay.hm; p.attn = s + lay.attn; p.p_qkv = s + lay.p_qkv;
  p.p_o = s + lay.p_o; p.p_gu = s + lay.p_gu; p.p_down = s + lay.p_down;
  p.p_head = s + lay.p_head; p.ss_a = s + lay.ss_a; p.ss_m = s + lay.ss_m;
  p.kc = static_cast<bf16*>(kc);
  p.vc = static_cast<bf16*>(vc);
  p.bar = static_cast<unsigned*>(bar);
  p.stamps = static_cast<unsigned long long*>(stamps);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)fused_decoder_kernel, dim3(nb), dim3(NT), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
