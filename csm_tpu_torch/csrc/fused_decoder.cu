// The fused codebook loop for Hopper (sm_90a): all codebooks of one frame in
// one persistent cooperative kernel.
//
// Replaces csm_tpu/ops/fused_decoder.py::fused_decode_codebooks (the Pallas
// TPU kernel built by _make_kernel).  Same function: sample c0 from the
// backbone's bf16-rounded logits, run the 4-layer decoder over
// [proj(h); proj(embed(c0))] at positions 0..1, then for each codebook i in
// 1..N-1 apply head slice i-1 to the last hidden, draw (top-k over the
// logits' bf16 bit patterns, then Gumbel-max with the given noise; greedy is
// a first-index argmax), honour the forced prefix, and (except after the
// last codebook) run one decoder pass on the drawn token's pre-projected
// embedding.  Weights are int8 per output channel with the RMSNorm weights
// folded in (W8A16): each pre-norm product runs on bf16 of the raw f32
// residual and RMSNorm's per-row scale multiplies its output.  Attention has
// bf16 operands (q, the K/V scratch, the probabilities) with f32 scores and
// softmax; the head is bf16, int8 (+ per-column scale) or f32 (CUDA cores).
//
// What the TPU kernel did for its hardware is not carried over: there it kept
// ~106 MB of int8 weights resident in VMEM for all passes.  An H100 has a
// 50 MB L2 and 227 KB of shared memory a block, so every pass streams the
// weights from device memory.  What bounds it is bytes: 31 passes over the
// 111 MB of int8 decoder weights (27.8 MB a layer) plus the head slices,
// ~1.07 ms a frame at 3.35 TB/s.  The design is the backbone step's
// (csrc/bb_step.cuh, whose flags, tickets, weight ring and int8 / bf16
// products it uses):
//
// - One cooperative launch a frame, one block per SM, all resident, no grid
//   barrier.  Every block walks one static list of work items fixed by the
//   shapes: first the draws of c0 (one item a stream), then one pass a
//   position p = 0 .. N-1 (position 0 is x0, position 1 the embedding of c0,
//   position p the embedding of codebook p-1): an input item per 128
//   residual columns, per layer the QKV items (128 columns by one K split),
//   attention per (kv head, stream), o-proj, gate-up (each tile 64 gate
//   columns with their 64 up columns, so SwiGLU is the tile's epilogue) and
//   down; then, from position 1 on, the final norm per 128 columns, the head
//   slice's items and one draw item a stream (codebook p).  Item i falls to
//   block i mod grid, which takes its items in list order; an item waits only
//   on items before it in the list, each at a block past it or at it, so
//   with every block resident nothing can deadlock.  Running position 0 as a
//   pass of its own keeps every pass at B rows (B <= 32); its rows are
//   computed row by row as in a two-row pass, and the c0 draws overlap it.
// - Flags in place of barriers: per (pass, layer) item flags in device
//   memory stamped with the launch's epoch (no reset between launches).  An
//   input item waits on the previous codebook's draws and the previous
//   pass's last down tile of its columns; a QKV split on the input (layer 0)
//   or down tiles of its K range; attention on the QKV tiles of its group's
//   q heads, k and v; an o-proj split on the attention items of its K range;
//   gate-up on the o-proj tiles of its range; down on the gate-up pair tiles
//   of its range; the final norm on every last down tile (its scale needs
//   the whole row); a head split on the final tiles of its range; a draw on
//   every head tile.  RMSNorm stays folded into the products: a split starts
//   once the tiles of its own K range are in, and the row's scale (summed in
//   order from the residual tiles' sums of squares) is applied in the tile's
//   epilogue.
// - Split sums reduced once per tile: each K split writes its f32 partial
//   and takes a ticket on the tile; the last to arrive sums the partials in
//   split order and applies the epilogue once (scales and RMS scale, RoPE and
//   the K/V rows for QKV; the residual add with the tile's per-row sums of
//   squares and the next product's bf16 operand for o-proj and down; SwiGLU
//   for gate-up; the head's scale and bf16 rounding).  So a product stages a
//   compact bf16 operand of B x K (64 KB at B = 32, K = 1024) once per
//   chunk group, instead of summing the previous product's partials in every
//   column tile.  K splits come from pick_ks, by the shape alone (never by B
//   or the grid), so a stream's sums run in the same order alone and batched,
//   and bitwise the same from launch to launch.
// - A weight stream that never waits on data: 8 consumer warps and a
//   producer warpgroup that copies the block's weight chunks (16 KB: 128
//   int8 rows or 64 bf16 rows of 128 columns) in consumption order across
//   stages, layers and passes into a ring of RING mbarrier-tracked slots by
//   cp.async, waiting only for a free slot.  Rings of 3 to 8 chunks measured
//   within 1 % of each other at B = 1, 8 and 32 on the H100 (PERF.md); 6
//   leaves shared memory for longer item plans.  PR 7 found deeper rings
//   slower because after each of its grid barriers every block re-summed its
//   operand from L2 while its ring refilled, and the bytes in flight delayed
//   those loads; here an operand is written once per tile and its staging
//   is one compact read, so the depth no longer trades against it.  Asking
//   L2 for the chunks past the ring measured slower (as for the backbone).
// - Products on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
//   sums; up to 4 blocks of 8 rows an operand), each split's slices chained
//   in order in one accumulator, as a tensor-core GEMM of the plain version
//   sums them (two interleaved chains read further from it); the f32 head
//   on the CUDA cores, its weights read directly.  Attention and the draw (a
//   radix select of the k-th bf16 key in two 8-bit rounds, its tie rule,
//   then Gumbel-max, the row's logits and noise held in registers) run on a
//   whole block.
// - Counters: the kernel's own count of grid barriers (it has none), of its
//   items, of the items whose waits found a flag still closed and of the
//   producer's waits for a free slot, left in the scratch after each launch.
// - Traces: with a stamps buffer, block 0 records its clock at its start and
//   as it leaves each stage of the list; with an item buffer, every item's
//   stage, start, end of waits, marks inside it and end.
//
// Data another block wrote is read through L2 (__ldcg).  The scratch (Layout:
// residual, operands, logits, K/V rows, partials, flags, tickets, counters) is
// the caller's and is kept across calls: flags, tickets and counters are
// zeroed once when it is allocated, and every launch passes the next epoch.

#include "bb_step.cuh"

namespace {

constexpr int NP_MAX = 64;           // positions a stream's K/V rows hold (N)
constexpr int HEAD_KINDS = 3;        // 0 bf16, 1 int8 (+ scale), 2 f32
constexpr int RING = 6;              // weight chunks in a block's ring (PERF.md)
constexpr int DRAW_VPT = 16;         // logits a thread of a draw holds (Va_pad <= DRAW_VPT NT)
// Staged operand rows of a product: 32 rows of a whole 1024-row split (8
// int8 chunks) and their padding, so a gate-up or down split at B = 32
// stages once (bb_step.cuh's X_BYTES holds 7 chunks).
constexpr int FD_X_BYTES = 32 * (8 * CHUNK_ROWS + 8) * 2;
constexpr int PASS_EXTRA = 4;        // stages of a pass besides its layers': input, final, head, draw
constexpr int SYNC_OUT = 4;          // counter words of the last launch: scratch int32 [4, 8)
constexpr int K_DRAW = K_FINAL + 1;  // item kinds: bb_step.cuh's Kind, and the draw

// ---------------------------------------------------------------------------
// Shapes, schedule, scratch layout (host and device agree)
// ---------------------------------------------------------------------------

struct FdShape {
  int B, N, L, D, F, nq, nkv, hd, G, QKVN, nqh, Va, Va_pad, head_kind;
  int tq, td, tg, th;           // column tiles: QKV, D (o-proj, down), gate-up pairs, head
  int ksq, kso, ksg, ksd, ksh;  // K splits
  int hr;                       // K rows of a head chunk (bf16 64, int8 128; f32: 32, no ring)
};

__host__ __device__ inline FdShape fd_shape(int B, int N, int L, int D, int F, int nq, int nkv,
                                            int hd, int Va, int Va_pad, int head_kind) {
  FdShape s;
  s.B = B; s.N = N; s.L = L; s.D = D; s.F = F; s.nq = nq; s.nkv = nkv; s.hd = hd;
  s.Va = Va; s.Va_pad = Va_pad; s.head_kind = head_kind;
  s.G = nkv > 0 ? nq / nkv : 0;
  s.QKVN = (nq + 2 * nkv) * hd;
  s.nqh = nq * hd;
  s.tq = s.QKVN / COLS;
  s.td = D / COLS;
  s.tg = F / (COLS / 2);
  s.th = Va_pad / COLS;
  s.ksq = pick_ks(D, s.tq, CHUNK_ROWS);
  s.kso = pick_ks(s.nqh, s.td, CHUNK_ROWS);
  s.ksg = pick_ks(D, s.tg, CHUNK_ROWS);
  s.ksd = pick_ks(F, s.td, CHUNK_ROWS);
  s.hr = head_kind == 0 ? CHUNK_ROWS / 2 : head_kind == 1 ? CHUNK_ROWS : CHUNK_ROWS / 4;
  s.ksh = pick_ks(D, s.th, s.hr);
  return s;
}

// Items of the frame's list: the c0 draws, pass 0 (input, layers), then
// passes 1 .. N-1 (input, layers, final norm, head, draws).
struct FdSched {
  int n_draw, n_init, n_qkv, n_att, n_o, n_gu, n_down, per_layer, n_fin, n_head;
  int pass0, pass, total;
};

__host__ __device__ inline FdSched fd_sched(const FdShape& s) {
  FdSched c;
  c.n_draw = s.B;
  c.n_init = s.td;
  c.n_qkv = s.tq * s.ksq;
  c.n_att = s.nkv * s.B;
  c.n_o = s.td * s.kso;
  c.n_gu = s.tg * s.ksg;
  c.n_down = s.td * s.ksd;
  c.per_layer = c.n_qkv + c.n_att + c.n_o + c.n_gu + c.n_down;
  c.n_fin = s.td;
  c.n_head = s.th * s.ksh;
  c.pass0 = c.n_init + s.L * c.per_layer;
  c.pass = c.pass0 + c.n_fin + c.n_head + c.n_draw;
  c.total = c.n_draw + c.pass0 + (s.N - 1) * c.pass;
  return c;
}

struct FdItem {
  int kind, pass, l, idx;
};

__device__ __forceinline__ FdItem fd_item_at(const FdSched& c, int L, int g) {
  if (g < c.n_draw) return FdItem{K_DRAW, 0, 0, g};  // codebook 0
  g -= c.n_draw;
  int p = 0, i = g;
  if (g >= c.pass0) {
    g -= c.pass0;
    p = 1 + g / c.pass;
    i = g % c.pass;
  }
  if (i < c.n_init) return FdItem{K_INIT, p, 0, i};
  i -= c.n_init;
  if (i < L * c.per_layer) {
    const int l = i / c.per_layer;
    int j = i - l * c.per_layer;
    if (j < c.n_qkv) return FdItem{K_QKV, p, l, j};
    j -= c.n_qkv;
    if (j < c.n_att) return FdItem{K_ATT, p, l, j};
    j -= c.n_att;
    if (j < c.n_o) return FdItem{K_O, p, l, j};
    j -= c.n_o;
    if (j < c.n_gu) return FdItem{K_GU, p, l, j};
    return FdItem{K_DOWN, p, l, j - c.n_gu};
  }
  i -= L * c.per_layer;
  if (i < c.n_fin) return FdItem{K_FINAL, p, L, i};
  i -= c.n_fin;
  if (i < c.n_head) return FdItem{K_HEAD, p, L, i};
  return FdItem{K_DRAW, p, L, i - c.n_head};
}

// Stage of an item in the traces: 0 the c0 draws; then per pass p, from 1 +
// p (5 L + PASS_EXTRA): input, 5 per layer (QKV, attention, o-proj, gate-up,
// down), final norm, head, draws.
__device__ __forceinline__ int fd_stage_of(const FdItem& it, int L) {
  if (it.kind == K_DRAW && it.pass == 0) return 0;
  const int base = 1 + it.pass * (5 * L + PASS_EXTRA);
  switch (it.kind) {
    case K_INIT: return base;
    case K_FINAL: return base + 5 * L + 1;
    case K_HEAD: return base + 5 * L + 2;
    case K_DRAW: return base + 5 * L + 3;
    default: return base + 1 + 5 * it.l + (it.kind - K_QKV);
  }
}

__host__ __device__ inline int fd_stage_count(int N, int L) { return 1 + N * (5 * L + PASS_EXTRA); }

struct FdLayout {
  long long sync, h, ss_a, ss_m, xa, xm, xo, xd, qb, xh, xhf, lg, kc, vc;
  long long p_qkv, p_o, p_gu, p_down, p_head;
  long long f_draw, f_init, f_qkv, f_att, f_o, f_gu, f_dn, f_fin, f_head;
  long long t_qkv, t_o, t_gu, t_dn, t_head, total;
};

// Byte offsets into the scratch, each 128-aligned; the counters first.
__host__ __device__ inline FdLayout fd_layout(const FdShape& s) {
  FdLayout o;
  long long at = 0;
  auto take = [&](long long bytes) { const long long x = at; at += (bytes + 127) / 128 * 128; return x; };
  const long long B = s.B, N = s.N, L = s.L;
  o.sync = take(16 * 4);  // int32: [0, 4) sums of this launch, [4, 8) the last launch's, 8 done
  o.h = take(B * s.D * 4);
  o.ss_a = take(B * s.td * 4);
  o.ss_m = take(B * s.td * 4);
  o.xa = take(B * s.D * 2);
  o.xm = take(B * s.D * 2);
  o.xo = take(B * s.nqh * 2);
  o.xd = take(B * s.F * 2);
  o.qb = take(B * s.nqh * 2);
  o.xh = take(B * s.D * 2);
  o.xhf = take(B * s.D * 4);
  o.lg = take(B * s.Va_pad * 4);
  o.kc = take(L * B * s.nkv * N * s.hd * 2);
  o.vc = take(L * B * s.nkv * N * s.hd * 2);
  o.p_qkv = take((long long)s.ksq * s.tq * B * COLS * 4);
  o.p_o = take((long long)s.kso * s.td * B * COLS * 4);
  o.p_gu = take((long long)s.ksg * s.tg * B * COLS * 4);
  o.p_down = take((long long)s.ksd * s.td * B * COLS * 4);
  o.p_head = take((long long)s.ksh * s.th * B * COLS * 4);
  o.f_draw = take(N * B * 4);
  o.f_init = take(N * s.td * 4);
  o.f_qkv = take(N * L * s.tq * 4);
  o.f_att = take(N * L * s.nkv * B * 4);
  o.f_o = take(N * L * s.td * 4);
  o.f_gu = take(N * L * s.tg * 4);
  o.f_dn = take(N * L * s.td * 4);
  o.f_fin = take(N * s.td * 4);
  o.f_head = take(N * s.th * 4);
  o.t_qkv = take(s.tq * 4);
  o.t_o = take(s.td * 4);
  o.t_gu = take(s.tg * 4);
  o.t_dn = take(s.td * 4);
  o.t_head = take(s.th * 4);
  o.total = at;
  return o;
}

// Shared memory of the work area: a product's staged operand and sums tile,
// attention's q, K and V rows and scores, a draw's logits row and histogram.
__host__ __device__ inline int fd_att_bytes(const FdShape& s) {
  return 4 * (s.G * s.hd + 2 * s.N * s.hd + s.G * s.N);
}
__host__ __device__ inline int fd_draw_bytes(const FdShape& s) { return 4 * (256 + 2 * NWARP); }
__host__ __device__ inline int fd_work_bytes(const FdShape& s) {
  const int prod = FD_X_BYTES + CT_BYTES, att = fd_att_bytes(s), drw = fd_draw_bytes(s);
  const int m = prod > att ? prod : att;
  return ((m > drw ? m : drw) + 127) / 128 * 128;
}

struct FdParams {
  Params bb;  // what bb_step.cuh's pieces read: s.B, s.D, s.td, eps, ring, h, item_ns
  FdShape s;
  unsigned epoch;
  int work;   // bytes of the work area
  int greedy, emb_bf16;
  float scale;
  const float* temp;    // [B]
  const int* topk;      // [B], in [1, Va]
  const int* forced;    // [B, N], -1 = draw
  const float* x0;      // [B, D]
  const float* c0lg;    // [B, Va], bf16-rounded
  const int8_t *wqkv, *wo, *wgu, *wdown;  // [L, K, N]
  const float *sqkv, *so, *sgu, *sdown;   // [L, N]
  const float *cosb, *sinb;               // [P >= N, hd]
  const void* head;                       // [N-1, D, Va_pad]
  const float* head_scale;                // [N-1, Va_pad] (int8 head)
  const float* gumbel;                    // [N, B, Va]
  const void* emb;                        // [N Va, D] bf16 or f32
  int* samples;                           // [B, N]
  float* out_logits;                      // [N, B, Va_pad] or null
  int* out_draws;                         // [B, N] or null
  unsigned* sync;                         // the counters
  float *ss_a, *ss_m, *xhf, *lg;
  float *p_qkv, *p_o, *p_gu, *p_down, *p_head;
  bf16 *xa, *xm, *xo, *xd, *qb, *xh, *kc, *vc;
  unsigned *f_draw, *f_init, *f_qkv, *f_att, *f_o, *f_gu, *f_dn, *f_fin, *f_head;
  unsigned *t_qkv, *t_o, *t_gu, *t_dn, *t_head;
  unsigned long long* stamps;  // [fd_stage_count + 1] or null
};

// Flags of pass p (layer l).
__device__ __forceinline__ unsigned* f_layer(unsigned* f, const FdShape& s, int p, int l, int n) {
  return f + ((size_t)p * s.L + l) * n;
}

// A product of the frame: weights (this layer's, or pass p's head slice),
// shape, splits, partials, ticket.  nch 0: the f32 head, read directly.
__device__ __forceinline__ Prod fd_prod(const FdParams& p, int kind, int pass, int l) {
  const FdShape& s = p.s;
  Prod q;
  q.P = 1;
  q.pair = 0;
  int kr = CHUNK_ROWS;
  switch (kind) {
    case K_QKV:
      q.K = s.D; q.N = s.QKVN; q.KS = s.ksq; q.tiles = s.tq; q.part = p.p_qkv; q.ticket = p.t_qkv;
      q.W = p.wqkv + (size_t)l * s.D * s.QKVN;
      break;
    case K_O:
      q.K = s.nqh; q.N = s.D; q.KS = s.kso; q.tiles = s.td; q.part = p.p_o; q.ticket = p.t_o;
      q.W = p.wo + (size_t)l * s.nqh * s.D;
      break;
    case K_GU:
      q.K = s.D; q.N = 2 * s.F; q.KS = s.ksg; q.tiles = s.tg; q.part = p.p_gu; q.ticket = p.t_gu;
      q.W = p.wgu + (size_t)l * s.D * 2 * s.F;
      q.pair = 1;
      break;
    case K_DOWN:
      q.K = s.F; q.N = s.D; q.KS = s.ksd; q.tiles = s.td; q.part = p.p_down; q.ticket = p.t_dn;
      q.W = p.wdown + (size_t)l * s.F * s.D;
      break;
    default: {  // the head slice of pass p (codebook p)
      const int eb = s.head_kind == 0 ? 2 : s.head_kind == 1 ? 1 : 4;
      q.K = s.D; q.N = s.Va_pad; q.KS = s.ksh; q.tiles = s.th; q.part = p.p_head;
      q.ticket = p.t_head;
      q.W = static_cast<const int8_t*>(p.head) + (size_t)(pass - 1) * s.D * s.Va_pad * eb;
      kr = s.hr;
      break;
    }
  }
  q.kc = q.K / q.KS;
  q.nch = kind == K_HEAD && s.head_kind == 2 ? 0 : q.kc / kr;
  return q;
}

__device__ __forceinline__ bool fd_is_prod(int kind) {
  return kind == K_QKV || kind == K_O || kind == K_GU || kind == K_DOWN || kind == K_HEAD;
}

// The block's plan for the producer (bb_step.cuh's Plan, each entry with
// its own chunk width: bf16 head rows are 16 pieces, int8 rows 8).
__device__ void fd_build_plan(const FdParams& p, const FdSched& sc, Plan* plan, int n_mine) {
  for (int i = threadIdx.x; i < n_mine; i += blockDim.x) {
    const FdItem it = fd_item_at(sc, p.s.L, blockIdx.x + i * gridDim.x);
    Plan e{nullptr, 0, 0, 0, 8};
    if (fd_is_prod(it.kind)) {
      const Prod q = fd_prod(p, it.kind, it.pass, it.l);
      if (q.nch > 0) {
        const int eb = it.kind == K_HEAD && p.s.head_kind == 0 ? 2 : 1;
        const int ct = it.idx % q.tiles, ks = it.idx / q.tiles;
        e.base = q.W + (size_t)ks * q.kc * q.N * eb + (q.pair ? ct * 64 : ct * COLS) * eb;
        e.N = q.N * eb;
        e.nch = q.nch;
        e.coff = q.pair ? (p.s.F - 64) * eb : 0;
        e.pieces = eb == 2 ? 16 : 8;
      }
    }
    plan[i] = e;
  }
  __syncthreads();
}

// An item's waits are over: records whether any thread found a flag closed
// (``closed`` is this item's word of shared memory; the main loop reads it).
__device__ __forceinline__ void waits_done(bool waited, int* closed) {
  if (waited) *closed = 1;
  csync();
}

__device__ __forceinline__ float emb_at(const FdParams& p, size_t row, int k) {
  return p.emb_bf16 ? __bfloat162float(static_cast<const bf16*>(p.emb)[row * p.s.D + k])
                    : static_cast<const float*>(p.emb)[row * p.s.D + k];
}

// ---------------------------------------------------------------------------
// Row items: the pass's input, the final norm
// ---------------------------------------------------------------------------

// Input tile cti of pass p: x0 (p = 0), else the embedding row of the code
// drawn at p-1 (offset by its codebook); the residual, its bf16 operand and
// the tile's sums of squares.
__device__ void fd_init(const FdParams& p, const FdItem& it, uint8_t* work, int* closed,
                        unsigned long long* tready) {
  const FdShape& s = p.s;
  const int cti = it.idx, c = threadIdx.x % COLS, r0 = threadIdx.x / COLS, n = cti * COLS + c;
  float* ct = reinterpret_cast<float*>(work + FD_X_BYTES);
  csync();  // the previous item's readers of the work area are done
  bool w = false;
  if (it.pass > 0) {
    w = wait_flags(p.f_draw + (size_t)(it.pass - 1) * s.B, s.B, p.epoch);
    w |= wait_flags(f_layer(p.f_dn, s, it.pass - 1, s.L - 1, s.td) + cti, 1, p.epoch);
  }
  waits_done(w, closed);
  mark(p.bb, tready, 0);
  // The rows' embedding rows (codes first), every load of a thread in flight.
  int* rowi = reinterpret_cast<int*>(work);
  if (threadIdx.x < s.B)
    rowi[threadIdx.x] = it.pass == 0 ? 0
                                     : __ldcg(p.samples + threadIdx.x * s.N + it.pass - 1) +
                                           (it.pass - 1) * s.Va;
  csync();
  float v[RPT];
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    const int r = r0 + 2 * e;
    v[e] = r >= s.B      ? 0.f
         : it.pass == 0 ? __ldg(p.x0 + (size_t)r * s.D + n)
                        : emb_at(p, (size_t)rowi[r], n);
  }
#pragma unroll
  for (int e = 0; e < RPT; ++e)
    if (r0 + 2 * e < s.B) ct[(r0 + 2 * e) * CT_STRIDE + c] = v[e];
  csync();
  residual_out<false>(p.bb, cti, ct, p.xa, false, 1.f, p.ss_a);
  signal(p.f_init + (size_t)it.pass * s.td + cti, p.epoch);
}

// Final norm of tile cti: the head's operand h rs (bf16, or f32 for the f32
// head), rs over the whole row.
__device__ void fd_final(const FdParams& p, const FdItem& it, uint8_t* work, float* rsv,
                         int* closed, unsigned long long* tready) {
  const FdShape& s = p.s;
  const int cti = it.idx, c = threadIdx.x % COLS, r0 = threadIdx.x / COLS, n = cti * COLS + c;
  csync();
  waits_done(wait_flags(f_layer(p.f_dn, s, it.pass, s.L - 1, s.td), s.td, p.epoch), closed);
  mark(p.bb, tready, 0);
  float* ssm = reinterpret_cast<float*>(work);
  for (int i = threadIdx.x; i < s.B * s.td; i += NT) ssm[i] = __ldcg(p.ss_a + i);
  csync();
  float hv[RPT];
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    const int r = r0 + 2 * e;
    hv[e] = r < s.B ? __ldcg(p.bb.h + (size_t)r * s.D + n) : 0.f;
  }
  row_scales(p.bb, ssm, rsv);
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    const int r = r0 + 2 * e;
    if (r >= s.B) continue;
    const float v = hv[e] * rsv[r];
    if (s.head_kind == 2) p.xhf[(size_t)r * s.D + n] = v;
    else p.xh[(size_t)r * s.D + n] = __float2bfloat16_rn(v);
  }
  signal(p.f_fin + (size_t)it.pass * s.td + cti, p.epoch);
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

// The f32 head's sums (CUDA cores): a thread per column, the split's f32
// operand rows staged whole, W read directly.
__device__ void f32_sums(const FdParams& p, const Prod& q, int idx, float* Xf, float* ct) {
  const FdShape& s = p.s;
  const int cti = idx % q.tiles, ks = idx / q.tiles;
  csync();
  for (int i = threadIdx.x; i < s.B * q.kc; i += NT)
    Xf[i] = __ldcg(p.xhf + (size_t)(i / q.kc) * s.D + ks * q.kc + i % q.kc);
  csync();
  if (threadIdx.x < COLS) {
    const float* W = reinterpret_cast<const float*>(q.W) + (size_t)ks * q.kc * q.N + cti * COLS +
                     threadIdx.x;
    for (int r = 0; r < s.B; ++r) {
      float a = 0.f;
      for (int k = 0; k < q.kc; ++k) a = fmaf(Xf[r * q.kc + k], __ldg(W + (size_t)k * q.N), a);
      ct[r * CT_STRIDE + threadIdx.x] = a;
    }
  }
  csync();
}

// The epilogue of a finished tile (sums in ct), once per tile, with the tile
// sums of squares in ssm and the residual tile in ht (combine); s0 / s1 the
// thread's column scales, tmp free shared memory.
__device__ void fd_epilogue(const FdParams& p, const FdItem& it, int cti, float* ct, float* rsv,
                            const float* ssm, const float* ht, float s0, float s1, float* tmp) {
  const FdShape& s = p.s;
  const int B = s.B, l = it.l, pos = it.pass;
  const int c = threadIdx.x % COLS, r0 = threadIdx.x / COLS, n = cti * COLS + c;
  switch (it.kind) {
    case K_QKV: {
      const int half = s.hd / 2, kv0 = s.nqh, v0 = s.nqh + s.nkv * s.hd, d = n % s.hd;
      float* cs = tmp;
      float* sn = tmp + s.hd;
      for (int i = threadIdx.x; i < s.hd; i += NT) {
        cs[i] = __ldg(p.cosb + (size_t)pos * s.hd + i);
        sn[i] = __ldg(p.sinb + (size_t)pos * s.hd + i);
      }
      row_scales(p.bb, ssm, rsv);  // synchronises the block
      for (int r = r0; r < B; r += 2) ct[r * CT_STRIDE + c] = ct[r * CT_STRIDE + c] * s0 * rsv[r];
      csync();
      // K/V rows: [L, B, nkv, N, hd], row pos.
      auto at = [&](int r, int kvh) {
        return ((((size_t)l * B + r) * s.nkv + kvh) * s.N + pos) * s.hd + d;
      };
      if (n >= v0) {
        for (int r = r0; r < B; r += 2)
          p.vc[at(r, (n - v0) / s.hd)] = __float2bfloat16_rn(ct[r * CT_STRIDE + c]);
        break;
      }
      const int pc = d < half ? c + half : c - half;
      for (int r = r0; r < B; r += 2) {
        const float x = ct[r * CT_STRIDE + c];
        const float xr = d < half ? -ct[r * CT_STRIDE + pc] : ct[r * CT_STRIDE + pc];
        const bf16 y = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x, cs[d]), __fmul_rn(xr, sn[d])));
        if (n < kv0) p.qb[(size_t)r * s.nqh + n] = y;
        else p.kc[at(r, (n - kv0) / s.hd)] = y;
      }
      break;
    }
    case K_O:
    case K_DOWN:
      for (int r = r0; r < B; r += 2)
        ct[r * CT_STRIDE + c] = __fadd_rn(ht[r * CT_STRIDE + c], __fmul_rn(ct[r * CT_STRIDE + c], s0));
      csync();
      residual_out<false>(p.bb, cti, ct, it.kind == K_O ? p.xm : p.xa, false, 1.f,
                          it.kind == K_O ? p.ss_m : p.ss_a);
      break;
    case K_GU: {
      // Thread i: gate column j = i % 64 of the pair tile, rows i / 64 + 4e.
      row_scales(p.bb, ssm, rsv);
      const int j = threadIdx.x % 64, f = cti * 64 + j;
      for (int r = threadIdx.x / 64; r < B; r += 4) {
        const float gt = ct[r * CT_STRIDE + j] * s0 * rsv[r];
        const float up = ct[r * CT_STRIDE + 64 + j] * s1 * rsv[r];
        p.xd[(size_t)r * s.F + f] = __float2bfloat16_rn(gt * (1.f / (1.f + expf(-gt))) * up);
      }
      break;
    }
    default:  // K_HEAD: the bf16-rounded logits (int8: times the column's scale)
      for (int r = r0; r < B; r += 2) {
        const float a = ct[r * CT_STRIDE + c];
        p.lg[(size_t)r * s.Va_pad + n] = bf16r(s.head_kind == 1 ? a * s0 : a);
      }
      break;
  }
}

__device__ void fd_product(const FdParams& p, Ring& ring, const FdItem& it, uint8_t* work,
                           float* rsv, int* flag, int* closed, unsigned long long* tready) {
  const FdShape& s = p.s;
  const Prod q = fd_prod(p, it.kind, it.pass, it.l);
  const int cti = it.idx % q.tiles, ks = it.idx / q.tiles, l = it.l;
  const int c = threadIdx.x % COLS, n = cti * COLS + c;
  // The column scales, loaded before the waits.
  float s0 = 1.f, s1 = 1.f;
  switch (it.kind) {
    case K_QKV: s0 = __ldg(p.sqkv + (size_t)l * s.QKVN + n); break;
    case K_O: s0 = __ldg(p.so + (size_t)l * s.D + n); break;
    case K_DOWN: s0 = __ldg(p.sdown + (size_t)l * s.D + n); break;
    case K_GU: {
      const int f = cti * 64 + threadIdx.x % 64;
      s0 = __ldg(p.sgu + (size_t)l * 2 * s.F + f);
      s1 = __ldg(p.sgu + (size_t)l * 2 * s.F + s.F + f);
      break;
    }
    default:
      if (s.head_kind == 1) s0 = __ldg(p.head_scale + (size_t)(it.pass - 1) * s.Va_pad + n);
      break;
  }
  // The flags of the operand's K range.
  const int k0 = ks * q.kc, k1 = k0 + q.kc - 1;
  bool w;
  switch (it.kind) {
    case K_QKV: {
      const unsigned* f = l == 0 ? p.f_init + (size_t)it.pass * s.td
                                 : f_layer(p.f_dn, s, it.pass, l - 1, s.td);
      w = wait_flags(f + k0 / COLS, k1 / COLS - k0 / COLS + 1, p.epoch);
      break;
    }
    case K_O: {
      const int gw = s.G * s.hd, lo = k0 / gw, hi = k1 / gw;
      w = wait_flags(f_layer(p.f_att, s, it.pass, l, s.nkv * s.B) + (size_t)lo * s.B,
                     (hi - lo + 1) * s.B, p.epoch);
      break;
    }
    case K_GU:
      w = wait_flags(f_layer(p.f_o, s, it.pass, l, s.td) + k0 / COLS, k1 / COLS - k0 / COLS + 1,
                     p.epoch);
      break;
    case K_DOWN:
      w = wait_flags(f_layer(p.f_gu, s, it.pass, l, s.tg) + k0 / 64, k1 / 64 - k0 / 64 + 1, p.epoch);
      break;
    default:
      w = wait_flags(p.f_fin + (size_t)it.pass * s.td + k0 / COLS, k1 / COLS - k0 / COLS + 1,
                     p.epoch);
      break;
  }
  waits_done(w, closed);
  mark(p.bb, tready, 0);
  bf16* X = reinterpret_cast<bf16*>(work);
  float* ct = reinterpret_cast<float*>(work + FD_X_BYTES);
  if (it.kind != K_HEAD) {
    const bf16* x = it.kind == K_QKV ? p.xa : it.kind == K_O ? p.xo : it.kind == K_GU ? p.xm : p.xd;
    run_mma<0, true, FD_X_BYTES>(p.bb, ring, q, it.idx, x, X, ct);
  } else if (s.head_kind == 0) {
    run_mma<2, true, FD_X_BYTES>(p.bb, ring, q, it.idx, p.xh, X, ct);
  } else if (s.head_kind == 1) {
    run_mma<0, true, FD_X_BYTES>(p.bb, ring, q, it.idx, p.xh, X, ct);
  } else {
    f32_sums(p, q, it.idx, reinterpret_cast<float*>(work), ct);
  }
  mark(p.bb, tready, 1);
  // The staging area is free now: the tile sums of squares, then h's tile.
  float* ssm = reinterpret_cast<float*>(work);
  float* ht = ssm + SS_MAX;
  const bool res = it.kind == K_O || it.kind == K_DOWN;
  const float* ss = it.kind == K_QKV ? p.ss_a : it.kind == K_GU ? p.ss_m : nullptr;
  if (!combine(p.bb, q, it.idx, ct, flag, ss, ssm, res ? p.bb.h : nullptr, ht)) return;
  mark(p.bb, tready, 2);
  fd_epilogue(p, it, cti, ct, rsv, ssm, ht, s0, s1, ht + B_MAX * CT_STRIDE);
  mark(p.bb, tready, 3);
  unsigned* done = it.kind == K_QKV  ? f_layer(p.f_qkv, s, it.pass, l, s.tq) + cti
                 : it.kind == K_O    ? f_layer(p.f_o, s, it.pass, l, s.td) + cti
                 : it.kind == K_GU   ? f_layer(p.f_gu, s, it.pass, l, s.tg) + cti
                 : it.kind == K_DOWN ? f_layer(p.f_dn, s, it.pass, l, s.td) + cti
                                     : p.f_head + (size_t)it.pass * s.th + cti;
  signal(done, p.epoch);
}

// ---------------------------------------------------------------------------
// Attention, the draw
// ---------------------------------------------------------------------------

// Attention of (kv head, stream b) at position pos over keys 0..pos: the
// group's RoPE'd bf16 q rows, the K/V rows (bf16), f32 scores and softmax,
// bf16 probabilities; the output, bf16-rounded, is o-proj's operand.
__device__ void fd_attention(const FdParams& p, const FdItem& it, uint8_t* work, int* closed,
                             unsigned long long* tready) {
  const FdShape& s = p.s;
  const int l = it.l, pos = it.pass, kvh = it.idx / s.B, b = it.idx % s.B;
  const int G = s.G, hd = s.hd, n = pos + 1;
  float* qf = reinterpret_cast<float*>(work);  // [G][hd]
  float* kf = qf + G * hd;                      // [n][hd]
  float* vf = kf + s.N * hd;                    // [n][hd]
  float* sc = vf + s.N * hd;                    // [G][N]
  const int q0 = kvh * G * hd, q1 = q0 + G * hd - 1;
  const int kcol = s.nqh + kvh * hd, vcol = s.nqh + (s.nkv + kvh) * hd;
  const unsigned* fq = f_layer(p.f_qkv, s, pos, l, s.tq);
  csync();  // the previous item's readers of the work area are done
  bool w = wait_flags(fq + q0 / COLS, q1 / COLS - q0 / COLS + 1, p.epoch);
  w |= wait_flags(fq + kcol / COLS, 1, p.epoch);
  w |= wait_flags(fq + vcol / COLS, 1, p.epoch);
  waits_done(w, closed);
  mark(p.bb, tready, 0);
  // The K / V rows 0..pos and the group's q rows, 8 bf16 a load, a thread's
  // loads in flight together.
  {
    constexpr int SB = 2;
    const size_t row0 = (((size_t)l * s.B + b) * s.nkv + kvh) * s.N * hd;
    const uint4* kg = reinterpret_cast<const uint4*>(p.kc + row0);
    const uint4* vg = reinterpret_cast<const uint4*>(p.vc + row0);
    const uint4* qg = reinterpret_cast<const uint4*>(p.qb + (size_t)b * s.nqh + q0);
    const int nkv8 = n * hd / 8, nq8 = G * hd / 8;
    auto put = [](float* dst, uint4 u) {
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dst[2 * k] = __uint_as_float(w[k] << 16);
        dst[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    };
    for (int i0 = threadIdx.x; i0 < nkv8 + nq8; i0 += SB * NT) {
      uint4 ku[SB], vu[SB];
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int i = i0 + u * NT;
        if (i < nkv8) {
          ku[u] = __ldcg(kg + i);
          vu[u] = __ldcg(vg + i);
        } else if (i < nkv8 + nq8) {
          ku[u] = __ldcg(qg + (i - nkv8));
        }
      }
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int i = i0 + u * NT;
        if (i < nkv8) {
          put(kf + 8 * i, ku[u]);
          put(vf + 8 * i, vu[u]);
        } else if (i < nkv8 + nq8) {
          put(qf + 8 * (i - nkv8), ku[u]);
        }
      }
    }
  }
  csync();
  mark(p.bb, tready, 1);
  // Scores: a warp per (head, key).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int wk = warp; wk < G * n; wk += NWARP) {
    const int g = wk / n, j = wk % n;
    float a = 0.f;
    for (int d = lane; d < hd; d += 32) a = fmaf(qf[g * hd + d], kf[j * hd + d], a);
    a = warp_sum(a);
    if (lane == 0) sc[g * s.N + j] = a * p.scale;
  }
  csync();
  // Softmax: a warp per head; bf16 probabilities.
  for (int g = warp; g < G; g += NWARP) {
    float* sg = sc + g * s.N;
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
  csync();
  mark(p.bb, tready, 2);
  // P.V: a thread per (head, dim).
  for (int i = threadIdx.x; i < G * hd; i += NT) {
    const int g = i / hd, d = i % hd;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(sc[g * s.N + j], vf[j * hd + d], acc);
    p.xo[(size_t)b * s.nqh + q0 + i] = __float2bfloat16_rn(acc);
  }
  mark(p.bb, tready, 3);
  signal(f_layer(p.f_att, s, pos, l, s.nkv * s.B) + it.idx, p.epoch);
}

__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// One draw from the logits of columns v = threadIdx.x + k NT, k < DRAW_VPT
// (lv, this thread's; NEG_INF past Va) with their noise gv: first-index
// argmax of the raw logits (greedy), else of top-k(lg) / max(temp, 1e-6) +
// gumbel, the top k kept with ties at the k-th value.  The k-th value is the
// k-th largest of the order keys' 16 high bits (exact on bf16-rounded
// logits), found by a radix select: two rounds of an 8-bit digit, each a
// 256-bin histogram in shared memory and a scan of it from the top by one
// warp.
__device__ __forceinline__ int draw(const float (&lv)[DRAW_VPT], const float (&gv)[DRAW_VPT], int Va, float temp,
                    int topk, bool greedy, int* hist, float* redf, int* redi) {
  unsigned kth = 0u;
  const float t = fmaxf(temp, 1e-6f);
  if (!greedy) {
    int need = topk;
    unsigned prefix = 0u;
    for (int round = 0; round < 2; ++round) {
      const int shift = round == 0 ? 24 : 16;
      for (int i = threadIdx.x; i < 256; i += NT) hist[i] = 0;
      csync();
#pragma unroll
      for (int k = 0; k < DRAW_VPT; ++k) {
        const unsigned key = order_key(lv[k]);
        if ((int)threadIdx.x + k * NT < Va && (round == 0 || (key >> 24) == prefix))
          atomicAdd(&hist[(key >> shift) & 0xff], 1);
      }
      csync();
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        int sl = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) sl += hist[8 * lane + i];
        int S = sl;  // keys in the bins of this lane and every lane above
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_down_sync(0xffffffffu, S, o);
          if (lane + o < 32) S += y;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, S >= need);
        if (lane == 31 - __clz(mask)) {
          int cum = S - sl;
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
      csync();
      prefix = (prefix << 8) | (unsigned)redi[0];
      need -= redi[1];
      csync();
    }
    kth = prefix << 16;
  }
  float best = -INFINITY;
  int bidx = 1 << 30;
#pragma unroll
  for (int k = 0; k < DRAW_VPT; ++k) {
    const int v = threadIdx.x + k * NT;
    if (v >= Va) break;
    float val = lv[k];
    if (!greedy) val = (order_key(val) >= kth ? val / t : NEG_INF) + gv[k];
    if (val > best) { best = val; bidx = v; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
    if (ov > best || (ov == best && oi < bidx)) { best = ov; bidx = oi; }
  }
  csync();
  if (threadIdx.x % 32 == 0) { redf[threadIdx.x / 32] = best; redi[threadIdx.x / 32] = bidx; }
  csync();
  best = redf[0];
  bidx = redi[0];
  for (int w = 1; w < NWARP; ++w)
    if (redf[w] > best || (redf[w] == best && redi[w] < bidx)) { best = redf[w]; bidx = redi[w]; }
  csync();
  return bidx;
}

// The draw of codebook i (the item's pass) for stream b: its noise into
// registers before the waits, then its logits (c0: the backbone's; else the
// head tiles'), recorded where asked, drawn, the forced token applied, the
// sample stored.
__device__ void fd_draw(const FdParams& p, const FdItem& it, uint8_t* work, int* closed,
                        unsigned long long* tready) {
  const FdShape& s = p.s;
  const int i = it.pass, b = it.idx;
  int* hist = reinterpret_cast<int*>(work);
  float* redf = reinterpret_cast<float*>(hist + 256);
  int* redi = reinterpret_cast<int*>(redf + NWARP);
  const float* gum = p.gumbel + ((size_t)i * s.B + b) * s.Va;
  float gv[DRAW_VPT], lv[DRAW_VPT];
#pragma unroll
  for (int k = 0; k < DRAW_VPT; ++k) {
    const int v = threadIdx.x + k * NT;
    gv[k] = v < s.Va ? __ldg(gum + v) : 0.f;
  }
  const float temp = __ldg(p.temp + b);
  const int topk = __ldg(p.topk + b), f = __ldg(p.forced + b * s.N + i);
  csync();
  waits_done(i > 0 && wait_flags(p.f_head + (size_t)i * s.th, s.th, p.epoch), closed);
  mark(p.bb, tready, 0);
#pragma unroll
  for (int k = 0; k < DRAW_VPT; ++k) {
    const int v = threadIdx.x + k * NT;
    lv[k] = v >= s.Va ? NEG_INF
          : i == 0    ? __ldg(p.c0lg + (size_t)b * s.Va + v)
                      : __ldcg(p.lg + (size_t)b * s.Va_pad + v);
  }
  if (p.out_logits != nullptr) {
#pragma unroll
    for (int k = 0; k < DRAW_VPT; ++k) {
      const int v = threadIdx.x + k * NT;
      if (v < s.Va_pad) p.out_logits[((size_t)i * s.B + b) * s.Va_pad + v] = lv[k];
    }
  }
  const int d = draw(lv, gv, s.Va, temp, topk, p.greedy != 0, hist, redf, redi);
  if (threadIdx.x == 0) {
    if (p.out_draws != nullptr) p.out_draws[b * s.N + i] = d;
    p.samples[b * s.N + i] = f >= 0 ? f : d;
  }
  signal(p.f_draw + (size_t)i * s.B + b, p.epoch);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ void block_sync_all() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(BLOCK) : "memory");
}

__global__ void __launch_bounds__(BLOCK, 1) fused_decoder_kernel(const FdParams p) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* work = smem_raw + (size_t)RING * CHUNK_BYTES;
  float* rsv = reinterpret_cast<float*>(work + p.work);
  int* flag = reinterpret_cast<int*>(rsv + B_MAX);
  int* closed = flag + 1;  // two words: items alternate
  unsigned* slot_waits = reinterpret_cast<unsigned*>(closed + 2);
  unsigned long long* tready = reinterpret_cast<unsigned long long*>(rsv + 64);
  uint64_t* full = reinterpret_cast<uint64_t*>(rsv + 128);
  uint64_t* empty = full + RING_MAX;
  Plan* plan = reinterpret_cast<Plan*>(reinterpret_cast<uint8_t*>(rsv) + SMALL_BYTES);
  const FdSched sc = fd_sched(p.s);
  const int L = p.s.L;
  const int n_mine = (sc.total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const bool trace = p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  const int n_stages = fd_stage_count(p.s.N, L);
  int stage = 0;
  if (trace) p.stamps[0] = globaltimer();
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) {
      hopper::mbar_init(full + i, PROD);
      hopper::mbar_init(empty + i, NWARP);
    }
    hopper::fence_barrier_init();
    closed[0] = closed[1] = 0;
  }
  fd_build_plan(p, sc, plan, n_mine);  // ends with a barrier of the whole block
  if (threadIdx.x >= NT) {
    const unsigned waits = produce<0, true>(p.bb, plan, n_mine, smem_raw, full, empty);
    if (threadIdx.x == NT) *slot_waits = waits;
    block_sync_all();
    return;
  }

  Ring ring{smem_raw, full, empty, RING, 0};
  unsigned n_closed = 0;
  for (int i = 0; i < n_mine; ++i) {
    const int g = blockIdx.x + i * gridDim.x;
    const FdItem it = fd_item_at(sc, L, g);
    const int st = fd_stage_of(it, L);
    if (trace) {
      const unsigned long long now = globaltimer();
      for (; stage < st; ++stage) p.stamps[stage + 1] = now;
    }
    unsigned long long t_begin = 0;
    if (p.bb.item_ns != nullptr && threadIdx.x == 0) {
      for (int k = 0; k < TRACE_MARKS; ++k) tready[k] = 0;
      tready[0] = t_begin = globaltimer();  // an item without waits ends them at once
    }
    int* cl = closed + (i & 1);
    switch (it.kind) {
      case K_DRAW: fd_draw(p, it, work, cl, tready); break;
      case K_INIT: fd_init(p, it, work, cl, tready); break;
      case K_FINAL: fd_final(p, it, work, rsv, cl, tready); break;
      case K_ATT: fd_attention(p, it, work, cl, tready); break;
      default: fd_product(p, ring, it, work, rsv, flag, cl, tready); break;
    }
    if (threadIdx.x == 0) {
      // Every thread's mark is in: the item synchronised the block past its waits.
      if (*cl) {
        ++n_closed;
        *cl = 0;
      }
      if (p.bb.item_ns != nullptr) {
        unsigned long long* o = p.bb.item_ns + (size_t)TRACE_SLOTS * g;
        o[0] = st;
        o[1] = t_begin;
        for (int k = 0; k < TRACE_MARKS; ++k) o[k + 2] = tready[k];
        o[TRACE_SLOTS - 1] = globaltimer();
      }
    }
  }
  if (trace) {
    const unsigned long long now = globaltimer();
    for (; stage < n_stages; ++stage) p.stamps[stage + 1] = now;
  }
  block_sync_all();  // the producer's count is in
  if (threadIdx.x == 0) {
    // This launch's sums in sync[0, 4); the last block to finish moves them to
    // sync[4, 8) and re-arms them and its ticket (sync[8]).  Word 0 counts
    // grid barriers: the kernel has none.
    unsigned* sy = p.sync;
    atomicAdd(sy + 1, (unsigned)n_mine);
    atomicAdd(sy + 2, n_closed);
    atomicAdd(sy + 3, *slot_waits);
    __threadfence();
    if (add_acq_rel(sy + 8, 1u) == gridDim.x - 1) {
      for (int k = 0; k < SYNC_OUT; ++k) sy[SYNC_OUT + k] = atomicExch(sy + k, 0u);
      atomicExch(sy + 8, 0u);
    }
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// Whether the kernel takes these shapes: B <= 32 (four 8-row blocks an
// operand), N <= NP_MAX positions, GQA groups of at most 8, heads that tile
// 128 columns, whole 128-column tiles (64-column gate-up pairs), whole
// weight chunks in every split, and a work area that holds attention, the
// draw and the f32 head's staged rows.
bool fd_shapes_ok(const FdShape& s) {
  if (s.B < 1 || s.B > B_MAX || s.N < 2 || s.N > NP_MAX || s.L < 1 || s.nkv <= 0 ||
      s.nq % s.nkv != 0 || s.G > G_MAX || s.hd < 16 || s.hd > HD_MAX || COLS % s.hd != 0 ||
      s.head_kind < 0 || s.head_kind >= HEAD_KINDS || s.Va < 1 || s.Va > s.Va_pad ||
      s.Va_pad > DRAW_VPT * NT)
    return false;
  if (s.D % COLS != 0 || s.Va_pad % COLS != 0 || s.QKVN % COLS != 0 || s.F % COLS != 0 ||
      s.nqh % CHUNK_ROWS != 0 || s.D % CHUNK_ROWS != 0 || s.B * s.td > SS_MAX)
    return false;
  return s.head_kind != 2 || s.B * (s.D / s.ksh) * 4 <= FD_X_BYTES;
}

// Shared memory of a block: the ring, the work area, the small arrays, the
// plan of its items.
size_t fd_smem(const FdShape& s, int grid) {
  const int per_block = (fd_sched(s).total + grid - 1) / grid;
  return (size_t)RING * CHUNK_BYTES + fd_work_bytes(s) + SMALL_BYTES + per_block * sizeof(Plan);
}

}  // namespace

extern "C" {

// Bytes of scratch a frame takes at these shapes (Layout; zeroed once when
// allocated).
long long fd_scratch_bytes(int B, int N, int D, int L, int nq, int nkv, int hd, int F, int Va,
                           int Va_pad, int head_kind) {
  const FdShape s = fd_shape(B, N, L, D, F, nq, nkv, hd, Va, Va_pad, head_kind);
  if (!fd_shapes_ok(s)) return -(long long)REFUSED_SHAPES;
  return fd_layout(s).total;
}

// Work items of a frame at these shapes (an item trace takes TRACE_SLOTS,
// 8, int64 per item).
long long fd_item_count(int B, int N, int D, int L, int nq, int nkv, int hd, int F, int Va,
                        int Va_pad, int head_kind) {
  const FdShape s = fd_shape(B, N, L, D, F, nq, nkv, hd, Va, Va_pad, head_kind);
  if (!fd_shapes_ok(s)) return -(long long)REFUSED_SHAPES;
  return fd_sched(s).total;
}

// One frame.  Every pointer on the current device, contiguous.  f32: temp
// [B], x0 [B,D], c0lg [B,Va] (bf16-rounded), scales sqkv [L,QKVN], so [L,D],
// sgu [L,2F], sdown [L,D], cos / sin [>= N, hd], head_scale [N-1,Va_pad]
// (int8 head), gumbel [N,B,Va], out_logits [N,B,Va_pad] or null; int32:
// topk [B], forced [B,N], samples [B,N], out_draws [B,N] or null; int8 wqkv
// [L,D,QKVN], wo [L,nq hd,D], wgu [L,D,2F], wdown [L,F,D]; head [N-1,D,Va_pad]
// bf16, int8 or f32 (head_kind 0, 1, 2); emb [N Va, D] bf16 or f32.
// scratch: fd_scratch_bytes bytes, zeroed when allocated, kept across calls
// with ``epoch`` one more each launch (modulo 2^32); after a launch its int32
// words 4..7 hold the launch's grid barriers (0), items, items whose waits
// found a flag closed, and the producer's waits for a free ring slot (block
// 0's warpgroup counts for each block).  stamps: null or fd_stage_count + 1
// int64 (block 0's clock in ns at its start and as it leaves each stage of
// the list); item_ns: null or item_ns_len int64, at least TRACE_SLOTS (8)
// per work item (fd_item_count).  One cooperative launch on stream.  Returns
// 0, a cudaError_t, or a code of arguments the kernel refuses.
int fused_decode(const void* temp, const void* topk, const void* forced, const void* x0,
                 const void* c0lg, const void* wqkv, const void* wo, const void* wgu,
                 const void* wdown, const void* sqkv, const void* so, const void* sgu,
                 const void* sdown, const void* cosb, const void* sinb, const void* head,
                 const void* head_scale, const void* gumbel, const void* emb, void* samples,
                 void* out_logits, void* out_draws, void* scratch, void* stamps, void* item_ns,
                 long long scratch_bytes, long long item_ns_len, int B, int N, int Va, int Va_pad,
                 int D, int L, int nq, int nkv, int hd, int F, int greedy, int head_kind,
                 int emb_bf16, int epoch, float eps, void* stream) {
  const FdShape s = fd_shape(B, N, L, D, F, nq, nkv, hd, Va, Va_pad, head_kind);
  if (!fd_shapes_ok(s)) return REFUSED_SHAPES;
  const FdLayout lay = fd_layout(s);
  if (lay.total > scratch_bytes) return REFUSED_BUFFER;
  if (item_ns != nullptr && item_ns_len < (long long)TRACE_SLOTS * fd_sched(s).total)
    return REFUSED_BUFFER;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = fd_smem(s, sms);
  if (smem > (size_t)SMEM_MAX) return REFUSED_SMEM;
  FdParams p{};
  p.bb.s.B = B;
  p.bb.s.D = D;
  p.bb.s.td = s.td;
  p.bb.ring = RING;
  p.bb.eps = eps;
  p.bb.item_ns = static_cast<unsigned long long*>(item_ns);
  p.s = s;
  p.epoch = (unsigned)epoch;
  p.work = fd_work_bytes(s);
  p.greedy = greedy;
  p.emb_bf16 = emb_bf16;
  p.scale = (float)(1.0 / sqrt((double)hd));
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
  uint8_t* sb = static_cast<uint8_t*>(scratch);
  auto f32 = [&](long long off) { return reinterpret_cast<float*>(sb + off); };
  auto b16 = [&](long long off) { return reinterpret_cast<bf16*>(sb + off); };
  auto u32 = [&](long long off) { return reinterpret_cast<unsigned*>(sb + off); };
  p.sync = u32(lay.sync);
  p.bb.h = f32(lay.h);
  p.ss_a = f32(lay.ss_a); p.ss_m = f32(lay.ss_m); p.xhf = f32(lay.xhf); p.lg = f32(lay.lg);
  p.xa = b16(lay.xa); p.xm = b16(lay.xm); p.xo = b16(lay.xo); p.xd = b16(lay.xd);
  p.qb = b16(lay.qb); p.xh = b16(lay.xh); p.kc = b16(lay.kc); p.vc = b16(lay.vc);
  p.p_qkv = f32(lay.p_qkv); p.p_o = f32(lay.p_o); p.p_gu = f32(lay.p_gu);
  p.p_down = f32(lay.p_down); p.p_head = f32(lay.p_head);
  p.f_draw = u32(lay.f_draw); p.f_init = u32(lay.f_init); p.f_qkv = u32(lay.f_qkv);
  p.f_att = u32(lay.f_att); p.f_o = u32(lay.f_o); p.f_gu = u32(lay.f_gu); p.f_dn = u32(lay.f_dn);
  p.f_fin = u32(lay.f_fin); p.f_head = u32(lay.f_head);
  p.t_qkv = u32(lay.t_qkv); p.t_o = u32(lay.t_o); p.t_gu = u32(lay.t_gu);
  p.t_dn = u32(lay.t_dn); p.t_head = u32(lay.t_head);
  p.stamps = static_cast<unsigned long long*>(stamps);
  int per_sm = 0;
  e = cudaFuncSetAttribute(fused_decoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_decoder_kernel, BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)fused_decoder_kernel, dim3(sms), dim3(BLOCK), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* fd_error_string(int code) { return refused_string(code); }

}  // extern "C"
