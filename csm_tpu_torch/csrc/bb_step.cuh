// One backbone decode step as one persistent cooperative launch: the
// machinery shared by the exact bf16 tier (bb_decode.cu, bb_step_kernel) and
// the int8 / int4 tiers (bb_decode_q.cu, bbq_step_kernel<false|true>).  Each
// source supplies its tier's epilogues and row items (a Tier struct for
// run_step) and the exact tier its compensated bf16 product; the rest is
// here.  The fused codebook loop (fused_decoder.cu) walks its own item list
// on the same pieces: the weight ring and its producer, flags, tickets and
// the int8 / bf16 products.  What the TPU kernel did for its
// hardware (VMEM weight rings, permuted rotary columns, one-hot head
// split/merge matmuls) is not carried over; its idea is: one program for the
// whole step, a static chunk schedule, and the next weights always in
// flight.  Here:
//
// - One cooperative launch, one block per SM, all resident.  Every block
//   walks one static list of work items, fixed by the shapes: per layer the
//   QKV product's items, attention per (kv head, stream), o-proj, gate-up,
//   down; before the layers an init item per 128 residual columns, after
//   them the head's items and the final norm's.  Item i falls to block i mod
//   grid and blocks take their items in list order, so an item only ever
//   waits on items earlier in the list, each on a block already past it or
//   at it: with every block resident that cannot deadlock.
// - No grid barrier.  An item waits only on the items whose outputs it
//   reads, through per-item flags in device memory stamped with the launch's
//   epoch (so they need no reset between launches): a QKV split on the down
//   tiles of its K range (bf16 tier: on every down tile, as its RMSNorm
//   needs the whole row), attention on the QKV tiles of its heads, an o-proj
//   split on the attention items of its heads, gate-up on the o-proj tiles of
//   its K range (bf16: every one), down on the gate-up tiles of its K range.
// - A product item is 128 output columns by one K split.  The K splits are
//   fixed by the shape (pick_ks), never by B or the grid, so a row's sums run
//   in the same order solo and batched.  Each split writes its f32 partial
//   tile, then takes a ticket on the tile; the last to arrive sums the
//   partials in split order and applies the tile's epilogue once (the
//   tier's).  Gate-up tiles pair 64 gate columns with their 64 up columns.
//   The residual's epilogues also write each tile's per-row sum of squares:
//   RMSNorm's scale of a row is the fixed-order sum of its D/128 tile sums.
//   The ticket word re-arms itself.
// - The weight stream never waits on data.  A block is 8 consumer warps
//   (waits, products, epilogues, attention) and a producer warpgroup that
//   copies the block's weight chunks (16 KB: 128 columns by 128 int8 rows,
//   256 int4 rows or 64 bf16 rows), in the order its items consume them
//   across stages and layers, into a ring of shared-memory slots by
//   cp.async, each slot's arrival and release tracked by an mbarrier pair.
//   It waits only for a free slot, so the HBM stream runs on through
//   attention and every epilogue, and the consumers' release fences never
//   wait on weight copies in flight.  Each chunk row's 16-byte pieces are
//   stored XOR-swizzled by the row, so ldmatrix reads them without bank
//   conflicts.  The ring is as deep as shared memory allows (rings of 4 to 9
//   chunks measured alike).
// - Products on the tensor cores: mma.sync m16n8k16 bf16 with f32
//   accumulation, the weights as the 16-row operand (128 columns: 16 a warp),
//   up to 8 streams as each 8-column operand.
// - Attention per (kv head, stream) on a whole block: the window's usable
//   keys compacted in order, their K/V rows staged in shared memory (the
//   first chunk before the wait on QKV), scores and P.V by mma.sync (bf16
//   q, K, V and probabilities, f32 sums), softmax a warp per head in f32.
// - Code size: the kernel's phases run one after another on each SM, so
//   straight-line code is fetched cold each time; row loops stay rolled.
// - Traces: with a stamps buffer, block 0 records its clock at its start
//   and as it leaves each stage; with an item buffer, every item's stage,
//   start, end of waits, inner marks and end.
// - A lost arrival (a flag or a ring slot never reached) traps after ~2^35
//   cycles (~17 s) instead of hanging the card.
//
// Data another block wrote is read through L2 (__ldcg).  The scratch (laid
// out by Layout: residual, operands, partials, flags, tickets) is the
// caller's and is kept across calls: flags and tickets are zeroed once when
// it is allocated, and every launch passes the next epoch.

#pragma once

#include "hopper.cuh"
#include "sync.cuh"
#include "w8a16.cuh"

namespace {

using namespace w8a16;
using namespace sync_ptx;

constexpr int COLS = 128;              // output columns of a work item
constexpr int CHUNK_BYTES = 16384;     // one weight chunk: 128 columns of 128 byte rows
constexpr int CHUNK_ROWS = 128;        // (bf16: 64 K rows of 256 bytes)
constexpr int RING_MAX = 16;           // chunks a ring may hold
constexpr int X_BYTES = 65536;         // staged bf16 operand rows of a product
constexpr int CT_STRIDE = COLS + 4;    // f32 tile of a product's sums, row stride
constexpr int CT_BYTES = 32 * CT_STRIDE * 4;  // B_MAX rows
constexpr int HD_MAX = 128;
constexpr int G_MAX = 8;
constexpr int B_MAX = 32;
constexpr int SMALL_BYTES = 1024;
constexpr int SMEM_MAX = 232448;       // usable shared memory of an H100 block
constexpr int KS_MAX = 8;              // K splits of a product
constexpr int PROD = 128;              // producer threads: a warpgroup (one warp measured slower)
// The item trace, per work item: its stage (numbered as the stamps: 0
// init, 1 + 5 l + 0..4 for QKV, attention, o-proj, gate-up, down of layer
// l, 5 L + 1 head, 5 L + 2 final), start, end of its waits, four marks
// inside it (products: operand staged and sums done, partials combined,
// epilogue done; attention: q loaded, scores, softmax and P.V, output
// written), end.  Marks an item does not reach stay 0.
constexpr int TRACE_SLOTS = 8;
constexpr int TRACE_MARKS = 5;         // end of waits and the four marks

// Codes past cudaError_t's for arguments the kernel refuses
// (refused_string names them).
enum Refused : int {
  REFUSED_SHAPES = 10001,  // shapes_ok
  REFUSED_WINDOW,          // attention's window leaves no room for a ring
  REFUSED_BUFFER,          // a scratch or item trace smaller than the step's
  REFUSED_SMEM,            // the fused codebook loop's shared memory past the block's
};
constexpr int SS_MAX = 4 * NT;         // tile sums of squares an epilogue reads (B D / 128)

enum Kind { K_INIT, K_QKV, K_ATT, K_O, K_GU, K_DOWN, K_HEAD, K_FINAL };

// ---------------------------------------------------------------------------
// Shapes: K splits, schedule, scratch layout (host and device agree)
// ---------------------------------------------------------------------------

// K splits of a product with ``tiles`` column tiles and ``kr`` K rows per
// chunk: doubled while the items stay at most 128 (one round on the H100's
// 132 SMs) and whole chunks still divide each split, at most 8.  Shapes
// only.
__host__ __device__ inline int pick_ks(int K, int tiles, int kr) {
  int ks = 1;
  while (ks < KS_MAX && tiles * ks * 2 <= 128 && K % (2 * ks * kr) == 0) ks *= 2;
  return ks;
}

struct Shape {
  int B, L, D, F, nq, nkv, hd, n_head, int4;
  int QKVN, nqh, G;
  int tq, td, tg, th;             // column tiles: QKV, D (o-proj, down), gate-up pairs, head
  int ksq, kso, ksg, ksd, ksh;    // K splits
  int exact;                      // the bf16 tier
};

__host__ __device__ inline Shape shape_of(int B, int L, int D, int F, int nq, int nkv, int hd,
                                          int n_head, int int4, int exact) {
  Shape s;
  s.B = B; s.L = L; s.D = D; s.F = F; s.nq = nq; s.nkv = nkv; s.hd = hd; s.n_head = n_head;
  s.int4 = int4;
  s.exact = exact;
  s.QKVN = (nq + 2 * nkv) * hd;
  s.nqh = nq * hd;
  s.G = nq / nkv;
  s.tq = s.QKVN / COLS;
  s.td = D / COLS;
  s.tg = F / (COLS / 2);
  s.th = n_head / COLS;
  // K rows of a chunk: int8 128, int4 256 (two a byte), bf16 64.
  const int kr = exact ? CHUNK_ROWS / 2 : int4 ? 2 * CHUNK_ROWS : CHUNK_ROWS;
  s.ksq = pick_ks(D, s.tq, kr);
  s.kso = pick_ks(s.nqh, s.td, kr);
  s.ksg = pick_ks(D, s.tg, kr);
  s.ksd = pick_ks(F, s.td, kr);
  s.ksh = pick_ks(D, s.th, exact ? CHUNK_ROWS / 2 : CHUNK_ROWS);
  return s;
}

struct Layout {
  long long h, ss_a, ss_m, xa, xm, xo, xd, qb, p_qkv, p_o, p_gu, p_down, p_head;
  long long f_qkv, f_att, f_o, f_gu, f_dn, t_qkv, t_o, t_gu, t_dn, t_head, total;
};

// Byte offsets into the scratch, each 128-aligned.
__host__ __device__ inline Layout layout_of(const Shape& s) {
  Layout o;
  long long at = 0;
  auto take = [&](long long bytes) { const long long x = at; at += (bytes + 127) / 128 * 128; return x; };
  const long long B = s.B;
  o.h = take(B * s.D * 4);
  o.ss_a = take(B * s.td * 8);  // f32 tile sums of squares (f64 for the bf16 tier)
  o.ss_m = take(B * s.td * 8);
  o.xa = take(B * s.D * 2);
  o.xm = take(B * s.D * 2);
  o.xo = take(B * s.nqh * 2);
  o.xd = take(B * s.F * 2);
  o.qb = take(B * s.nqh * 2);
  o.p_qkv = take((long long)s.ksq * s.tq * B * COLS * 4);
  o.p_o = take((long long)s.kso * s.td * B * COLS * 4);
  o.p_gu = take((long long)s.ksg * s.tg * B * COLS * 4);
  o.p_down = take((long long)s.ksd * s.td * B * COLS * 4);
  o.p_head = take((long long)s.ksh * s.th * B * COLS * 4);
  o.f_qkv = take((long long)s.L * s.tq * 4);
  o.f_att = take((long long)s.L * s.nkv * B * 4);
  o.f_o = take((long long)s.L * s.td * 4);
  o.f_gu = take((long long)s.L * s.tg * 4);
  o.f_dn = take((long long)(s.L + 1) * s.td * 4);
  o.t_qkv = take(s.tq * 4);
  o.t_o = take(s.td * 4);
  o.t_gu = take(s.tg * 4);
  o.t_dn = take(s.td * 4);
  o.t_head = take(s.th * 4);
  o.total = at;
  return o;
}

// Keys of an attention chunk: 16 KB of K rows.
__host__ __device__ inline int kch_of(int hd) { return hd > 64 ? 128 : 256; }

// Shared memory of attention at window W: scores [G][W+1], the compacted key
// list, q, and one chunk of K and V rows (16-byte padded).
__host__ __device__ inline int att_bytes(int W, int G, int hd) {
  const int wp = (W + 1 + 3) / 4 * 4;
  return G * wp * 4 + wp * 4 + 8 * (hd + 8) * 2 + 2 * kch_of(hd) * (hd + 8) * 2 + NWARP * 512;
}

__host__ __device__ inline int work_bytes(int W, int G, int hd) {
  const int prod = X_BYTES + CT_BYTES;
  const int att = att_bytes(W, G, hd);
  return prod > att ? prod : att;
}

struct Params {
  Shape s;
  int W, ring;
  unsigned epoch;
  float eps, scale;
  const float *h0, *cosb, *sinb, *bias;
  const bf16 *kc, *vc;
  const int8_t *wqkv, *wo, *wgu, *wdown, *head;  // the weights' bytes (int8, int4 or bf16)
  const float *sqkv, *so, *sgu, *sdown, *shead;  // int8 / int4 scales (null for bf16)
  const float *uqkv, *uo, *ugu, *udown;  // int4 prescales (null otherwise)
  const float* fnw;
  float *nh, *logits;
  bf16 *new_k, *new_v;
  float *h, *ss_a, *ss_m, *p_qkv, *p_o, *p_gu, *p_down, *p_head;
  bf16 *xa, *xm, *xo, *xd, *qb;
  unsigned *f_qkv, *f_att, *f_o, *f_gu, *f_dn, *t_qkv, *t_o, *t_gu, *t_dn, *t_head;
  unsigned long long* stamps;   // [5 L + 4] or null
  unsigned long long* item_ns;  // [TRACE_SLOTS x items] or null: the item trace
  const float *attn_nw, *mlp_nw;  // bf16 tier's norm weights [L, D] (null otherwise)
};

// The schedule: item counts per stage and the global index of each.
struct Sched {
  int n_init, n_qkv, n_att, n_o, n_gu, n_down, per_layer, n_head, n_final, total;
};

__host__ __device__ inline Sched sched_of(const Shape& s) {
  Sched c;
  c.n_init = s.td;
  c.n_qkv = s.tq * s.ksq;
  c.n_att = s.nkv * s.B;
  c.n_o = s.td * s.kso;
  c.n_gu = s.tg * s.ksg;
  c.n_down = s.td * s.ksd;
  c.per_layer = c.n_qkv + c.n_att + c.n_o + c.n_gu + c.n_down;
  c.n_head = s.th * s.ksh;
  c.n_final = s.td;
  c.total = c.n_init + s.L * c.per_layer + c.n_head + c.n_final;
  return c;
}

struct Item {
  int kind, l, idx;
};

__device__ __forceinline__ Item item_at(const Sched& c, int L, int g) {
  if (g < c.n_init) return Item{K_INIT, 0, g};
  g -= c.n_init;
  if (g < L * c.per_layer) {
    const int l = g / c.per_layer;
    int i = g - l * c.per_layer;
    if (i < c.n_qkv) return Item{K_QKV, l, i};
    i -= c.n_qkv;
    if (i < c.n_att) return Item{K_ATT, l, i};
    i -= c.n_att;
    if (i < c.n_o) return Item{K_O, l, i};
    i -= c.n_o;
    if (i < c.n_gu) return Item{K_GU, l, i};
    return Item{K_DOWN, l, i - c.n_gu};
  }
  g -= L * c.per_layer;
  if (g < c.n_head) return Item{K_HEAD, L, g};
  return Item{K_FINAL, L, g - c.n_head};
}

// Stage of an item in the trace: init, 5 per layer, head, final.
__device__ __forceinline__ int stage_of(const Item& it) {
  if (it.kind == K_INIT) return 0;
  if (it.kind == K_HEAD || it.kind == K_FINAL) return 1 + 5 * it.l + (it.kind == K_FINAL);
  return 1 + 5 * it.l + (it.kind - K_QKV);
}

// A product of the step: weights, shape, splits, partials, flags.
struct Prod {
  const int8_t* W;  // [K / P, N] weights of this layer (EB bytes each)
  int K, N, KS, kc, nch, tiles, P, pair;  // P: K rows per weight row; pair: gate-up tiles
  float* part;
  unsigned* ticket;
};

// EXACT: the bf16 tier (EB = 2 bytes a weight, P = 1); else int8 or int4.
template <bool EXACT>
__device__ __forceinline__ Prod prod_of(const Params& p, int kind, int l) {
  constexpr int EB = EXACT ? 2 : 1;
  const Shape& s = p.s;
  Prod q;
  q.P = !EXACT && s.int4 ? 2 : 1;
  q.pair = 0;
  switch (kind) {
    case K_QKV:
      q.K = s.D; q.N = s.QKVN; q.KS = s.ksq; q.tiles = s.tq; q.part = p.p_qkv; q.ticket = p.t_qkv;
      q.W = p.wqkv + (size_t)l * (s.D / q.P) * s.QKVN * EB;
      break;
    case K_O:
      q.K = s.nqh; q.N = s.D; q.KS = s.kso; q.tiles = s.td; q.part = p.p_o; q.ticket = p.t_o;
      q.W = p.wo + (size_t)l * (s.nqh / q.P) * s.D * EB;
      break;
    case K_GU:
      q.K = s.D; q.N = 2 * s.F; q.KS = s.ksg; q.tiles = s.tg; q.part = p.p_gu; q.ticket = p.t_gu;
      q.W = p.wgu + (size_t)l * (s.D / q.P) * 2 * s.F * EB;
      q.pair = 1;
      break;
    case K_DOWN:
      q.K = s.F; q.N = s.D; q.KS = s.ksd; q.tiles = s.td; q.part = p.p_down; q.ticket = p.t_dn;
      q.W = p.wdown + (size_t)l * (s.F / q.P) * s.D * EB;
      break;
    default:  // the head: int8 in both quantized tiers
      q.P = 1;
      q.K = s.D; q.N = s.n_head; q.KS = s.ksh; q.tiles = s.th; q.part = p.p_head;
      q.ticket = p.t_head;
      q.W = p.head;
      break;
  }
  q.kc = q.K / q.KS;
  q.nch = q.kc / (CHUNK_ROWS / EB * q.P);
  return q;
}

__device__ __forceinline__ bool is_prod(int kind) {
  return kind == K_QKV || kind == K_O || kind == K_GU || kind == K_DOWN || kind == K_HEAD;
}

// ---------------------------------------------------------------------------
// The weight ring
// ---------------------------------------------------------------------------

// The block's plan: for each of its items, in order, where its weight
// chunks start (row 0 of its K split, its first column), the row stride in
// bytes, the chunk count (0: not a product), the byte offset of the second
// half of each row past its first (gate-up tiles: the up columns) and, for a
// producer that takes each entry's width (produce<0>), the 16-byte pieces of
// a chunk row (8 or 16).  Built once a launch, so issuing a chunk is a few
// loads from shared memory.
struct Plan {
  const int8_t* base;
  int N, nch, coff, pieces;
};

template <bool EXACT>
__device__ void build_plan(const Params& p, const Sched& sc, Plan* plan, int n_mine) {
  constexpr int EB = EXACT ? 2 : 1;
  for (int i = threadIdx.x; i < n_mine; i += blockDim.x) {
    const Item it = item_at(sc, p.s.L, blockIdx.x + i * gridDim.x);
    Plan e{nullptr, 0, 0, 0, 0};
    if (is_prod(it.kind)) {
      const Prod q = prod_of<EXACT>(p, it.kind, it.l);
      const int ct = it.idx % q.tiles, ks = it.idx / q.tiles;
      e.base = q.W + (size_t)ks * (q.kc / q.P) * q.N * EB + (q.pair ? ct * 64 : ct * COLS) * EB;
      e.N = q.N * EB;
      e.nch = q.nch;
      e.coff = q.pair ? (p.s.F - 64) * EB : 0;
    }
    plan[i] = e;
  }
  __syncthreads();
}

// A cursor over the block's chunks: item (block-local index) and chunk.
struct Cursor {
  int e, ch;
};

__device__ __forceinline__ void settle(const Plan* plan, int n_mine, Cursor& c) {
  while (c.e < n_mine && c.ch >= plan[c.e].nch) {
    ++c.e;
    c.ch = 0;
  }
}

__device__ __forceinline__ void advance(const Plan* plan, int n_mine, Cursor& c) {
  ++c.ch;
  settle(plan, n_mine, c);
}

// Row ``row`` and 16-byte piece of a chunk whose rows are PIECES pieces
// (8: int8 / int4, 128 rows; 16: bf16, 64 rows).
template <int PIECES>
__device__ __forceinline__ const int8_t* chunk_src(const Plan& e, int ch, int row, int piece) {
  constexpr int ROWS = CHUNK_BYTES / (16 * PIECES);
  return e.base + (size_t)(ch * ROWS + row) * e.N + piece * 16 + (piece >= PIECES / 2 ? e.coff : 0);
}

__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One chunk of plan entry e into ring slot dst: this producer lane's share
// of its 16-byte pieces.
template <int PIECES>
__device__ __forceinline__ void copy_chunk(const Plan& e, int ch, int lane, uint8_t* dst) {
#pragma unroll 8
  for (int u = 0; u < CHUNK_BYTES / 16 / PROD; ++u) {
    const int i = lane + PROD * u, row = i >> (PIECES == 16 ? 4 : 3), piece = i & (PIECES - 1);
    cp_async16(dst + row * 16 * PIECES + ((piece ^ (row & 7)) * 16),
               chunk_src<PIECES>(e, ch, row, piece));
  }
}

// The producer warpgroup: every chunk of the block's plan, in order, into
// ring slot c % depth by cp.async, each lane's copies arriving on the slot's
// full barrier as they land.  A slot is refilled once the consumer warps
// have released it (its empty barrier).  The stream waits on nothing else:
// not on flags, not on the consumers' epilogues.  Each row's 16-byte pieces
// (PIECES of them; 0: each plan entry's own count) are stored at piece ^
// (row % 8), so the 8 rows an ldmatrix phase reads fall in distinct banks.
// With COUNT, returns how many slots were not yet free when first polled.
template <int PIECES, bool COUNT = false>
__device__ unsigned produce(const Params& p, const Plan* plan, int n_mine, uint8_t* buf,
                            uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x - NT;  // 0 .. PROD - 1
  unsigned waits = 0;
  Cursor c{0, 0};
  settle(plan, n_mine, c);
  for (int k = 0; c.e < n_mine; ++k) {
    const int slot = k % p.ring;
    if (k >= p.ring) {  // polled with pauses: the consumer warps share the SM
      const uint32_t bar = smem_u32(empty + slot), parity = ((k / p.ring) - 1) & 1;
      const long long t0 = clock64();
      bool first = true;
      while (!hopper::mbar_try_wait(bar, parity)) {
        if constexpr (COUNT) waits += first ? 1u : 0u;
        first = false;
        __nanosleep(64);
        if (clock64() - t0 > (1ll << 35)) __trap();
      }
    }
    const Plan& e = plan[c.e];
    uint8_t* dst = buf + (size_t)slot * CHUNK_BYTES;
    if constexpr (PIECES == 0) {
      if (e.pieces == 16) copy_chunk<16>(e, c.ch, lane, dst);
      else copy_chunk<8>(e, c.ch, lane, dst);
    } else {
      copy_chunk<PIECES>(e, c.ch, lane, dst);
    }
    cp_async_arrive_noinc(full + slot);
    advance(plan, n_mine, c);
  }
  return waits;
}

// The consumers' view of the ring: chunks in plan order.
struct Ring {
  const uint8_t* buf;
  uint64_t *full, *empty;
  int depth, consumed;
};

// The oldest chunk not yet consumed, once it has landed.
__device__ __forceinline__ const uint8_t* front(const Ring& r) {
  const int slot = r.consumed % r.depth;
  hopper::mbar_wait(r.full + slot, (r.consumed / r.depth) & 1);
  return r.buf + (size_t)slot * CHUNK_BYTES;
}

// This warp is done reading the front chunk (each consumer warp releases it).
__device__ __forceinline__ void pop(Ring& r) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(r.empty + r.consumed % r.depth);
  ++r.consumed;
}

// The consumer warps' barrier (the producer warp never joins it).
__device__ __forceinline__ void csync() { asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory"); }

// ---------------------------------------------------------------------------
// Waits and signals
// ---------------------------------------------------------------------------

// Waits until flags [f, f + n) reach the epoch (a thread per flag; the
// caller synchronises the block after its waits).  Returns whether this
// thread found one of its flags still closed.
__device__ bool wait_flags(const unsigned* f, int n, unsigned epoch) {
  bool closed = false;
  for (int i = threadIdx.x; i < n; i += NT) {
    if (!reached(ld_acquire(f + i), epoch)) {
      closed = true;
      const long long t0 = clock64();
      do {
        __nanosleep(32);
        if (clock64() - t0 > (1ll << 35)) __trap();
      } while (!reached(ld_acquire(f + i), epoch));
    }
  }
  return closed;
}

// The item trace: the time its waits were over (thread 0, after the block
// synchronised past them).
__device__ __forceinline__ void mark(const Params& p, unsigned long long* t, int k) {
  if (p.item_ns != nullptr && threadIdx.x == 0) t[k] = globaltimer();
}

__device__ __forceinline__ void signal(unsigned* f, unsigned epoch) {
  csync();
  if (threadIdx.x == 0) {
    __threadfence();  // cumulative: the block's writes, seen through the barrier
    st_release(f, epoch);
  }
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

// Four 8x8 b16 matrices (ldmatrix): lanes 8i..8i+7 give the rows of matrix
// i; thread (g, t) receives elements (g, 2t), (g, 2t+1), or with .trans
// (2t, g), (2t+1, g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Rows [0, R) x K indices [k0, k0 + n) of the bf16 operand x [B, K] into X
// (row stride XS), rows R..rows - 1 zeroed.  16-byte loads, 8 in flight a
// thread.  PERM (the int4 products) stores each group of 4 K values in the
// order 0, 2, 1, 3, the order of their mma k slots.
template <bool PERM>
__device__ void stage_x(const bf16* x, int K, int R, int rows, int k0, int n, int XS, bf16* X) {
  constexpr int SB = 8;
  const int per = n / 8, total = rows * per;
  csync();  // the previous readers of X are done
  for (int i0 = threadIdx.x; i0 < total; i0 += SB * NT) {
    uint4 v[SB];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * NT, r = i / per, c = i % per;
      v[u] = (i < total && r < R) ? __ldcg(reinterpret_cast<const uint4*>(x + (size_t)r * K + k0) + c)
                                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * NT;
      if (i >= total) break;
      uint4 w = v[u];
      if constexpr (PERM) {
        w = make_uint4(__byte_perm(v[u].x, v[u].y, 0x5410), __byte_perm(v[u].x, v[u].y, 0x7632),
                       __byte_perm(v[u].z, v[u].w, 0x5410), __byte_perm(v[u].z, v[u].w, 0x7632));
      }
      *reinterpret_cast<uint4*>(X + (i / per) * XS + (i % per) * 8) = w;
    }
  }
  csync();
}

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The signed bytes 0 and 2 of r as bf16x2, exactly: with l the low 7 bits,
// (128 + l) + (v < 0 ? -256 : -128), both terms bf16 bit patterns.
__device__ __forceinline__ uint32_t i8x2(uint32_t r) {
  return bf2_add((r & 0x007F007Fu) | 0x43004300u, (r & 0x00800080u) ^ 0xC300C300u);
}
// The signed nibbles at bits 0 and 16 of r as bf16x2, exactly: (128 + (n +
// 8)) - 136.
__device__ __forceinline__ uint32_t i4x2(uint32_t r) {
  return bf2_sub((r & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}

// One work item's sums on the tensor cores: ct[r][c] = sum over split ks of
// x'[r, k] W[k, col(c)] for the tile's 128 columns, rows r < 8 NRB (the
// int8 / int4 steps; the fused codebook loop's int8 layers and its int8 or
// bf16 head).  WK: 0 int8, 1 int4, 2 bf16 weights.  The int8 / int4 A
// fragments come from ldmatrix .trans and are widened to bf16 exactly by bit
// operations and one bf16x2 add: row m = g of the fragment is tile column 16
// warp + 2g, m = g + 8 column 16 warp + 2g + 1.  bf16 chunks (64 K rows of
// 256 bytes) give the A fragment straight from ldmatrix .trans: row m is
// tile column 16 warp + m.  Two accumulator sets (even and odd k16 slices)
// halve the chain of dependent mma; CHAIN keeps one, every slice in order
// (the fused codebook loop: the chained order of a tensor-core GEMM, which
// its plain version runs).  X holds XB bytes.
template <int NRB, int WK, bool CHAIN = false, int XB = X_BYTES>
__device__ void mma_item(const Params& p, Ring& ring, const Prod& q, int idx,
                         const bf16* x, bf16* X, float* ct) {
  const int ks = idx / q.tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int kr = WK == 2 ? CHUNK_ROWS / 2 : CHUNK_ROWS * q.P;  // K rows of a chunk
  int gch = (XB / 2 / (8 * NRB) - 8) / kr;  // chunks staged together
  gch = gch < 1 ? 1 : gch > q.nch ? q.nch : gch;
  const int XS = gch * kr + 8;
  // The accumulator sets, added once at the end.
  constexpr int SETS = CHAIN ? 1 : 2;
  float acc[2][NRB][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rb = 0; rb < NRB; ++rb)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[h][rb][c] = 0.f;
  for (int ch0 = 0; ch0 < q.nch; ch0 += gch) {
    const int nj = min(gch, q.nch - ch0);
    stage_x<WK == 1>(x, q.K, p.s.B, 8 * NRB, ks * q.kc + ch0 * kr, nj * kr, XS, X);
    for (int j = 0; j < nj; ++j) {
      const uint8_t* w = front(ring);
      const bf16* xj = X + j * kr;
      if constexpr (WK == 2) {
        // Lane's row address: matrices 0-3 are (K rows 0-7, columns 0-7),
        // (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) of the warp's 16 columns.
        const int lrow = (lane & 7) + ((lane >> 4) << 3);
        const int lpiece = 2 * warp + ((lane >> 3) & 1);
#pragma unroll
        for (int s = 0; s < CHUNK_ROWS / 2 / 16; ++s) {
          uint32_t a[4];
          const int row = 16 * s + lrow;
          ldsm_x4_t(a, w + row * 2 * COLS + ((lpiece ^ (row & 7)) * 16));
#pragma unroll
          for (int rb = 0; rb < NRB; ++rb) {
            const bf16* xr = xj + (rb * 8 + g) * XS + 16 * s;
            mma16816(acc[s % SETS][rb], a, *reinterpret_cast<const uint32_t*>(xr + 2 * t),
                     *reinterpret_cast<const uint32_t*>(xr + 8 + 2 * t));
          }
        }
      } else {
        // 32 byte rows an ldmatrix: int8, 2 k16 slices (k 0-7 and 8-15 of each,
        // k slot = K row); int4, 4 slices of 8 byte rows, whose k slots 2t, 2t+1
        // hold K rows 4t, 4t+2 (low nibbles) and 2t+8, 2t+9 rows 4t+1, 4t+3.
#pragma unroll
        for (int it = 0; it < CHUNK_ROWS / 32; ++it) {
          uint32_t r[4];
          const int row = 32 * it + lane;
          ldsm_x4_t(r, w + row * COLS + ((warp ^ (row & 7)) * 16));
#pragma unroll
          for (int h = 0; h < (WK == 0 ? 2 : 4); ++h) {
            uint32_t a[4];
            if constexpr (WK == 0) {
              a[0] = i8x2(r[2 * h]);
              a[1] = i8x2(r[2 * h] >> 8);
              a[2] = i8x2(r[2 * h + 1]);
              a[3] = i8x2(r[2 * h + 1] >> 8);
            } else {
              a[0] = i4x2(r[h]);
              a[1] = i4x2(r[h] >> 8);
              a[2] = i4x2(r[h] >> 4);
              a[3] = i4x2(r[h] >> 12);
            }
            const int s = (WK == 0 ? 2 : 4) * it + h;
#pragma unroll
            for (int rb = 0; rb < NRB; ++rb) {
              const bf16* xr = xj + (rb * 8 + g) * XS + 16 * s;
              if constexpr (WK == 0) {
                mma16816(acc[h % SETS][rb], a, *reinterpret_cast<const uint32_t*>(xr + 2 * t),
                         *reinterpret_cast<const uint32_t*>(xr + 8 + 2 * t));
              } else {
                const uint2 b = *reinterpret_cast<const uint2*>(xr + 4 * t);
                mma16816(acc[h % SETS][rb], a, b.x, b.y);
              }
            }
          }
        }
      }
      pop(ring);
    }
  }
  if constexpr (WK == 2) {
    // (column 16 w + g, row 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
    const int c0 = 16 * warp + g;
#pragma unroll
    for (int rb = 0; rb < NRB; ++rb) {
      const int r0 = rb * 8 + 2 * t;
      ct[r0 * CT_STRIDE + c0] = acc[0][rb][0] + acc[1][rb][0];
      ct[(r0 + 1) * CT_STRIDE + c0] = acc[0][rb][1] + acc[1][rb][1];
      ct[r0 * CT_STRIDE + c0 + 8] = acc[0][rb][2] + acc[1][rb][2];
      ct[(r0 + 1) * CT_STRIDE + c0 + 8] = acc[0][rb][3] + acc[1][rb][3];
    }
  } else {
    const int c0 = 16 * warp + 2 * g;
#pragma unroll
    for (int rb = 0; rb < NRB; ++rb) {
      const int r0 = rb * 8 + 2 * t;
      ct[r0 * CT_STRIDE + c0] = acc[0][rb][0] + acc[1][rb][0];
      ct[(r0 + 1) * CT_STRIDE + c0] = acc[0][rb][1] + acc[1][rb][1];
      ct[r0 * CT_STRIDE + c0 + 1] = acc[0][rb][2] + acc[1][rb][2];
      ct[(r0 + 1) * CT_STRIDE + c0 + 1] = acc[0][rb][3] + acc[1][rb][3];
    }
  }
  csync();
}

// mma_item at the block count of 8 rows that B needs (B <= 32).
template <int WK, bool CHAIN = false, int XB = X_BYTES>
__device__ void run_mma(const Params& p, Ring& ring, const Prod& q, int idx, const bf16* x, bf16* X,
                        float* ct) {
  const int nrb = (p.s.B + 7) / 8;
  if (nrb <= 1) mma_item<1, WK, CHAIN, XB>(p, ring, q, idx, x, X, ct);
  else if (nrb <= 2) mma_item<2, WK, CHAIN, XB>(p, ring, q, idx, x, X, ct);
  else mma_item<4, WK, CHAIN, XB>(p, ring, q, idx, x, X, ct);
}

// Epilogues: thread i owns column c = i % 128 of a tile and rows r0 + 2e
// (r0 = i / 128), e < RPT; loads are issued together before use.
constexpr int RPT = B_MAX * COLS / NT;

// After a split's sums are in ct: with one split, true; else the partial
// tile goes to device memory and the split takes a ticket; the last to
// arrive (true) holds the sum of every split's partial, in split order, in
// ct.  The finishing block also reads, in the same batch of loads, what the
// epilogue needs from device memory: the B x D/128 tile sums of squares
// ``ss`` (if given) into ``ssm`` and the residual tile of ``h`` (if given)
// into ``ht`` (shared memory, row stride CT_STRIDE).  ``flag`` is an int of
// shared memory.
__device__ bool combine(const Params& p, const Prod& q, int idx, float* ct, int* flag,
                        const float* ss, float* ssm, const float* h, float* ht) {
  const int B = p.s.B;
  const int cti = idx % q.tiles, ks = idx / q.tiles;
  const int c = threadIdx.x % COLS, r0 = threadIdx.x / COLS;
  const size_t tile_floats = (size_t)B * COLS;
  if (q.KS > 1) {
    float* mine = q.part + ((size_t)ks * q.tiles + cti) * tile_floats;
    for (int r = r0; r < B; r += 2) mine[r * COLS + c] = ct[r * CT_STRIDE + c];
    csync();
    if (threadIdx.x == 0) {
      // acq_rel: the block's partial (seen through the barrier) is released
      // with the ticket, the other splits' are acquired by the last one.
      const bool last = add_acq_rel(q.ticket + cti, 1u) == (unsigned)(q.KS - 1);
      if (last) atomicExch(q.ticket + cti, 0u);  // re-armed for the next layer
      *flag = last;
    }
    csync();
    if (!*flag) return false;
  }
  const int n_ss = ss != nullptr ? B * p.s.td : 0;
  float ssv[SS_MAX / NT];
#pragma unroll
  for (int u = 0; u < SS_MAX / NT; ++u) {
    const int i = threadIdx.x + u * NT;
    ssv[u] = i < n_ss ? __ldcg(ss + i) : 0.f;
  }
  // Rows in groups of 4 a thread (8 streams a group): partials and h together.
  for (int e0 = 0; e0 < RPT && r0 + 2 * e0 < B; e0 += 4) {
    float v[KS_MAX][4], hv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 2 * (e0 + j);
#pragma unroll
      for (int k = 0; k < KS_MAX; ++k)
        v[k][j] = (q.KS > 1 && k < q.KS && r < B)
                      ? __ldcg(q.part + ((size_t)k * q.tiles + cti) * tile_floats + r * COLS + c)
                      : 0.f;
      hv[j] = (h != nullptr && r < B) ? __ldcg(h + (size_t)r * q.N + cti * COLS + c) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 2 * (e0 + j);
      if (r >= B) continue;
      if (q.KS > 1) {
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < KS_MAX; ++k)
          if (k < q.KS) a += v[k][j];
        ct[r * CT_STRIDE + c] = a;
      }
      if (h != nullptr) ht[r * CT_STRIDE + c] = hv[j];
    }
  }
#pragma unroll
  for (int u = 0; u < SS_MAX / NT; ++u) {
    const int i = threadIdx.x + u * NT;
    if (i < n_ss) ssm[i] = ssv[u];
  }
  csync();
  return true;
}

// RMSNorm's scale of each row from its D/128 tile sums of squares (in
// shared memory), summed in order.
__device__ void row_scales(const Params& p, const float* ssm, float* rsv) {
  if (threadIdx.x < p.s.B) {
    float a = 0.f;
    for (int t = 0; t < p.s.td; ++t) a += ssm[threadIdx.x * p.s.td + t];
    rsv[threadIdx.x] = __frsqrt_rn(a / (float)p.s.D + p.eps);
  }
  csync();
}

// The bf16 tier's RMSNorm scales: the B x D/128 tile sums of squares
// ``ss`` (f64, exact for its bf16-valued residual) into shared memory
// ``ssm``, each row's summed in order, then the plain path's f32 steps: the
// mean rounded to f32, plus eps, rsqrtf (the function torch's rsqrt runs).
// So the scale is the plain path's whenever that path's f32 reduction lands
// on the exact mean.
__device__ void row_scales_exact(const Params& p, const float* ss, double* ssm, float* rsv) {
  for (int i = threadIdx.x; i < p.s.B * p.s.td; i += NT)
    ssm[i] = __ldcg(reinterpret_cast<const double*>(ss) + i);
  csync();
  if (threadIdx.x < p.s.B) {
    double a = 0.0;
    for (int t = 0; t < p.s.td; ++t) a += ssm[threadIdx.x * p.s.td + t];
    rsv[threadIdx.x] = rsqrtf(__fadd_rn((float)(a / p.s.D), p.eps));
  }
  csync();
}

// Writes the residual tile cti (values in the ct tile) to h, the next
// product's bf16 operand (times this column's u when has_u; not for the bf16
// tier, EXACT, whose products normalise h as they stage it) and the tile's
// per-row sums of squares (a warp per row: lanes along the columns, then the
// butterfly; f64 for the bf16 tier, where they are exact).
template <bool EXACT>
__device__ void residual_out(const Params& p, int cti, const float* ctile, bf16* xnext,
                             bool has_u, float un, float* ss) {
  const int D = p.s.D, c = threadIdx.x % COLS, r0 = threadIdx.x / COLS, n = cti * COLS + c;
  for (int r = r0; r < p.s.B; r += 2) {
    const float v = ctile[r * CT_STRIDE + c];
    p.h[(size_t)r * D + n] = v;
    if constexpr (!EXACT) xnext[(size_t)r * D + n] = __float2bfloat16_rn(has_u ? v * un : v);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < p.s.B; r += NWARP) {
    if constexpr (EXACT) {
      double sum = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const double v = ctile[r * CT_STRIDE + lane * 4 + k];
        sum = fma(v, v, sum);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) reinterpret_cast<double*>(ss)[r * p.s.td + cti] = sum;
    } else {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = ctile[r * CT_STRIDE + lane * 4 + k];
        sum = fmaf(v, v, sum);
      }
      sum = warp_sum(sum);
      if (lane == 0) ss[r * p.s.td + cti] = sum;
    }
  }
}

// Flags a product item waits on before it reads its operand rows.  The
// bf16 tier (EXACT) normalises its QKV, gate-up and head operands with
// RMSNorm's scale over the whole row, so those wait on every residual tile.
template <bool EXACT>
__device__ void wait_operand(const Params& p, int kind, int l, const Prod& q, int ks) {
  const Shape& s = p.s;
  const bool whole = EXACT && (kind == K_QKV || kind == K_GU || kind == K_HEAD);
  const int k0 = whole ? 0 : ks * q.kc, k1 = whole ? s.D - 1 : k0 + q.kc - 1;
  switch (kind) {
    case K_QKV:
    case K_HEAD:
      wait_flags(p.f_dn + (size_t)l * s.td + k0 / COLS, k1 / COLS - k0 / COLS + 1, p.epoch);
      break;
    case K_O: {
      const int gw = s.G * s.hd, lo = k0 / gw, hi = k1 / gw;
      wait_flags(p.f_att + ((size_t)l * s.nkv + lo) * s.B, (hi - lo + 1) * s.B, p.epoch);
      break;
    }
    case K_GU:
      wait_flags(p.f_o + (size_t)l * s.td + k0 / COLS, k1 / COLS - k0 / COLS + 1, p.epoch);
      break;
    default:  // K_DOWN: gate-up pair tiles of 64 columns
      wait_flags(p.f_gu + (size_t)l * s.tg + k0 / 64, k1 / 64 - k0 / 64 + 1, p.epoch);
      break;
  }
  csync();
}

// A finished product tile (its epilogue done): its flag, if an item waits
// on it (the head's tiles have none), else the block's barrier alone.
__device__ __forceinline__ void tile_done(const Params& p, const Item& it, int cti) {
  unsigned* done = it.kind == K_QKV ? p.f_qkv + (size_t)it.l * p.s.tq + cti
                 : it.kind == K_O   ? p.f_o + (size_t)it.l * p.s.td + cti
                 : it.kind == K_GU  ? p.f_gu + (size_t)it.l * p.s.tg + cti
                 : it.kind == K_DOWN ? p.f_dn + (size_t)(it.l + 1) * p.s.td + cti
                                     : nullptr;
  if (done != nullptr) signal(done, p.epoch);
  else csync();
}

// Init (residual tile cti = h0) or final (nh of tile cti) item.  The bf16
// tier (EXACT) writes no operand at init (its products normalise h as they
// stage it) and rounds the final norm twice, nh = rnd(rnd(h rs) w); the
// int8 / int4 tiers write bf16(h0) (times u for int4) and nh = h rs w.
template <bool EXACT>
__device__ void row_item(const Params& p, const Item& it, uint8_t* work, float* rsv,
                         unsigned long long* tready) {
  const Shape& s = p.s;
  const int cti = it.idx, c = threadIdx.x % COLS, r0 = threadIdx.x / COLS, n = cti * COLS + c;
  float* ct = reinterpret_cast<float*>(work + X_BYTES);
  csync();  // the previous item's readers of the work area are done
  if (it.kind == K_INIT) {
#pragma unroll 4
    for (int r = r0; r < s.B; r += 2) ct[r * CT_STRIDE + c] = __ldg(p.h0 + (size_t)r * s.D + n);
    csync();
    if constexpr (EXACT) {
      residual_out<true>(p, cti, ct, nullptr, false, 1.f, p.ss_a);
    } else {
      const bool has_u = s.int4 != 0;
      residual_out<false>(p, cti, ct, p.xa, has_u, has_u ? __ldg(p.uqkv + n) : 1.f, p.ss_a);
    }
    signal(p.f_dn + cti, p.epoch);
    return;
  }
  wait_flags(p.f_dn + (size_t)s.L * s.td, s.td, p.epoch);
  csync();
  mark(p, tready, 0);
  if constexpr (EXACT) {
    row_scales_exact(p, p.ss_a, reinterpret_cast<double*>(work), rsv);
  } else {
    float* ssm = reinterpret_cast<float*>(work);
    for (int i = threadIdx.x; i < s.B * s.td; i += NT) ssm[i] = __ldcg(p.ss_a + i);
    csync();
    row_scales(p, ssm, rsv);
  }
  const float w = __ldg(p.fnw + n);
#pragma unroll 4
  for (int r = r0; r < s.B; r += 2) {
    const float hv = __ldcg(p.h + (size_t)r * s.D + n);
    p.nh[(size_t)r * s.D + n] = EXACT ? bf16r(bf16r(hv * rsv[r]) * w) : hv * rsv[r] * w;
  }
  csync();
}

// ---------------------------------------------------------------------------
// Attention
// ---------------------------------------------------------------------------

struct AttSmem {
  float *sc, *pv;
  int* idx;
  bf16 *qh, *ks, *vs;
  int wp, kch;
};

__device__ __forceinline__ AttSmem att_smem(uint8_t* work, int W, int G, int hd) {
  AttSmem a;
  a.wp = (W + 1 + 3) / 4 * 4;
  a.kch = kch_of(hd);
  a.sc = reinterpret_cast<float*>(work);
  a.idx = reinterpret_cast<int*>(a.sc + G * a.wp);
  a.qh = reinterpret_cast<bf16*>(a.idx + a.wp);
  a.ks = a.qh + 8 * (hd + 8);
  a.vs = a.ks + a.kch * (hd + 8);
  a.pv = reinterpret_cast<float*>(a.vs + a.kch * (hd + 8));
  return a;
}

// Rows [c kch, c kch + kch) of the compacted key list (n keys; index W is
// the new row) into K or V rows of shared memory, 8 loads in flight a
// thread; ``new_row`` false skips the new row (it is not written yet).
__device__ void load_kv(const Params& p, const AttSmem& a, bool values, int l, int b, int kvh,
                        int c, int n, bool new_row) {
  constexpr int SB = 8;
  const Shape& s = p.s;
  const int per = s.hd / 8, rows = min(a.kch, n - c * a.kch), total = rows * per;
  const bf16* cache = (values ? p.vc : p.kc) + (((size_t)l * s.B + b) * p.W * s.nkv + kvh) * s.hd;
  const bf16* fresh = (values ? p.new_v : p.new_k) + (((size_t)l * s.B + b) * s.nkv + kvh) * s.hd;
  bf16* dst = values ? a.vs : a.ks;
  for (int i0 = threadIdx.x; i0 < total; i0 += SB * NT) {
    uint4 v[SB];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * NT;
      if (i >= total) break;
      const int j = a.idx[c * a.kch + i / per], piece = i % per;
      if (j != p.W) v[u] = __ldg(reinterpret_cast<const uint4*>(cache + (size_t)j * s.nkv * s.hd) + piece);
      else if (new_row) v[u] = __ldcg(reinterpret_cast<const uint4*>(fresh) + piece);
    }
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * NT;
      if (i >= total) break;
      const int j = a.idx[c * a.kch + i / per];
      if (j != p.W || new_row)
        *reinterpret_cast<uint4*>(dst + (i / per) * (s.hd + 8) + (i % per) * 8) = v[u];
    }
  }
}

// RoPE'd q of the group, then scores, softmax and P.V of (kv head, stream b)
// over the stream's usable keys and its new key; the output, bf16-rounded
// (times u_o for int4), is o-proj's operand.
__device__ void attention_item(const Params& p, const Item& it, uint8_t* work, int* wcnt,
                               unsigned long long* tready) {
  const Shape& s = p.s;
  const int l = it.l, kvh = it.idx / s.B, b = it.idx % s.B;
  const int G = s.G, hd = s.hd, W = p.W;
  const AttSmem a = att_smem(work, W, G, hd);
  const int kch = a.kch;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  csync();  // the previous item's readers of the work area are done
  // The usable keys, in order.
  int base = 0;
  for (int j0 = 0; j0 < W; j0 += NT) {
    const int j = j0 + threadIdx.x;
    const bool ok = j < W && __ldg(p.bias + (size_t)b * W + j) >= 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) wcnt[warp] = __popc(m);
    csync();
    int off = base, tot = 0;
    for (int w = 0; w < NWARP; ++w) {
      off += w < warp ? wcnt[w] : 0;
      tot += wcnt[w];
    }
    if (ok) a.idx[off + __popc(m & ((1u << lane) - 1u))] = j;
    base += tot;
    csync();
  }
  const int n = base + 1;  // with the new key, index W
  if (threadIdx.x == 0) a.idx[base] = W;
  csync();
  const int nchunk = (n + kch - 1) / kch;
  // The cache rows of the first chunk do not depend on this step.
  load_kv(p, a, false, l, b, kvh, 0, n, false);
  load_kv(p, a, true, l, b, kvh, 0, n, false);
  // Wait for the QKV tiles of the group's q heads, its k and its v.
  const int q0 = kvh * G * hd, q1 = q0 + G * hd - 1;
  const int kcol = s.nqh + kvh * hd, vcol = s.nqh + (s.nkv + kvh) * hd;
  const unsigned* fq = p.f_qkv + (size_t)l * s.tq;
  wait_flags(fq + q0 / COLS, q1 / COLS - q0 / COLS + 1, p.epoch);
  wait_flags(fq + kcol / COLS, 1, p.epoch);
  wait_flags(fq + vcol / COLS, 1, p.epoch);
  csync();
  mark(p, tready, 0);
  {
    // One batch of loads: the group's q (bf16 rows of 16 bytes pieces, the
    // rows past G zero) and, if it falls in the first chunk, the new K/V row.
    const int per = hd / 8;
    const bool qt = threadIdx.x < 8 * per;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (qt && threadIdx.x < G * per)
      qv = __ldcg(reinterpret_cast<const uint4*>(p.qb + (size_t)b * s.nqh + q0) + threadIdx.x);
    const bool fresh = n <= kch && threadIdx.x < 2 * per;
    const bool isv = threadIdx.x >= per;
    uint4 row;
    if (fresh) {
      const size_t at = (((size_t)l * s.B + b) * s.nkv + kvh) * hd;
      row = __ldcg(reinterpret_cast<const uint4*>((isv ? p.new_v : p.new_k) + at) + threadIdx.x % per);
    }
    if (qt)
      *reinterpret_cast<uint4*>(a.qh + (threadIdx.x / per) * (hd + 8) + (threadIdx.x % per) * 8) = qv;
    if (fresh)
      *reinterpret_cast<uint4*>((isv ? a.vs : a.ks) + (n - 1) * (hd + 8) + (threadIdx.x % per) * 8) = row;
  }
  csync();
  mark(p, tready, 1);
  // Scores on the tensor cores: a warp per 16 keys, S^T = K q^T by
  // mma.sync (keys as the 16-row operand, the group's heads as the 8
  // columns), f32 sums of the exact bf16 products.
  const int g8 = lane >> 2, t4 = lane & 3;
  for (int c = 0; c < nchunk; ++c) {
    if (c > 0) {
      csync();
      load_kv(p, a, false, l, b, kvh, c, n, true);
      csync();
    }
    const int rows = min(kch, n - c * kch);
    for (int kt = warp; kt < (rows + 15) / 16; kt += NWARP) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ds = 0; ds < hd / 16; ++ds) {
        uint32_t fa[4];
        ldsm_x4(fa, a.ks + (kt * 16 + (lane & 15)) * (hd + 8) + ds * 16 + (lane >> 4) * 8);
        const bf16* qp = a.qh + g8 * (hd + 8) + ds * 16 + 2 * t4;
        mma16816(acc, fa, *reinterpret_cast<const uint32_t*>(qp),
                 *reinterpret_cast<const uint32_t*>(qp + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * 16 + g8 + (e >> 1) * 8, g = 2 * t4 + (e & 1);
        if (g < G && key < rows) a.sc[g * a.wp + c * kch + key] = acc[e] * p.scale;
      }
    }
  }
  csync();
  mark(p, tready, 2);
  // Softmax: a warp per head; bf16 probabilities.
  for (int g = warp; g < G; g += NWARP) {
    float* sg = a.sc + g * a.wp;
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
  // P.V on the tensor cores: O^T = V^T P^T, a warp per 16 output dims and
  // every (hd / 16)-th key tile (V^T by ldmatrix .trans, the bf16
  // probabilities as the 8 columns); the key parts are added in order.
  const int ndt = hd / 16, nks = NWARP / ndt, dt = warp % ndt, kq = warp / ndt;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nchunk; ++c) {
    csync();
    const int rows = min(kch, n - c * kch);
    if (c > 0) load_kv(p, a, true, l, b, kvh, c, n, true);
    // Rows past the chunk's keys up to a whole tile: zero (P is 0 there,
    // and 0 times a stale NaN would not be).
    for (int i = threadIdx.x; i < ((rows + 15) / 16 * 16 - rows) * (hd / 8); i += NT)
      *reinterpret_cast<uint4*>(a.vs + (rows + i / (hd / 8)) * (hd + 8) + (i % (hd / 8)) * 8) =
          make_uint4(0, 0, 0, 0);
    csync();
    for (int kt = kq; kt < (rows + 15) / 16; kt += nks) {
      uint32_t fa[4];
      ldsm_x4_t(fa, a.vs + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * (hd + 8) + dt * 16 +
                        ((lane >> 3) & 1) * 8);
      const int j0 = c * kch + kt * 16 + 2 * t4;
      auto pr = [&](int j) { return g8 < G && j < n ? a.sc[g8 * a.wp + j] : 0.f; };
      mma16816(acc, fa, pack_bf16(pr(j0), pr(j0 + 1)), pack_bf16(pr(j0 + 8), pr(j0 + 9)));
    }
  }
  csync();
  mark(p, tready, 3);
  // acc: (dim g8, head 2t4), (g8, 2t4 + 1), (g8 + 8, 2t4), (g8 + 8, 2t4 + 1).
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a.pv[(kq * 8 + 2 * t4 + (e & 1)) * hd + dt * 16 + g8 + (e >> 1) * 8] = acc[e];
  csync();
  const float* uo = s.int4 ? p.uo + (size_t)l * s.nqh : nullptr;
  for (int o = threadIdx.x; o < G * hd; o += NT) {
    float v = 0.f;
    for (int k = 0; k < nks; ++k) v += a.pv[(k * 8 + o / hd) * hd + o % hd];
    const int col = q0 + o;
    p.xo[(size_t)b * s.nqh + col] = __float2bfloat16_rn(uo != nullptr ? v * __ldg(uo + col) : v);
  }
  mark(p, tready, 4);
  signal(p.f_att + ((size_t)l * s.nkv + kvh) * s.B + b, p.epoch);
}

// ---------------------------------------------------------------------------
// The main loop
// ---------------------------------------------------------------------------

// NT consumer threads (8 warps: waits, products, epilogues, attention) and
// a producer warpgroup (the weight stream).
constexpr int BLOCK = NT + PROD;

// The body of a tier's kernel (one block per SM, BLOCK threads).  ``Tier``
// gives the tier's chunk rows in 16-byte pieces (PIECES), whether it is the
// bf16 tier (EXACT), and its product and row items:
//   Tier::product(p, ring, item, work, rsv, flag, tready)
//   Tier::row(p, item, work, rsv, tready)   (init and final items)
template <class Tier>
__device__ __forceinline__ void run_step(const Params& p) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* work = smem_raw + (size_t)p.ring * CHUNK_BYTES;
  float* rsv = reinterpret_cast<float*>(work + work_bytes(p.W, p.s.G, p.s.hd));
  int* wcnt = reinterpret_cast<int*>(rsv + B_MAX);
  int* flag = wcnt + NWARP;
  unsigned long long* tready = reinterpret_cast<unsigned long long*>(rsv + 64);
  uint64_t* full = reinterpret_cast<uint64_t*>(rsv + 128);
  uint64_t* empty = full + RING_MAX;
  Plan* plan = reinterpret_cast<Plan*>(reinterpret_cast<uint8_t*>(rsv) + SMALL_BYTES);
  const Sched sc = sched_of(p.s);
  const int n_mine = (sc.total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const bool trace = p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  const int n_stages = 5 * p.s.L + 3;
  int stage = 0;
  if (trace) p.stamps[0] = globaltimer();
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.ring; ++i) {
      hopper::mbar_init(full + i, PROD);
      hopper::mbar_init(empty + i, NWARP);
    }
    hopper::fence_barrier_init();
  }
  build_plan<Tier::EXACT>(p, sc, plan, n_mine);  // ends with a barrier of the whole block
  if (threadIdx.x >= NT) {
    produce<Tier::PIECES>(p, plan, n_mine, smem_raw, full, empty);
    return;
  }

  Ring ring{smem_raw, full, empty, p.ring, 0};
  for (int i = 0; i < n_mine; ++i) {
    const Item it = item_at(sc, p.s.L, blockIdx.x + i * gridDim.x);
    if (trace) {
      const int st = stage_of(it);
      const unsigned long long now = globaltimer();
      for (; stage < st; ++stage) p.stamps[stage + 1] = now;
    }
    const int g = blockIdx.x + i * gridDim.x;
    unsigned long long t_begin = 0;
    if (p.item_ns != nullptr && threadIdx.x == 0) {
      for (int k = 0; k < TRACE_MARKS; ++k) tready[k] = 0;
      tready[0] = t_begin = globaltimer();  // an item without waits ends them at once
    }
    switch (it.kind) {
      case K_INIT:
      case K_FINAL: Tier::row(p, it, work, rsv, tready); break;
      case K_ATT: attention_item(p, it, work, wcnt, tready); break;
      default: Tier::product(p, ring, it, work, rsv, flag, tready); break;
    }
    if (p.item_ns != nullptr && threadIdx.x == 0) {
      unsigned long long* o = p.item_ns + (size_t)TRACE_SLOTS * g;
      o[0] = stage_of(it);
      o[1] = t_begin;
      for (int k = 0; k < TRACE_MARKS; ++k) o[k + 2] = tready[k];
      o[TRACE_SLOTS - 1] = globaltimer();
    }
  }
  if (trace) {
    const unsigned long long now = globaltimer();
    for (; stage < n_stages; ++stage) p.stamps[stage + 1] = now;
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// Whether the kernel takes these shapes: B within the tier's cap (bf16: 8,
// one 8-column operand; else 32), whole 128-column tiles (64-column gate-up
// pairs), heads that tile 128 columns, whole chunks in every split.
bool shapes_ok(const Shape& s, int W) {
  const int kr = s.exact ? CHUNK_ROWS / 2 : s.int4 ? 2 * CHUNK_ROWS : CHUNK_ROWS;
  return s.B >= 1 && s.B <= (s.exact ? 8 : B_MAX) && s.L >= 1 && s.nkv > 0 &&
         s.nq % s.nkv == 0 && s.G <= G_MAX && s.hd >= 16 && s.hd <= HD_MAX && COLS % s.hd == 0 &&
         W >= 0 && s.D % COLS == 0 && s.n_head % COLS == 0 && s.QKVN % COLS == 0 &&
         s.F % 64 == 0 && s.D % kr == 0 && s.nqh % kr == 0 && s.F % kr == 0 &&
         s.B * s.td <= SS_MAX;
}

// Ring depth: as deep as shared memory allows, at most RING_MAX.  Returns
// 0 if two chunks do not fit.
int ring_depth(int fixed) {
  const int room = (SMEM_MAX - fixed) / CHUNK_BYTES;
  const int most = room < RING_MAX ? room : RING_MAX;
  return most < 2 ? 0 : most;
}

// Shared memory of a block past its ring: the work area, the small
// arrays, the plan of its items.
inline int fixed_smem(const Shape& s, int W, int grid) {
  const int per_block = (sched_of(s).total + grid - 1) / grid;
  return work_bytes(W, s.G, s.hd) + SMALL_BYTES + per_block * (int)sizeof(Plan);
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Checks the shapes and buffers, then fills everything of ``p`` but the
// weights, scales, prescales and norm weights: shapes, window, ring depth,
// epoch, the activations and outputs, the scratch's parts, the traces.
// Returns 0 or a Refused code (or a cudaError_t).
int bind(Params& p, const Shape& s, int* sms, const void* h0, const void* cosb, const void* sinb,
         const void* bias, const void* kc, const void* vc, const void* final_nw, void* nh,
         void* logits, void* new_k, void* new_v, void* scratch, long long scratch_bytes,
         void* stamps, void* item_ns, long long item_ns_len, int W, int epoch, float eps) {
  if (!shapes_ok(s, W)) return REFUSED_SHAPES;
  const Layout lay = layout_of(s);
  if (lay.total > scratch_bytes) return REFUSED_BUFFER;
  if (item_ns != nullptr && item_ns_len < (long long)TRACE_SLOTS * sched_of(s).total)
    return REFUSED_BUFFER;
  p = Params{};
  p.s = s;
  p.W = W;
  const cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  p.ring = ring_depth(fixed_smem(s, W, *sms));
  if (p.ring == 0) return REFUSED_WINDOW;
  p.epoch = (unsigned)epoch;
  p.eps = eps;
  p.scale = (float)(1.0 / sqrt((double)s.hd));
  p.h0 = static_cast<const float*>(h0);
  p.cosb = static_cast<const float*>(cosb);
  p.sinb = static_cast<const float*>(sinb);
  p.bias = static_cast<const float*>(bias);
  p.kc = static_cast<const bf16*>(kc);
  p.vc = static_cast<const bf16*>(vc);
  p.fnw = static_cast<const float*>(final_nw);
  p.nh = static_cast<float*>(nh);
  p.logits = static_cast<float*>(logits);
  p.new_k = static_cast<bf16*>(new_k);
  p.new_v = static_cast<bf16*>(new_v);
  uint8_t* sb = static_cast<uint8_t*>(scratch);
  auto f32 = [&](long long off) { return reinterpret_cast<float*>(sb + off); };
  auto b16 = [&](long long off) { return reinterpret_cast<bf16*>(sb + off); };
  auto u32 = [&](long long off) { return reinterpret_cast<unsigned*>(sb + off); };
  p.h = f32(lay.h); p.ss_a = f32(lay.ss_a); p.ss_m = f32(lay.ss_m);
  p.p_qkv = f32(lay.p_qkv); p.p_o = f32(lay.p_o); p.p_gu = f32(lay.p_gu);
  p.p_down = f32(lay.p_down); p.p_head = f32(lay.p_head);
  p.xa = b16(lay.xa); p.xm = b16(lay.xm); p.xo = b16(lay.xo); p.xd = b16(lay.xd);
  p.qb = b16(lay.qb);
  p.f_qkv = u32(lay.f_qkv); p.f_att = u32(lay.f_att); p.f_o = u32(lay.f_o);
  p.f_gu = u32(lay.f_gu); p.f_dn = u32(lay.f_dn);
  p.t_qkv = u32(lay.t_qkv); p.t_o = u32(lay.t_o); p.t_gu = u32(lay.t_gu);
  p.t_dn = u32(lay.t_dn); p.t_head = u32(lay.t_head);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.item_ns = static_cast<unsigned long long*>(item_ns);
  return 0;
}

// One cooperative launch of ``kernel`` (a run_step), one block per SM.
template <class Kernel>
cudaError_t launch(Kernel kernel, Params& p, int sms, cudaStream_t st) {
  const size_t smem = (size_t)p.ring * CHUNK_BYTES + fixed_smem(p.s, p.W, sms);
  int per_sm = 0;
  cudaError_t e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms), dim3(BLOCK), args, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The message of a return code: a Refused code's, else CUDA's.
const char* refused_string(int code) {
  switch (code) {
    case REFUSED_SHAPES: return "shapes the kernel does not take";
    case REFUSED_WINDOW:
      return "the attention window leaves no shared memory for a ring of two weight chunks";
    case REFUSED_BUFFER: return "a scratch or item trace buffer smaller than the step needs";
    case REFUSED_SMEM:
      return "the weight ring, work area and item plan need more shared memory than a block has";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // namespace
