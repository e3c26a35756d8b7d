// The attention forward for Hopper (sm_90a): one online-softmax mainloop on
// wgmma with register accumulators, fed by TMA, shared by five kernels.
//
// Replaces five TPU kernels that compute the same online softmax:
//   K13 deepspeed_tpu/sequence/ring_flash.py _ring_fwd_kernel (one ring step:
//       fold one K/V shard into the carry m, l, acc at global offsets) ->
//       ring_flash.cu ring_fwd_wgmma, mode RING;
//   K3  deepspeed_tpu/ops/pallas/flash_attention.py _fwd_kernel (out and
//       lse from an empty state) -> flash_attention.cu flash_fwd_wgmma,
//       mode FLASH;
//   K11 deepspeed_tpu/ops/pallas/sparse_flash.py _kernel (block-sparse, over
//       the live 16-key blocks of each query tile) -> sparse_flash.cu
//       sparse_fwd_wgmma, mode SPARSE;
//   K12 deepspeed_tpu/ops/pallas/evoformer_flash.py _evo_fwd_kernel (two
//       additive f32 biases) -> evoformer_flash.cu evo_fwd_wgmma, mode EVO;
//   K1  deepspeed_tpu/ops/pallas/paged_attention.py _paged_kernel (queries of
//       a chunk over in-place KV pages, at large C * G) -> paged_attention.cu
//       paged_fwd_wgmma, mode PAGED.
// Per query row r and key column c of one (batch, head), with q already
// scaled and global positions row = q_off + r, col = k_off + c:
//   s = q . k + slope[h] * (col - row)   (slope 0 without ALiBi)
//   visible iff r < Sq, c < Sk, (!causal || row >= col), (window <= 0 ||
//   row - col < window), and qseg[r] == kseg[c] with segment ids;
//   m' = max(m, max s), alpha = exp(m - m'), p = exp(s - m') on visible keys
//   and exactly 0 on the rest, l' = l alpha + sum p (from the f32 p),
//   acc' = acc alpha + bf16(p) v.
// RING reads m (natural-log units), l and acc from the f32 carry and writes
// them back unnormalised; a row that sees no key keeps them bit for bit
// (alpha = 1, p = 0), and an item (128 query rows) that sees no key of the
// step is skipped before it touches a buffer. FLASH starts at m = -inf, l = 0, acc = 0 and writes
// bf16 out = acc / l and lse = m + log l (0 and +inf where l = 0).
// SPARSE walks, for each query tile, the stages of 8 live 16-key blocks
// that compile_key_blocks (ops/sparse_flash.py) lists: s = (q . k) * scale
// in f32, visible iff the stage's mask bit is set (a stage whose bits are
// all set takes the unmasked pass), p = 0 exactly elsewhere, out = acc / l
// (0 where l = 0). EVO takes all keys, q scaled in the kernel to
// bf16(q x bf16(scale)) (the product of two bf16 values is exact in f32, so
// this is the TPU wrapper's pre-scale bit for bit), s = q . k + b1[c] +
// b2[r, c] in f32 in that order, m from -1e30 as the TPU kernel (a row of
// -inf logits gets p = 0 and outputs 0, a row of -1e9 logits averages V),
// out = acc / l (0 where l = 0).
// PAGED: the query rows r = c * G + g of one kv head (Sq = C G rows, H = KVH
// items a sequence), s = (q . k) * scale in f32, + slope[kv head G + g] (key
// pos - pos) with ALiBi, softcap tanh, visible iff the key's position is in
// [pos - window + 1, pos] and, for a pool slot, below the pool's end (cs with
// a chunk); out = acc / l, and 0 for a pad row (pos -1).
//
// What bounds it on this card: K13 at qwen2-7b's shard shapes (Sq = Sk =
// 8192, H = 28, KVH = 4, D = 128) does 4 D flops per visible pair against
// ~0.2 GB, operation-bound (0.97 ms a full step at 989 TFLOP/s); K3 at
// gpt2-xl's shape (B 8, S 1024, H 25, D 64, causal) reads q, k, v and writes
// out once (~105 MB, 0.032 ms at 3.35 TB/s) against 0.027 ms of
// operations: bytes-bound by a hair, with key loops of 1-8 tiles, so each
// block's start and end count.
//
// Layout: three warpgroups a block (hopper_tiles.cuh), two consumers of 64
// rows and one producer warp; setmaxnreg gives each consumer 240 registers
// a thread and the producer 24, so one block fills an SM. The grid is
// persistent, one block an SM: work items of 128 query rows of one (batch,
// head) go longest first (the last query tiles of a causal grid), dealt to
// the blocks as a serpentine, so that every block's total stays within an
// item of the others'. The producer TMA-loads an item's Q once the
// consumers are done with the previous item's, then streams K/V tiles of BK
// keys (128 at D 64 and 128, 64 at D 256) through two stages, each guarded
// by a full and an empty mbarrier, with the tile's segment ids: the next
// item's loads overlap this item's last products and its epilogue. Tensor
// maps come from the tensors' own strides, so strided shard views are read
// in place.
// A consumer's tile: S = Q K^T (m64nBKk16, both operands K-major in shared
// memory) into registers; the element pass (ALiBi, the row max over the
// quad of threads that holds a row by two shfl_xor, p and alpha by
// ex2.approx with log2 e folded in as one fma, this thread's share of l,
// row reductions as four independent partials); O += bf16(P) V from
// registers (V read MN-major). O (64 x D f32 a warpgroup) stays in
// registers for the whole key loop and is rescaled there. The two consumer
// warpgroups take turns in the element pass (named barriers): a pass runs
// while the other warpgroup's products run, and the two passes do not
// compete for the special function unit. Only tiles at a mask's edge
// (tile_masked) test visibility, as two compares of the element's column
// offset against per-row limits; segment ids and ALiBi take their own
// instantiations of the pass. The key range and the masked-tile test are
// the block's, so no branch depends on the thread while a product is in
// flight and ptxas keeps the wgmmas asynchronous.
// Registers a consumer thread: O D / 2, S BK / 2, P BK / 4 (D = 128: 64 +
// 64 + 32; D = 256 with BK = 64: 128 + 32 + 16), no spill at any head dim,
// so D = 256 takes this kernel too. l is summed per thread and across the
// quad once at the end. Each item is one block's alone: no atomics, a fixed
// order, the same bits on every run.
// SPARSE and EVO form their logits (scale and mask; the biases) before
// their turn, while the other warpgroup's pass runs, and take the turn for
// the softmax alone.
// SPARSE: a stage is 8 key blocks of 16 rows, each one TMA box of K and of
// V (a lane a box), at 2048-byte steps of the stage's tile; a 16-row box
// writes the same 128-byte swizzle a 128-row box writes there. Three
// stages keep more boxes in flight. Padding slots load nothing and the
// producer zeroes their V rows. Each consumer thread reads its two rows of
// the stage's mask (8 words) from L2 while S is in flight (a producer copy
// into shared memory was slower), shifted so that every bit test is by a
// constant. Items come longest first and are dealt on the host, each to
// the least loaded block (sparse_flash.py deal_items): a 32-stage query
// tile beside 2-stage ones leaves a serpentine's blocks far apart.
// EVO: items are 128 query rows of one (b n, h) over all keys; a stage
// also stages the pair bias's 128 x BK f32 tile by TMA (32-column boxes,
// 128-byte swizzle: the pass's float2 reads are conflict-free) and the
// mask bias's BK slice (producer stores) at D 64 and 128 (BK 64 at D 128,
// to fit); at D = 256 the pass reads the pair bias from L2. Each block
// takes a contiguous run of items, MSA rows fastest, so a stage keeps its
// pair-bias tile from one item to the next. q, k, v are read through 5-D
// tensor maps over (D, H, S, N, B), so any strides of the (B, N, H, S, D)
// views are read in place.
// PAGED: items of 128 query rows of one (sequence, kv head), longest first
// (later row tiles, later positions); each bounds its own key range from its
// rows' positions (paged_range: pool slots from the window floor of its
// least position up to min(pool end, its greatest + 1), the chunk keys whose
// positions its rows can see), and an item with no live row loads nothing
// and writes its zeros. The producer gathers Q by cp.async (rows c G + g of
// the (B, C, H, D) q, pad rows zero), loads a pool tile that lies wholly in
// the live range by TMA from the (L, KVH, NB, bs, D) pool, page by page
// through the block table (min(bs, BK) slots a box), and a boundary tile or
// a tile of the chunk's own keys by cp.async with dead rows zero-filled
// (never read: a NaN in a stale slot, trash block 0 or a pad chunk row cannot
// reach p = 0 times V), the chunk keys' positions beside them. Consumers
// fence the async proxy after each wait (cp.async writes through the generic
// proxy). The pass masks pool tiles by per-row slot limits (only tiles at a
// limit); a chunk tile's S product starts from each key's mask and ALiBi
// bias (from the key positions the producer stages beside it), so the pass
// holds no key position. ALiBi and softcap take their own instantiations.
// The producer keeps 72 registers and each consumer 216, and a consumer
// thread keeps its rows' data for the item in shared memory: at D 256 the
// consumers have no register to spare.
#pragma once

#include <cmath>
#include <type_traits>

#include "hopper_tiles.cuh"

namespace flash_fwd {

using bf16 = __nv_bfloat16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* slopes;  // (H,) or null
  const int* qseg;      // (B, Sq) or null
  const int* kseg;      // (B, Sk) or null
  float* m;             // RING: the carry, (B, H, Sq) and (B, Sq, H, D)
  float* l;
  float* acc;
  bf16* out;            // FLASH: (B, Sq, H, D) and (B, H, Sq)
  float* lse_out;
  long long qsb, qsr, ksb, ksr, vsb, vsr;  // batch and row strides, elements
  int Sq, Sk, H, KVH, q_off, k_off, window, causal;
  int B;                // set by launch(); EVO: B x N
  // SPARSE: the key-block tables (ops/sparse_flash.py compile_key_blocks)
  const int* order;        // (Sq / BQ,) query tiles, most stages first
  const int* stage_start;  // (Sq / BQ + 1,) each tile's stages
  const int* kblocks;      // (stages, 8) the key block of each slot, -1 padding
  const uint4* kmask;      // (stages, BQ) the row's mask words of the stage
  const int* kfull;        // (stages,) 1: every bit of the stage set
  const int* deal_start;   // (blocks + 1,) each block's run of `deal`
  const int* deal;         // (items,) the items, dealt longest first to the least loaded block
  int blocks;              // SPARSE: the deal's blocks (0: one an SM)
  float scale;             // SPARSE: on q . k in f32; EVO: q's, rounded to bf16
  // EVO
  const float* b1;         // (B x N, Sk) mask bias, or null
  const float* b2;         // (B, H, Sq, Sk) pair bias, or null
  int N;                   // MSA rows a batch
  // PAGED: q (B, C, H G, D), k and v the (L, KVH, NB, bs, D) pools read
  // through the tensor maps, out (B, C, H G, D); here H = KVH and Sq = C G
  const int* tables;       // (B, MB) page ids
  const int* positions;    // (B, C), -1 padding
  const bf16* chunk_k;     // (B, C, KVH, D) the chunk's own keys, or null
  const bf16* chunk_v;
  int C, G, NB, bs, MB, layer;
  float softcap;           // 0: none
};

enum Mode { RING, FLASH, SPARSE, EVO, PAGED };

// PAGED's producer gathers rows by cp.async (addresses through the block
// table), which 24 registers cannot hold: it keeps 72 and gives each
// consumer 216 (128 x 72 + 256 x 216 = the 64,512 a block holds at 168 a
// thread; the consumers spilled at D 256 with 208)
constexpr int PAGED_PRODUCER_REGS = 72, PAGED_CONSUMER_REGS = 216;
// a PAGED consumer thread's row data in shared memory (it holds no spare
// register at D 256): its rows' positions, their last visible pool slots,
// the item's pool tiles [lo, hi) that every live row sees whole, and its
// rows' ALiBi slopes (f32 bits)
constexpr int PAGED_ROW_INTS = 8;

// true unless every (row, col) of query tile [r0, r0 + BQ) x key tile
// [c0, c0 + BK) is in bounds and visible without a test
template <int BQ, int BK>
__device__ __forceinline__ bool tile_masked(const Params& p, int r0, int c0) {
  if (p.qseg != nullptr || r0 + BQ > p.Sq || c0 + BK > p.Sk) return true;
  const int row_first = p.q_off + r0, col_first = p.k_off + c0;
  if (p.causal && col_first + BK - 1 > row_first) return true;              // causal edge
  return p.window > 0 && row_first + BQ - 1 - col_first >= p.window;        // window edge
}

// the key tiles [lo, hi) that any row of query tile [r0, r0 + BQ) can see
template <int BQ, int BK>
__device__ __forceinline__ void key_range(const Params& p, int r0, int& lo, int& hi) {
  const int nk = (p.Sk + BK - 1) / BK;
  hi = nk;
  if (p.causal) {                                                 // col <= row
    const int c_last = p.q_off + min(r0 + BQ, p.Sq) - 1 - p.k_off;
    hi = c_last < 0 ? 0 : min(nk, c_last / BK + 1);
  }
  lo = 0;
  if (p.window > 0) {                                             // col > row - window
    const int c_first = p.q_off + r0 - p.window + 1 - p.k_off;
    lo = c_first <= 0 ? 0 : min(nk, c_first / BK);
  }
}

__device__ __forceinline__ size_t row_index(int b, int r, int h, int S, int H, int D) {
  return ((static_cast<size_t>(b) * S + r) * H + h) * D;
}

// where row r of item head h and batch b goes in out (PAGED: query row
// r = c G + g of kv head h is head h G + g of chunk row c)
template <int MODE>
__device__ __forceinline__ size_t out_index(const Params& p, int b, int r, int h, int D) {
  if (MODE == PAGED)
    return ((static_cast<size_t>(b) * p.C + r / p.G) * p.H * p.G + h * p.G + r % p.G) * D;
  return row_index(b, r, h, p.Sq, p.H, D);
}

// The block's Q (BQ rows), then a ring of K/V stages, EVO's pair-bias tiles,
// and the key tile's segment ids (EVO: its mask bias). Every tile offset is
// a multiple of 1024 bytes.
template <int D, Mode MODE = FLASH>
struct Layout {
  static constexpr int BQ = hopper::CONSUMERS * hopper::WG_ROWS;
  static constexpr bool B2_STAGED = MODE == EVO && D <= 128;  // pair bias by TMA
  // SPARSE gathers a stage from 16 boxes of 16 rows: a third stage keeps
  // more of them in flight
  static constexpr int STAGES = MODE == SPARSE ? 3 : hopper::STAGES;
  static constexpr int BK = D <= 128 && !(B2_STAGED && D == 128) ? 128 : 64;  // keys a stage
  static constexpr size_t q = 0;
  static constexpr size_t kv_tile = 2 * BK * D;        // bytes of one K or V tile
  static constexpr size_t stages = q + 2 * BQ * D;     // stage s: K, then V
  static constexpr size_t b2_tile = B2_STAGED ? BQ * BK * sizeof(float) : 0;
  static constexpr size_t b2 = stages + STAGES * 2 * kv_tile;
  static constexpr size_t seg = b2 + STAGES * b2_tile;
  static constexpr size_t bars = seg + STAGES * BK * sizeof(int);
  // PAGED: each consumer thread's row data for the current item
  static constexpr size_t rows = bars + (2 * STAGES + 2) * sizeof(uint64_t);
  static constexpr size_t bytes =
      rows + (MODE == PAGED ? hopper::CONSUMERS * hopper::WG * PAGED_ROW_INTS * sizeof(int) : 0) +
      1024;
};

// One work item: BQ query rows of one (batch, head) and the key tiles
// [lo, hi) they can see (SPARSE: the tables' stages). Items go longest
// first: the last query tiles, which see the most keys of a causal grid, of
// every (batch, head) pair, then the tiles before them (SPARSE: the query
// tiles with the most stages first).
struct Item {
  int r0, h, b, lo, hi;
  // PAGED: tiles [lo, pool_hi) are pool tiles (slots j BK ..), the rest the
  // chunk's rows ck_lo ..; live slots [slot_lo, slot_hi); the rows' least
  // and greatest live position (pmax < 0: none) and the pool's end
  int pool_hi, slot_lo, slot_hi, ck_lo, ck_hi, pmin, pmax, pool_end;
};

// PAGED: the item's key range from its rows' positions (see the header), by
// one whole warp (every lane gets it)
template <int BQ, int BK>
__device__ __forceinline__ void paged_range(const Params& p, Item& it) {
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int* pos = p.positions + static_cast<size_t>(it.b) * p.C;
  const int c0 = it.r0 / p.G, c1 = (min(it.r0 + BQ, p.Sq) - 1) / p.G;
  int pmin = 0x7fffffff, pmax = -1, cs = 0x7fffffff, cmax = -1;
  for (int c = lane; c < p.C; c += 32) {
    const int v = pos[c];
    if (v >= 0) {
      cs = min(cs, v);
      cmax = max(cmax, v);
      if (c >= c0 && c <= c1) {
        pmin = min(pmin, v);
        pmax = max(pmax, v);
      }
    }
  }
  for (int o = 16; o; o >>= 1) {
    pmin = min(pmin, __shfl_xor_sync(ALL, pmin, o));
    pmax = max(pmax, __shfl_xor_sync(ALL, pmax, o));
    cs = min(cs, __shfl_xor_sync(ALL, cs, o));
    cmax = max(cmax, __shfl_xor_sync(ALL, cmax, o));
  }
  it.pmin = pmin;
  it.pmax = pmax;
  it.lo = it.hi = it.pool_hi = it.slot_lo = it.slot_hi = it.ck_lo = it.ck_hi = 0;
  it.pool_end = 0;
  if (pmax < 0) return;  // padding only: dropped before any load
  it.pool_end = min(p.MB * p.bs, p.chunk_k != nullptr ? cs : cmax + 1);
  const int lo = p.window > 0 ? max(pmin - p.window + 1, 0) : 0;
  const int hi = min(it.pool_end, pmax + 1);
  it.slot_lo = lo;
  it.slot_hi = hi;
  it.lo = lo / BK;
  it.pool_hi = lo < hi ? (hi + BK - 1) / BK : it.lo;
  int klo = 0x7fffffff, khi = -1;
  if (p.chunk_k != nullptr)
    for (int c = lane; c < p.C; c += 32) {
      const int v = pos[c];
      if (v >= 0 && v <= pmax && v >= lo) {
        klo = min(klo, c);
        khi = max(khi, c);
      }
    }
  for (int o = 16; o; o >>= 1) {
    klo = min(klo, __shfl_xor_sync(ALL, klo, o));
    khi = max(khi, __shfl_xor_sync(ALL, khi, o));
  }
  it.ck_lo = khi >= 0 ? klo : 0;
  it.ck_hi = khi + 1;
  it.hi = it.pool_hi + (it.ck_hi - it.ck_lo + BK - 1) / BK;
}

template <int BQ, int BK, Mode MODE>
__device__ __forceinline__ Item item_at(const Params& p, int i) {
  const int nq = (p.Sq + BQ - 1) / BQ, hb = p.H * p.B;
  Item it;
  if constexpr (MODE == SPARSE) {
    const int qt = p.order[i / hb];
    it.r0 = qt * BQ;
    it.h = i % hb % p.H;
    it.b = i % hb / p.H;
    it.lo = p.stage_start[qt];
    it.hi = p.stage_start[qt + 1];
    return it;
  } else if constexpr (MODE == EVO) {  // MSA rows fastest: a block's run shares the pair bias
    const int rest = i / p.N;
    it.r0 = rest % nq * BQ;
    it.h = rest / nq % p.H;
    it.b = rest / nq / p.H * p.N + i % p.N;
  } else if constexpr (MODE == PAGED) {
    it.r0 = (nq - 1 - i / hb) * BQ;
    it.h = i % hb % p.H;
    it.b = i % hb / p.H;
    paged_range<BQ, BK>(p, it);
    return it;
  } else {
    it.r0 = (nq - 1 - i / hb) * BQ;
    it.h = i % hb % p.H;
    it.b = i % hb / p.H;
  }
  key_range<BQ, BK>(p, it.r0, it.lo, it.hi);
  return it;
}

// The item a block takes in round k: rounds alternate direction over the
// blocks (a serpentine), so that with items longest first every block's
// total stays within about one item of the others'.
__device__ __forceinline__ int item_index(int k) {
  return k * gridDim.x + (k % 2 == 0 ? blockIdx.x : gridDim.x - 1 - blockIdx.x);
}

// The block's k-th item, `items` past its last: RING and FLASH deal by
// item_index; SPARSE takes the block's run of the host's deal (a query tile
// of 32 stages beside ones of 2 leaves a serpentine's blocks far apart);
// EVO takes a contiguous run of equal items, whose neighbours share the
// pair-bias tiles
template <Mode MODE>
__device__ __forceinline__ int item_of(const Params& p, int k, int items) {
  if constexpr (MODE == SPARSE) {
    const int at = p.deal_start[blockIdx.x] + k;
    return at < p.deal_start[blockIdx.x + 1] ? p.deal[at] : items;
  } else if constexpr (MODE == EVO) {
    const long long i = static_cast<long long>(blockIdx.x) * items / gridDim.x + k;
    return i < static_cast<long long>(blockIdx.x + 1) * items / gridDim.x ? static_cast<int>(i)
                                                                            : items;
  } else {
    return item_index(k);
  }
}

// this thread's N / 2 values of accumulator row U (elements 4 k + 2 U +
// {0, 1}) reduced by `op` into four independent partials, then those: short
// dependency chains for the element pass, where one warp a scheduler issues
template <int U, int N, typename Op>
__device__ __forceinline__ float row_reduce(const float (&s)[N], Op op) {
  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = op(s[4 * i + 2 * U], s[4 * i + 2 * U + 1]);
#pragma unroll
  for (int k = 4; k < N / 4; ++k) a[k % 4] = op(a[k % 4], op(s[4 * k + 2 * U], s[4 * k + 2 * U + 1]));
  return op(op(a[0], a[1]), op(a[2], a[3]));
}

// D / 64 column blocks of `rows` rows of head `head` of item batch b: EVO
// reads (D, H, S, N, B) maps at (n, b) = (b % N, b / N)
template <int D, Mode MODE>
__device__ __forceinline__ void item_rows(const Params& p, __nv_bfloat16* dst,
                                          const CUtensorMap* map, uint64_t* bar, int rows,
                                          int head, int row0, int b) {
  if constexpr (MODE == EVO)
    hopper::tma_rows5<D>(dst, map, bar, rows, head, row0, b % p.N, b / p.N);
  else
    hopper::tma_rows<D>(dst, map, bar, rows, head, row0, b);
}

// byte offset of element (row r, column col; col a multiple of 8) in a
// 128-byte-swizzled tile of ROWS rows (what a TMA box writes there)
template <int ROWS>
__device__ __forceinline__ uint32_t swizzled(int r, int col) {
  return (col / 64) * (ROWS * 128) + r * 128 + ((((col % 64) / 8) ^ (r % 8)) * 16);
}

// PAGED: the item's Q rows r0 .. r0 + BQ - 1 (row r = c G + g of kv head h)
// gathered by the producer warp's cp.async into the swizzled tile, pad rows
// and rows past Sq zero; completes `bar` (count 1)
template <int D, int BQ>
__device__ __forceinline__ void paged_q(const Params& p, const Item& it, bf16* Qs, uint64_t* bar) {
  using namespace hopper;
  constexpr int CH = D / 8;  // 16-byte pieces a row
  const int lane = threadIdx.x % 32;
  const int* pos = p.positions + static_cast<size_t>(it.b) * p.C;
  const uint32_t base = smem_addr(Qs);
  for (int r = lane; r < BQ; r += 32) {  // a row a lane: its address once
    const int row = it.r0 + r;
    const bool live = row < p.Sq && pos[row / p.G] >= 0;
    const bf16* src = p.q + (live ? ((static_cast<size_t>(it.b) * p.C + row / p.G) * p.H * p.G +
                                     it.h * p.G + row % p.G) * D
                                  : 0);
#pragma unroll 2
    for (int ch = 0; ch < CH; ++ch)
      cp_async_16(base + swizzled<BQ>(r, ch * 8), src + ch * 8, live ? 16u : 0u);
  }
  cp_async_mbar_arrive(bar);
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// PAGED: key tile j of the item into stage K (then V) of BK rows, by the
// producer warp, completing `bar` (32 arrivals): a pool tile wholly inside
// the live slots by TMA, page by page (boxes of min(bs, BK) slots); any
// other tile by cp.async, dead rows zero-filled, with its keys' positions
// in `kpos` (-1 dead) for the pass
template <int D, int BK>
__device__ __forceinline__ void paged_tile(const Params& p, const Item& it, int j, bf16* Ks,
                                           int* kpos, uint64_t* bar, const CUtensorMap* tk,
                                           const CUtensorMap* tv) {
  using namespace hopper;
  constexpr int CH = D / 8;
  const int lane = threadIdx.x % 32;
  const bool pool = j < it.pool_hi;
  const int c0 = j * BK;
  if (pool && c0 >= it.slot_lo && c0 + BK <= it.slot_hi) {
    if (lane == 0) {
      const int* bt = p.tables + static_cast<size_t>(it.b) * p.MB;
      const int box = p.bs < BK ? p.bs : BK;
      mbar_arrive_expect_tx(bar, 2 * BK * D * 2);
      for (int k0 = 0; k0 < BK; k0 += box) {
        const int slot = c0 + k0, page = bt[slot / p.bs];
#pragma unroll 1
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load_5d(Ks + cb * BK * 64 + k0 * 64, tk, bar, cb * 64, slot % p.bs, page, it.h,
                      p.layer);
          tma_load_5d(Ks + BK * D + cb * BK * 64 + k0 * 64, tv, bar, cb * 64, slot % p.bs, page,
                      it.h, p.layer);
        }
      }
    } else {
      mbar_arrive(bar);
    }
    return;
  }
  const int* pos = p.positions + static_cast<size_t>(it.b) * p.C;
  const int* bt = p.tables + static_cast<size_t>(it.b) * p.MB;
  const size_t head = (static_cast<size_t>(p.layer) * p.KVH + it.h) * p.NB;
  const int ck0 = it.ck_lo + (j - it.pool_hi) * BK;
  if (!pool)
    for (int r = lane; r < BK; r += 32) kpos[r] = ck0 + r < it.ck_hi ? pos[ck0 + r] : -1;
  const uint32_t kt = smem_addr(Ks), vt = kt + BK * D * 2;
  for (int r = lane; r < BK; r += 32) {  // a row a lane: its address once
    bool live;
    size_t off = 0;
    if (pool) {
      const int slot = c0 + r;
      live = slot >= it.slot_lo && slot < it.slot_hi;
      if (live) off = ((head + bt[slot / p.bs]) * p.bs + slot % p.bs) * D;
    } else {
      const int c = ck0 + r;
      live = c < it.ck_hi && pos[c] >= 0;
      if (live) off = ((static_cast<size_t>(it.b) * p.C + c) * p.KVH + it.h) * D;
    }
    const bf16* ksrc = (pool ? p.k : p.chunk_k) + off;
    const bf16* vsrc = (pool ? p.v : p.chunk_v) + off;
#pragma unroll 2
    for (int ch = 0; ch < CH; ++ch) {
      const uint32_t dst = swizzled<BK>(r, ch * 8);
      cp_async_16(kt + dst, ksrc + ch * 8, live ? 16u : 0u);
      cp_async_16(vt + dst, vsrc + ch * 8, live ? 16u : 0u);
    }
  }
  cp_async_mbar_arrive(bar);
  mbar_arrive(bar);
}

// The forward; the __global__ kernels of ring_flash.cu, flash_attention.cu,
// sparse_flash.cu and evoformer_flash.cu are this function for their mode
// (tb: EVO's pair-bias map). Persistent: each block takes one item a round
// (item_index), so that the producer loads the next item's Q and first K/V
// tiles while the consumers finish the current one.
template <int D, Mode MODE>
__device__ __forceinline__ void forward(const Params& p, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv,
                                        const CUtensorMap* tb = nullptr) {
  using namespace hopper;
  using SM = Layout<D, MODE>;
  constexpr int BQ = SM::BQ, BK = SM::BK;
  constexpr int NB = D < 128 ? D : 128;  // output columns of one P V product
  constexpr int NH = D / NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q);
  int* ksegs = reinterpret_cast<int*>(smem + SM::seg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::bars);
  uint64_t* empty = full + SM::STAGES;
  uint64_t* q_full = empty + SM::STAGES;  // Q of the current item has landed
  uint64_t* q_empty = q_full + 1;     // the consumers are done with it
  const int items = (p.Sq + BQ - 1) / BQ * p.H * p.B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SM::STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS * WG);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS * WG);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {  // ------------------------------------- producer
    regs_dec<MODE == PAGED ? PAGED_PRODUCER_REGS : PRODUCER_REGS>();
    if (threadIdx.x % WG >= 32) return;
    const int lane = threadIdx.x % 32;
    StageRing<SM::STAGES> ring;
    uint32_t q_phase = 0;
    int b2_held0 = -1, b2_held1 = -1;  // EVO: the pair-bias tile stage 0, 1 holds
    for (int k = 0, i = item_of<MODE>(p, 0, items); i < items; i = item_of<MODE>(p, ++k, items)) {
      const Item it = item_at<BQ, BK, MODE>(p, i);
      if (it.lo >= it.hi) continue;  // no key to load (RING: the carry stays)
      const int kh = it.h / (p.H / p.KVH);
      mbar_wait(q_empty, q_phase ^ 1);
      if constexpr (MODE == PAGED) {
        paged_q<D, BQ>(p, it, Qs, q_full);
      } else if (lane == 0) {
        mbar_arrive_expect_tx(q_full, 2 * BQ * D);
        item_rows<D, MODE>(p, Qs, tq, q_full, BQ, it.h, it.r0, it.b);
      }
      q_phase ^= 1;
      const int* ksegb = p.kseg != nullptr ? p.kseg + static_cast<size_t>(it.b) * p.Sk : nullptr;
      for (int j = it.lo; j < it.hi; ++j, ring.next()) {
        mbar_wait(&empty[ring.s], ring.phase ^ 1);
        const int c0 = j * BK;
        if constexpr (MODE == SPARSE) {
          // the stage's 8 key blocks: a lane a 16-row box of K or V (column
          // block lane / 16); padding slots load nothing, and their V rows
          // become 0 so that p = 0 never meets a stale NaN
          bf16* Ks = reinterpret_cast<bf16*>(smem + SM::stages + ring.s * 2 * SM::kv_tile);
          const int slot = lane % 8, blk = p.kblocks[static_cast<size_t>(j) * 8 + slot];
          const unsigned pad = __ballot_sync(0xffffffffu, blk < 0) & 0xffu;
          for (unsigned m = pad; m != 0; m &= m - 1) {
            const int ps = __ffs(m) - 1;
#pragma unroll
            for (int cb = 0; cb < D / 64; ++cb) {
              uint4* rows = reinterpret_cast<uint4*>(Ks + BK * D + cb * BK * 64 + ps * 16 * 64);
              for (int x = lane; x < 16 * 8; x += 32) rows[x] = make_uint4(0, 0, 0, 0);
            }
          }
          if (pad != 0) fence_proxy_async();  // before the arrive, for wgmma's reads
          const int kv = lane / 8 % 2, cb = lane / 16;
          if (cb < D / 64 && blk >= 0) {
            mbar_arrive_expect_tx(&full[ring.s], 16 * 128);
            tma_load_4d(Ks + kv * BK * D + cb * BK * 64 + slot * 16 * 64, kv ? tv : tk,
                        &full[ring.s], cb * 64, kh, blk * 16, it.b);
          } else {
            mbar_arrive(&full[ring.s]);
          }
        } else if constexpr (MODE == EVO) {
          // the mask bias's slice for the pass (stores), then K, V and the
          // pair bias's BQ x BK tile (32-column boxes) by TMA, unless the
          // stage holds that tile already (the previous item's same stage,
          // another MSA row)
          float* b1 = reinterpret_cast<float*>(ksegs) + ring.s * BK;
          if (p.b1 != nullptr)
            for (int c = lane; c < BK; c += 32) b1[c] = p.b1[static_cast<size_t>(it.b) * p.Sk + c0 + c];
          const int tile = ((it.b / p.N * p.H + it.h) * (p.Sq / BQ) + it.r0 / BQ) * (p.Sk / BK) + j;
          const bool b2 = SM::B2_STAGED && p.b2 != nullptr &&
                          (ring.s == 0 ? b2_held0 : b2_held1) != tile;
          if (b2 && ring.s == 0) b2_held0 = tile;
          if (b2 && ring.s != 0) b2_held1 = tile;
          if (lane == 0) {
            bf16* Ks = reinterpret_cast<bf16*>(smem + SM::stages + ring.s * 2 * SM::kv_tile);
            mbar_arrive_expect_tx(&full[ring.s], 2 * SM::kv_tile + (b2 ? SM::b2_tile : 0));
            item_rows<D, MODE>(p, Ks, tk, &full[ring.s], BK, kh, c0, it.b);
            item_rows<D, MODE>(p, Ks + BK * D, tv, &full[ring.s], BK, kh, c0, it.b);
            float* b2s = reinterpret_cast<float*>(smem + SM::b2 + ring.s * SM::b2_tile);
            if (b2)
              for (int c = 0; c < BK / 32; ++c)
                tma_load_4d(b2s + c * BQ * 32, tb, &full[ring.s], c0 + 32 * c, it.r0, it.h,
                            it.b / p.N);
          } else {
            mbar_arrive(&full[ring.s]);
          }
        } else if constexpr (MODE == PAGED) {
          paged_tile<D, BK>(p, it, j,
                            reinterpret_cast<bf16*>(smem + SM::stages + ring.s * 2 * SM::kv_tile),
                            ksegs + ring.s * BK, &full[ring.s], tk, tv);
        } else {
          int* kseg = ksegs + ring.s * BK;
          for (int c = lane; c < BK; c += 32)
            kseg[c] = ksegb != nullptr && c0 + c < p.Sk ? ksegb[c0 + c] : 0;
          if (lane == 0) {
            bf16* Ks = reinterpret_cast<bf16*>(smem + SM::stages + ring.s * 2 * SM::kv_tile);
            mbar_arrive_expect_tx(&full[ring.s], 2 * SM::kv_tile);
            tma_rows<D>(Ks, tk, &full[ring.s], BK, kh, c0, it.b);
            tma_rows<D>(Ks + BK * D, tv, &full[ring.s], BK, kh, c0, it.b);
          } else {
            mbar_arrive(&full[ring.s]);
          }
        }
      }
    }
    if constexpr (MODE == PAGED) cp_async_wait_all();
  } else {  // ---------------------------------------------------- consumers
    regs_inc<MODE == PAGED ? PAGED_CONSUMER_REGS : CONSUMER_REGS>();
    const int t = threadIdx.x % WG, lane = t % 32;
    const uint32_t q_tile = smem_addr(Qs) + wg * WG_ROWS * 128;
    const int own = 1 + wg, other = 2 - wg;  // the pass turns' named barriers
    if (wg == 1) named_arrive<CONSUMERS * WG>(1);  // warpgroup 0 takes the first turn
    StageRing<SM::STAGES> ring;
    uint32_t q_phase = 0;
    // EVO's pair bias in this thread's fragment order: its two rows' offsets
    // in a staged tile (floats) and, for each 8-column group c % 4 of a
    // 32-column box, the swizzled chunk's offset (chunk 2 c + (lane % 4) / 2
    // at chunk ^ (row % 8), row % 8 = lane / 4)
    const int rt = wg * WG_ROWS + (t / 32) * 16 + lane / 4;  // the item's rows rt, rt + 8
    int b2_col[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b2_col[c] = ((2 * c) ^ ((lane % 4) / 2) ^ (lane / 4)) * 4 + 2 * (lane % 2);
    for (int k = 0, i = item_of<MODE>(p, 0, items); i < items; i = item_of<MODE>(p, ++k, items)) {
      const Item it = item_at<BQ, BK, MODE>(p, i);
      if (MODE == RING && it.lo >= it.hi) continue;  // no row sees this shard
      const int r0 = it.r0, h = it.h, b = it.b;
      const int ra = r0 + wg * WG_ROWS + (t / 32) * 16 + lane / 4;  // rows ra, ra + 8
      const size_t roff = (static_cast<size_t>(b) * p.H + h) * p.Sq;
      float m[2], l[2];  // the row max (natural log) and this thread's share of l
      int qseg[2];
      float o[NH][NB / 2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = ra + 8 * u;
        const bool in = r < p.Sq;
        qseg[u] = (MODE == RING || MODE == FLASH) && in && p.qseg != nullptr
                      ? p.qseg[static_cast<size_t>(b) * p.Sq + r]
                      : 0;
        m[u] = MODE == RING && in ? p.m[roff + r] : MODE == EVO ? -1e30f : -INFINITY;
        l[u] = MODE == RING && in && lane % 4 == 0 ? p.l[roff + r] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < NB / 2; e += 2) {
          const int r = ra + 8 * ((e / 2) % 2), d = n * NB + 8 * (e / 4) + 2 * (lane % 4);
          float2 a = make_float2(0.f, 0.f);
          if (MODE == RING && r < p.Sq)
            a = *reinterpret_cast<const float2*>(p.acc + row_index(b, r, h, p.Sq, p.H, D) + d);
          o[n][e] = a.x;
          o[n][e + 1] = a.y;
        }
      const float slope =
          (MODE == RING || MODE == FLASH) && p.slopes != nullptr ? p.slopes[h] : 0.f;
      // PAGED: rows ra, ra + 8 are query rows c G + g of kv head h: their
      // positions (-1: a pad row or past Sq) and last visible pool slots,
      // and the pool tiles [lo, hi) that every live row of the item sees
      // whole, in this thread's slot of shared memory
      int* rowdata = reinterpret_cast<int*>(smem + SM::rows) + (wg * WG + t) * PAGED_ROW_INTS;
      if constexpr (MODE == PAGED) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = ra + 8 * u;
          const int pr = r < p.Sq ? p.positions[static_cast<size_t>(b) * p.C + r / p.G] : -1;
          rowdata[u] = pr;
          rowdata[2 + u] = min(pr, it.pool_end - 1);
          const float slope = p.slopes != nullptr && r < p.Sq ? p.slopes[h * p.G + r % p.G] : 0.f;
          rowdata[6 + u] = __float_as_int(slope);
        }
        const int first = max(it.slot_lo, p.window > 0 ? it.pmax - p.window + 1 : 0);
        rowdata[4] = (first + BK - 1) / BK;
        rowdata[5] = (min(it.pmin, it.pool_end - 1) + 1) / BK;
      }

      if (it.lo < it.hi) {
        mbar_wait(q_full, q_phase);
        q_phase ^= 1;
        if constexpr (MODE == PAGED) fence_proxy_async();  // Q came by cp.async
        if constexpr (MODE == EVO) {
          // this warpgroup's Q rows times bf16(scale), in place, before the
          // first product reads them through the async proxy
          const __nv_bfloat162 sc = __float2bfloat162_rn(p.scale);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb) {
            uint4* rows = reinterpret_cast<uint4*>(Qs + cb * BQ * 64 + wg * WG_ROWS * 64);
#pragma unroll
            for (int x = t; x < WG_ROWS * 8; x += WG) {
              uint4 v = rows[x];
              __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(h2[e]), g = __bfloat1622float2(sc);
                h2[e] = __floats2bfloat162_rn(f.x * g.x, f.y * g.y);
              }
              rows[x] = v;
            }
          }
          fence_proxy_async();
          named_sync<WG>(3 + wg);
        }
      }
      // The key range and the masked-tile test are the block's, so every
      // branch is uniform over the block; a warpgroup's rows that see nothing
      // of a tile keep their state exactly (alpha = 1, p = 0).
      for (int j = it.lo; j < it.hi; ++j, ring.next()) {
        mbar_wait(&full[ring.s], ring.phase);
        if constexpr (MODE == PAGED) fence_proxy_async();  // a tile by cp.async
        const int c0 = j * BK;
        const uint32_t k_tile = smem_addr(smem + SM::stages + ring.s * 2 * SM::kv_tile);
        const uint32_t v_tile = k_tile + SM::kv_tile;
        const int* kseg = ksegs + ring.s * BK;
        // SPARSE: this thread's two rows of the stage's mask, read while S is
        // in flight and shifted to its first column, so that the pass tests
        // each bit by a constant
        uint32_t words[2][4];
        bool dense_stage = false;
        if constexpr (MODE == SPARSE) {
          dense_stage = p.kfull[j] != 0;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint4 w = p.kmask[static_cast<size_t>(j) * BQ + rt + 8 * u];
            words[u][0] = w.x >> 2 * (lane % 4);
            words[u][1] = w.y >> 2 * (lane % 4);
            words[u][2] = w.z >> 2 * (lane % 4);
            words[u][3] = w.w >> 2 * (lane % 4);
          }
        }
        // S = Q K^T over the whole key tile
        float s[BK / 2];  // written whole by the first product (scale-d 0)
        // PAGED, a chunk tile: the product starts from each key's mask and
        // ALiBi bias for this thread's rows (-inf where the row may not see
        // the key, slope (key pos - pos) / scale where it may), so that no
        // key position is held beside S and O in the pass (the consumers
        // have 216 registers, not 240)
        const bool chunk_tile = MODE == PAGED && j >= it.pool_hi;
        if constexpr (MODE == PAGED) {
          if (chunk_tile) {
            const float inv_scale = 1.f / p.scale;
#pragma unroll
            for (int e = 0; e < BK / 2; ++e) {
              const int u = (e / 2) % 2, pr = rowdata[u];
              const int kp = kseg[8 * (e / 4) + e % 2 + 2 * (lane % 4)];
              const bool vis = kp >= 0 && kp <= pr && (p.window <= 0 || kp > pr - p.window);
              s[e] = vis ? __int_as_float(rowdata[6 + u]) * static_cast<float>(kp - pr) * inv_scale
                         : -INFINITY;
            }
          }
        }
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          Wgmma<BK>::template ss<0>(s, desc_k_major(q_tile, BQ, k), desc_k_major(k_tile, BK, k),
                                    k > 0 || chunk_tile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (j + 1 == it.hi) mbar_arrive(q_empty);  // Q is free for the next item

        // the element pass, branch-free: s becomes p in place. Only tiles at a
        // mask's edge test visibility, and there as limits on the element's
        // column offset ce = 8 (e / 4) + e % 2 from this thread's first column
        // (col - row = pos0 + ce - 8 u): in bounds and causal iff ce <= hi[u],
        // in the window iff ce > lo[u]; segment ids are compared in their own
        // instantiation
        float alpha[2];
        const int pos0 = p.k_off + c0 + 2 * (lane % 4) - (p.q_off + ra);  // col - row of s[0]
        int lim_hi[2], lim_lo[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          lim_hi[u] = min(p.Sk - c0 - 2 * (lane % 4) - 1, p.causal ? 8 * u - pos0 : p.Sk);
          if (ra + 8 * u >= p.Sq) lim_hi[u] = -1;                            // a row past Sq
          lim_lo[u] = p.window > 0 ? 8 * u - pos0 - p.window : -1;
        }
        // the pass's second half, on the logits in s: the row max over the
        // quad, alpha, p in place of s, l (`masked`: masked logits are -inf)
        auto softmax = [&](auto masked) {
          const auto max_op = [](float a, float b) { return fmaxf(a, b); };
          const auto add_op = [](float a, float b) { return a + b; };
          const float row_max[2] = {row_reduce<0>(s, max_op), row_reduce<1>(s, max_op)};
          float m2[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float mx = fmaxf(m[u], row_max[u]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            // an unchanged max keeps the state exactly (also -inf against -inf)
            alpha[u] = mx == m[u] ? 1.f : exp2_approx((m[u] - mx) * LOG2E);
            m2[u] = mx * LOG2E;
            m[u] = mx;
          }
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            const float x = exp2_approx(fmaf(s[e], LOG2E, -m2[(e / 2) % 2]));
            s[e] = decltype(masked)::value && s[e] == -INFINITY ? 0.f : x;
          }
          l[0] = fmaf(l[0], alpha[0], row_reduce<0>(s, add_op));
          l[1] = fmaf(l[1], alpha[1], row_reduce<1>(s, add_op));
        };
        auto pass = [&](auto masked, auto segments, auto alibi) {
          const float base[2] = {static_cast<float>(pos0), static_cast<float>(pos0 - 8)};
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            const int u = (e / 2) % 2, ce = 8 * (e / 4) + e % 2;
            float x = s[e];
            if constexpr (decltype(alibi)::value)
              x = fmaf(slope, base[u] + static_cast<float>(ce), x);
            if constexpr (decltype(masked)::value) {
              bool vis = ce <= lim_hi[u] && ce > lim_lo[u];
              if constexpr (decltype(segments)::value) vis = vis && qseg[u] == kseg[ce + 2 * (lane % 4)];
              x = vis ? x : -INFINITY;
            }
            s[e] = x;
          }
          softmax(masked);
        };
        // SPARSE and EVO form their logits before their turn (the other
        // warpgroup's pass runs meanwhile), and take the turn for the softmax
        // alone. SPARSE: the scale in f32, then the stage's mask (bit
        // 8 (e / 4 % 4) + e % 2 of word e / 16 after the shift)
        auto sparse_logits = [&](auto masked) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            float x = s[e] * p.scale;
            if constexpr (decltype(masked)::value)
              x = (words[(e / 2) % 2][e / 16] >> (8 * (e / 4 % 4) + e % 2)) & 1u ? x : -INFINITY;
            s[e] = x;
          }
        };
        // EVO: s + b1[c] + b2[r, c]; b1 from the stage's slice, b2 from its
        // staged tile (D 64, 128) or from L2 (D 256); -inf logits give p = 0
        // against m >= -1e30, so no instantiation masks
        auto evo_logits = [&](auto has_b1, auto has_b2) {
          const float* b1s = reinterpret_cast<const float*>(kseg) + 2 * (lane % 4);
          const float* b2s = nullptr;  // the staged tile, or this thread's first element in L2
          if constexpr (decltype(has_b2)::value && SM::B2_STAGED)
            b2s = reinterpret_cast<const float*>(smem + SM::b2 + ring.s * SM::b2_tile);
          else if constexpr (decltype(has_b2)::value)
            b2s = p.b2 + ((static_cast<size_t>(b / p.N) * p.H + h) * p.Sq + r0 + rt) * p.Sk + c0 +
                  2 * (lane % 4);
          // every load issued before the first add: the pass's latency is
          // one load's, not one a pair
          float2 a1[BK / 8], a2[BK / 4];
#pragma unroll
          for (int e = 0; e < BK / 2; e += 2) {
            const int u = (e / 2) % 2, ce = 8 * (e / 4);
            if constexpr (decltype(has_b1)::value)
              if (u == 0) a1[e / 4] = *reinterpret_cast<const float2*>(b1s + ce);
            if constexpr (decltype(has_b2)::value && SM::B2_STAGED)
              a2[e / 2] = *reinterpret_cast<const float2*>(b2s + (e / 16) * BQ * 32 +
                                                           (rt + 8 * u) * 32 + b2_col[e / 4 % 4]);
            else if constexpr (decltype(has_b2)::value)
              a2[e / 2] = __ldg(reinterpret_cast<const float2*>(b2s + static_cast<size_t>(8 * u) * p.Sk + ce));
          }
#pragma unroll
          for (int e = 0; e < BK / 2; e += 2) {
            float2 x = make_float2(s[e], s[e + 1]);
            if constexpr (decltype(has_b1)::value) {
              x.x += a1[e / 4].x;
              x.y += a1[e / 4].y;
            }
            if constexpr (decltype(has_b2)::value) {
              x.x += a2[e / 2].x;
              x.y += a2[e / 2].y;
            }
            s[e] = x.x;
            s[e + 1] = x.y;
          }
        };
        if constexpr (MODE == SPARSE) {
          if (dense_stage)
            sparse_logits(std::false_type{});
          else
            sparse_logits(std::true_type{});
        } else if constexpr (MODE == EVO) {
          if (p.b1 != nullptr && p.b2 != nullptr)
            evo_logits(std::true_type{}, std::true_type{});
          else if (p.b1 != nullptr)
            evo_logits(std::true_type{}, std::false_type{});
          else if (p.b2 != nullptr)
            evo_logits(std::false_type{}, std::true_type{});
        }
        // the instantiation this tile needs: masks only at a mask's edge,
        // segment ids and ALiBi only when given (all uniform over the block)
        // PAGED: kind 0 every key visible to every live row, 1 a pool tile at a
        // row's slot limit (slot in [pos - window + 1, min(pos, pool end - 1)]),
        // 2 a chunk tile (mask and ALiBi came with the product); a pad row's
        // logits stay finite (its q is 0) and its output is 0
        auto paged_pass = [&](auto kind, auto alibi, auto capped) {
          constexpr int KIND = decltype(kind)::value;
          const int col0 = c0 + 2 * (lane % 4);  // this thread's first slot of a pool tile
          int prow[2], hi_lim[2], lo_lim[2];
          float pslope[2] = {0.f, 0.f};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            prow[u] = rowdata[u];
            hi_lim[u] = rowdata[2 + u] - col0;
            lo_lim[u] = p.window > 0 ? prow[u] - p.window + 1 - col0 : -(1 << 30);
            if constexpr (decltype(alibi)::value) pslope[u] = __int_as_float(rowdata[6 + u]);
          }
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            const int u = (e / 2) % 2, ce = 8 * (e / 4) + e % 2;  // ce: slot offset from col0
            float x = s[e] * p.scale;
            if constexpr (KIND == 2) {
              if constexpr (decltype(capped)::value)
                x = x == -INFINITY ? x : softcap_tanh(x, p.softcap);
            } else {
              if constexpr (decltype(alibi)::value)
                x = fmaf(pslope[u], static_cast<float>(col0 + ce - prow[u]), x);
              if constexpr (decltype(capped)::value) x = softcap_tanh(x, p.softcap);
              if constexpr (KIND == 1) x = ce <= hi_lim[u] && ce >= lo_lim[u] ? x : -INFINITY;
            }
            s[e] = x;
          }
          softmax(std::integral_constant<bool, KIND != 0>{});
        };
        // block-uniform: a chunk tile, or a pool tile some live row does not see whole
        auto paged_run = [&](auto kind) {
          if (p.slopes != nullptr) {
            if (p.softcap != 0.f)
              paged_pass(kind, std::true_type{}, std::true_type{});
            else
              paged_pass(kind, std::true_type{}, std::false_type{});
          } else if (p.softcap != 0.f) {
            paged_pass(kind, std::false_type{}, std::true_type{});
          } else {
            paged_pass(kind, std::false_type{}, std::false_type{});
          }
        };
        auto run = [&](auto alibi) {
          if constexpr (MODE == PAGED) {
            if (j >= it.pool_hi)
              paged_run(std::integral_constant<int, 2>{});
            else if (j < rowdata[4] || j >= rowdata[5])
              paged_run(std::integral_constant<int, 1>{});
            else
              paged_run(std::integral_constant<int, 0>{});
          } else if constexpr (MODE == SPARSE) {
            if (dense_stage)
              softmax(std::false_type{});
            else
              softmax(std::true_type{});
          } else if constexpr (MODE == EVO) {
            softmax(std::false_type{});
          } else if (!tile_masked<BQ, BK>(p, r0, c0)) {
            pass(std::false_type{}, std::false_type{}, alibi);
          } else if (p.qseg == nullptr) {
            pass(std::true_type{}, std::false_type{}, alibi);
          } else {
            pass(std::true_type{}, std::true_type{}, alibi);
          }
        };
        // one warpgroup at a time in its pass (named barriers 1 and 2,
        // warpgroup 0 first): the special function unit serves it alone
        // while the other warpgroup's products run
        named_sync<CONSUMERS * WG>(own);
        if (slope == 0.f)
          run(std::false_type{});
        else
          run(std::true_type{});
        named_arrive<CONSUMERS * WG>(other);

        // O = O alpha + bf16(P) V: A from registers, V read MN-major
        uint32_t pk[BK / 4];
#pragma unroll
        for (int e = 0; e < BK / 4; ++e) pk[e] = pack_bf16(s[2 * e], s[2 * e + 1]);
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int e = 0; e < NB / 2; ++e) o[n][e] *= alpha[(e / 2) % 2];
        fence_regs(pk);
#pragma unroll
        for (int n = 0; n < NH; ++n) fence_regs(o[n]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          uint32_t a[4];
          a_fragment(a, pk, k);
#pragma unroll
          for (int n = 0; n < NH; ++n)
            Wgmma<NB>::template rs<1>(o[n], a,
                                      desc_mn_major(v_tile + n * (NB / 64) * BK * 128, BK, k));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pk);  // the A operand stays put until the product is done
#pragma unroll
        for (int n = 0; n < NH; ++n) fence_regs(o[n]);
        mbar_arrive(&empty[ring.s]);
      }

      // l across the quad of threads that holds a row, then the item's rows
      // out: each item is one block's alone, no atomics
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
      }
      if constexpr (MODE == RING) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = ra + 8 * u;
          if (r < p.Sq && lane % 4 == 0) {
            p.m[roff + r] = m[u];
            p.l[roff + r] = l[u];
          }
        }
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int e = 0; e < NB / 2; e += 2) {
            const int r = ra + 8 * ((e / 2) % 2), d = n * NB + 8 * (e / 4) + 2 * (lane % 4);
            if (r < p.Sq)
              *reinterpret_cast<float2*>(p.acc + row_index(b, r, h, p.Sq, p.H, D) + d) =
                  make_float2(o[n][e], o[n][e + 1]);
          }
      } else {
        float inv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = ra + 8 * u;
          inv[u] = l[u] > 0.f ? 1.f / l[u] : 0.f;
          if (MODE == PAGED && rowdata[u] < 0) inv[u] = 0.f;  // a pad row outputs 0
          // a row with no visible key gets +inf, so the backward's exp(s - lse) is 0
          if (MODE == FLASH && r < p.Sq && lane % 4 == 0)
            p.lse_out[roff + r] = l[u] > 0.f ? m[u] + logf(l[u]) : INFINITY;
        }
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int e = 0; e < NB / 2; e += 2) {
            const int u = (e / 2) % 2, r = ra + 8 * u;
            const int d = n * NB + 8 * (e / 4) + 2 * (lane % 4);
            if (r < p.Sq)
              *reinterpret_cast<__nv_bfloat162*>(p.out + out_index<MODE>(p, b, r, h, D) + d) =
                  __floats2bfloat162_rn(o[n][e] * inv[u], o[n][e + 1] * inv[u]);
          }
      }
    }
    // warpgroup 1 arrived once more than warpgroup 0 waited: take it
    if (wg == 0) named_sync<CONSUMERS * WG>(own);
  }
}

// The launch of `kernel` (the forward of MODE) on params p (p.B set) and its
// tensor maps: one persistent block per SM, or one per item when there are
// fewer.
template <int D, Mode MODE, typename Kernel, typename... Maps>
cudaError_t launch_items(Kernel kernel, const Params& p, cudaStream_t stream,
                         const Maps&... maps) {
  using SM = Layout<D, MODE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SM::bytes));
  if (e != cudaSuccess) return e;
  int device, sms;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  const long long items = static_cast<long long>((p.Sq + SM::BQ - 1) / SM::BQ) * p.H * p.B;
  if (items <= 0 || items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(p.blocks > 0 ? p.blocks : items < sms ? items : sms);
  kernel<<<blocks, hopper::WG_THREADS, SM::bytes, stream>>>(p, maps...);
  return cudaGetLastError();
}

// The tensor maps of q (BQ-row boxes), k and v (BK-row boxes) from their own
// strides, then the launch (RING, FLASH)
template <int D, typename Kernel>
cudaError_t launch(Kernel kernel, const Params& params, int B, cudaStream_t stream) {
  using SM = Layout<D>;
  Params p = params;
  p.B = B;
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = hopper::rows_map(&tq, p.q, D, p.H, p.Sq, B, p.qsr, p.qsb, SM::BQ)) != cudaSuccess ||
      (e = hopper::rows_map(&tk, p.k, D, p.KVH, p.Sk, B, p.ksr, p.ksb, SM::BK)) != cudaSuccess ||
      (e = hopper::rows_map(&tv, p.v, D, p.KVH, p.Sk, B, p.vsr, p.vsb, SM::BK)) != cudaSuccess)
    return e;
  return launch_items<D, FLASH>(kernel, p, stream, tq, tk, tv);
}

}  // namespace flash_fwd
