// The attention backward for Hopper (sm_90a): two wgmma mainloops (dq; dk
// and dv) with register accumulators, fed by TMA, each shared by two kernels.
//
// Replaces four TPU kernels that compute the same backward:
//   K14 deepspeed_tpu/sequence/ring_flash.py _ring_dq_kernel and K15
//       _ring_dkv_kernel (one ring step at global offsets, always causal,
//       added into f32 accumulators) -> ring_flash.cu ring_dq_wgmma and
//       ring_dkv_wgmma, mode RING;
//   K4  deepspeed_tpu/ops/pallas/flash_attention.py _dq_kernel and K5
//       _dkv_kernel (offset 0, causal or not, bf16 results) ->
//       flash_attention.cu flash_dq_wgmma and flash_dkv_wgmma, mode FLASH.
// Per query row r and key column c of one (batch, head), with q already
// scaled and global positions row = q_off + r, col = k_off + c:
//   s = q . k + slope[h] * (col - row)   (slope 0 without ALiBi)
//   visible iff r < Sq, c < Sk, (!CAUSAL || row >= col), (window <= 0 ||
//   row - col < window), and qseg[r] == kseg[c] with segment ids;
//   p = exp(s - lse) on visible pairs and exactly 0 on the rest (lse in
//   natural log, log2 e folded in for ex2), dp = do . v, ds = p (dp - delta)
//   rounded to bf16, with the wrapper's delta = sum(do * out) per row;
//   dq = ds k, dk = ds^T q, dv = bf16(p)^T do, dk and dv summed over the
//   G = H / KVH query heads of their group.
// RING adds each block's dq, dk, dv into the f32 accumulators it is given
// (the TPU kernels return one step's values and XLA adds them outside);
// FLASH writes bf16 dq (B, S, H, D) and dk, dv (B, S, KVH, D) once. Either
// way the block that owns the rows writes them: no atomics, a fixed order,
// the same bits on every run and across the four-card ring.
//
// What bounds it on this card: 6 D (dq) and 8 D (dk, dv) flops per visible
// pair, the two kernels recomputing S and dP so that dq needs no atomics, are
// operation-bound at every shape the port runs: K14 / K15 at qwen2-7b's
// shards 1.46 / 1.95 ms a full step, K4 / K5 at gpt2-xl's training shape
// (B 8, S 1024, H 25, D 64, causal) 0.041 / 0.054 ms at 989 TFLOP/s.
//
// Layout: three warpgroups a block (hopper_tiles.cuh), two consumers of 64
// rows and one producer warp; setmaxnreg gives each consumer 240 registers a
// thread and the producer 24, so one block fills an SM. Work items:
//   dq: 128 query rows of one (batch, head), the last query tiles first
//   (they see the most keys of a causal grid). The producer TMA-loads the
//   item's Q and dO once, then streams K/V tiles of 128 keys through a ring
//   of stages with the key tile's segment ids. Per tile a consumer runs S =
//   Q K^T (m64n128k16, both operands K-major), turns S into p in place, then
//   by halves of 64 keys dP = dO V^T (m64n64k16), ds = p (dP - delta) and
//   dq += ds K (A from registers, K read MN-major); a half's dq product runs
//   while the next half's dP is formed. Registers at D = 128: dq 64, S 64,
//   half a dP 32.
//   dk/dv: 128 keys of one (batch, kv head), the first key tiles first. K and
//   V are loaded once; Q/dO tiles of 64 rows stream with their lse, delta
//   and segment ids, over the G heads of the group and each head's visible
//   query tiles. Transposed, so that keys are the rows: S^T = K Q^T becomes
//   P^T in place; dP^T = V dO^T runs beside dv += bf16(P^T) dO, and dk +=
//   dS^T Q follows (A from registers, dO and Q read MN-major). Registers at
//   D = 128: dk 64, dv 64, S^T 32, dP^T 32; dk and dv stay in registers over
//   the whole group, which is the GQA sum.
// The element passes are branch-free, and only tiles at a mask's edge
// (tile_masked) test visibility, in separate instantiations of the pass
// (run_pass). CAUSAL is a template parameter: a runtime causal flag in these
// masks made K14 / K15 about 4 % slower on the card.
// RING is tuned for the ring's long rows (64 key tiles an item at
// qwen2-7b's shards): one block per item (a causal step above the diagonal
// has blocks that return at once), two stages, the passes of the two
// warpgroups free to overlap, f32 accumulators added into.
// FLASH is tuned for gpt2-xl's short rows (an item walks 1-8 key tiles for
// dq, 2-16 query tiles for dk/dv) at D = 64, where each product is half as
// long as at D = 128 and the passes are as long (Config):
//   - a persistent grid, one block an SM, items dealt longest first as a
//     serpentine (flash_fwd::item_index), with two buffers of the item's
//     own tiles at D = 64, so that the next item's Q/dO (K/V) load while
//     the current item runs, and three stages;
//   - the two warpgroups take turns in the pass that forms p (PassTurns),
//     so that one's pass runs beside the other's products;
//   - masks as limits on the element's column offset, ALiBi and segment ids
//     in their own instantiations of the pass;
//   - bf16 results written as 16-byte stores after a quad exchange
//     (store_row_bf16).
// D = 256: dk and dv do not fit a consumer's registers, so both files keep
// their wmma backward kernels there.
#pragma once

#include <type_traits>

#include "flash_fwd_wgmma.cuh"

namespace flash_bwd {

using bf16 = __nv_bfloat16;
using flash_fwd::FLASH;
using flash_fwd::Mode;
using flash_fwd::RING;
using flash_fwd::row_index;

// the forward's fields (q, k, v, masks, strides, shapes; its causal flag is
// not read: the backward takes CAUSAL as a template parameter), then the
// backward's
struct Params : flash_fwd::Params {
  const bf16* dout;
  const float* lse;    // (B, H, Sq), natural log
  const float* delta;  // (B, H, Sq)
  float* dq;           // RING: f32 accumulators, added into
  float* dk;
  float* dv;
  bf16* dq_out;        // FLASH: bf16 results, written once
  bf16* dk_out;
  bf16* dv_out;
  long long dsb, dsr;  // batch and row strides of dout, elements
};

// every term evaluated (&, not &&): the test stays predicated, with no
// branch around each element of the pass
template <bool CAUSAL>
__device__ __forceinline__ bool visible(const Params& p, int r, int c, int qs, int ks) {
  const int row = p.q_off + r, col = p.k_off + c;
  return (r < p.Sq) & (c < p.Sk) & (!CAUSAL || row >= col) &
         (p.window <= 0 || row - col < p.window) & (p.qseg == nullptr || qs == ks);
}

// true unless every (row, col) of query tile [r0, r0 + BQ) x key tile
// [c0, c0 + BK) is in bounds and visible without a test
template <bool CAUSAL, int BQ, int BK>
__device__ __forceinline__ bool tile_masked(const Params& p, int r0, int c0) {
  if (p.qseg != nullptr || r0 + BQ > p.Sq || c0 + BK > p.Sk) return true;
  const int row_first = p.q_off + r0, col_first = p.k_off + c0;
  if (CAUSAL && col_first + BK - 1 > row_first) return true;                // causal edge
  return p.window > 0 && row_first + BQ - 1 - col_first >= p.window;        // window edge
}

// the key tiles [lo, hi) that any row of query tile [r0, r0 + BQ) can see
template <bool CAUSAL, int BQ, int BK>
__device__ __forceinline__ void key_range(const Params& p, int r0, int& lo, int& hi) {
  const int nk = (p.Sk + BK - 1) / BK;
  hi = nk;
  if (CAUSAL) {                                                   // col <= row
    const int c_last = p.q_off + min(r0 + BQ, p.Sq) - 1 - p.k_off;
    hi = c_last < 0 ? 0 : min(nk, c_last / BK + 1);
  }
  lo = 0;
  if (p.window > 0) {                                             // col > row - window
    const int c_first = p.q_off + r0 - p.window + 1 - p.k_off;
    lo = c_first <= 0 ? 0 : min(nk, c_first / BK);
  }
}

// the query tiles [lo, hi) with a row that can see a key of tile [c0, c0 + BK)
template <bool CAUSAL, int BQ, int BK>
__device__ __forceinline__ void query_range(const Params& p, int c0, int& lo, int& hi) {
  const int nq = (p.Sq + BQ - 1) / BQ;
  lo = 0;
  if (CAUSAL) {                                                   // row >= col
    const int r_first = p.k_off + c0 - p.q_off;
    lo = r_first <= 0 ? 0 : min(nq, r_first / BQ);
  }
  hi = nq;
  if (p.window > 0) {                                             // row < col + window
    const int r_last = p.k_off + min(c0 + BK, p.Sk) - 1 + p.window - 1 - p.q_off;
    hi = r_last < 0 ? 0 : min(nq, r_last / BQ + 1);
  }
}

// How a mode's dq (or dk/dv when DKV) runs at head dim D.
//   PERSISTENT: several items a block, one block an SM, items dealt by
//     flash_fwd::item_index; else the one item of the block's index. FLASH
//     is persistent but for dk/dv at D = 128, where dk, dv, S^T and dP^T
//     hold 192 of a consumer's 240 registers and the loop's item state
//     spilled; RING takes one item a block (its long rows hide an item's
//     set-up).
//   STAGES: the ring of streamed tiles (K/V for dq, Q/dO for dk/dv); three
//     at D = 64 in FLASH, where a tile's products are short.
//   BUFS: buffers for the item's own tiles (Q/dO for dq, K/V for dk/dv); two
//     where persistent at D = 64, so that the next item's load overlaps the
//     current item instead of its set-up.
template <Mode MODE, bool DKV, int D>
struct Config {
  static constexpr bool PERSISTENT = MODE == FLASH && !(DKV && D > 64);
  static constexpr int STAGES = MODE == FLASH && D == 64 ? 3 : hopper::STAGES;
  static constexpr int BUFS = PERSISTENT && D == 64 ? 2 : 1;
};

// dq: BUFS buffers of the item's Q and dO (BQ rows), then a ring of NS K/V
// stages with the key tile's segment ids. Every tile offset is a multiple of
// 1024 bytes.
template <int D, int NS, int BUFS>
struct DqLayout {
  static constexpr int BQ = hopper::CONSUMERS * hopper::WG_ROWS, BK = 128;  // BK keys a stage
  static constexpr int Q_ROWS = BQ, K_ROWS = BK;  // the tensor maps' boxes
  static constexpr size_t q = 0;                   // buffer n: Q, then dO
  static constexpr size_t q_buf = 2 * 2 * BQ * D;
  static constexpr size_t dout = q + 2 * BQ * D;
  static constexpr size_t kv_tile = 2 * BK * D;
  static constexpr size_t stages = BUFS * q_buf;  // stage s: K, then V
  static constexpr size_t seg = stages + NS * 2 * kv_tile;
  static constexpr size_t bars = seg + NS * BK * sizeof(int);
  static constexpr size_t bytes = bars + 2 * (NS + BUFS) * sizeof(uint64_t) + 1024;
};

// dk/dv: BUFS buffers of the item's K and V (BK rows), then a ring of NS
// Q/dO stages with the query tile's lse, delta (both f32) and segment ids.
template <int D, int NS, int BUFS>
struct DkvLayout {
  static constexpr int BK = hopper::CONSUMERS * hopper::WG_ROWS, BQ = 64;  // BQ rows a stage
  static constexpr int Q_ROWS = BQ, K_ROWS = BK;
  static constexpr size_t k = 0;                   // buffer n: K, then V
  static constexpr size_t k_buf = 2 * 2 * BK * D;
  static constexpr size_t v = k + 2 * BK * D;
  static constexpr size_t q_tile = 2 * BQ * D;
  static constexpr size_t stages = BUFS * k_buf;  // stage s: Q, then dO
  static constexpr size_t rows = stages + NS * 2 * q_tile;
  static constexpr size_t bars = rows + NS * 3 * BQ * sizeof(float);
  static constexpr size_t bytes = bars + 2 * (NS + BUFS) * sizeof(uint64_t) + 1024;
};

// the shared-memory layout of the mode's dq (or dk/dv when DKV) at head dim D
template <Mode MODE, bool DKV, int D, typename C = Config<MODE, DKV, D>>
using Layout = std::conditional_t<DKV, DkvLayout<D, C::STAGES, C::BUFS>,
                                  DqLayout<D, C::STAGES, C::BUFS>>;

// One work item: a tile of rows (r0: query rows for dq, key rows for dk/dv)
// of one (batch, head) (kv head for dk/dv) and the tiles [lo, hi) of the
// other side that it walks.
struct Item {
  int r0, h, b, lo, hi;
};

// dq item i: the last query tiles first, then the tiles before them
template <bool CAUSAL>
__device__ __forceinline__ Item dq_item(const Params& p, int i) {
  constexpr int BQ = DqLayout<64, 2, 1>::BQ, BK = DqLayout<64, 2, 1>::BK;
  const int nq = (p.Sq + BQ - 1) / BQ, hb = p.H * p.B;
  Item it;
  it.r0 = (nq - 1 - i / hb) * BQ;
  it.h = i % hb % p.H;
  it.b = i % hb / p.H;
  key_range<CAUSAL, BQ, BK>(p, it.r0, it.lo, it.hi);
  return it;
}

// dk/dv item i: the first key tiles first (the most query tiles see them)
template <bool CAUSAL>
__device__ __forceinline__ Item dkv_item(const Params& p, int i) {
  constexpr int BQ = DkvLayout<64, 2, 1>::BQ, BK = DkvLayout<64, 2, 1>::BK;
  const int hb = p.KVH * p.B;
  Item it;
  it.r0 = i / hb * BK;
  it.h = i % hb % p.KVH;
  it.b = i % hb / p.KVH;
  query_range<CAUSAL, BQ, BK>(p, it.r0, it.lo, it.hi);
  return it;
}

// the block's item after item_index(k): item_index(k + 1) when persistent,
// none (items) when the block takes one item
template <bool PERSISTENT>
__device__ __forceinline__ int next_item(int& k, int items) {
  return PERSISTENT ? flash_fwd::item_index(++k) : items;
}

// whether any item this block takes has work: a block without any (a ring
// step above the diagonal) returns before it sets anything up
template <bool PERSISTENT, typename ItemAt>
__device__ __forceinline__ bool block_has_work(int items, ItemAt item_at) {
  for (int k = 0, i = flash_fwd::item_index(0); i < items; i = next_item<PERSISTENT>(k, items)) {
    const Item it = item_at(i);
    if (it.lo < it.hi) return true;
  }
  return false;
}

// The element pass of a tile, form_p(masked, alibi, segments) with each a
// std::bool_constant, in the instantiation the tile needs. RING: K14 / K15's
// two, ALiBi always applied (a slope of 0 when absent) and the visibility
// test (visible()) only on masked tiles. FLASH: ALiBi and segment ids only
// when given, and masks as limits on the element's column offset, which
// halves the pass at gpt2-xl's shape, where one key tile in four is masked.
// Every choice is uniform over the block, so no branch depends on the thread.
template <Mode MODE, typename Pass>
__device__ __forceinline__ void run_pass(Pass& form_p, bool masked, float slope,
                                         bool segments) {
  using T = std::true_type;
  using F = std::false_type;
  if constexpr (MODE == RING) {
    if (masked)
      form_p(T{}, T{}, F{});
    else
      form_p(F{}, T{}, F{});
  } else {
    const auto run = [&](auto alibi) {
      if (!masked)
        form_p(F{}, alibi, F{});
      else if (!segments)
        form_p(T{}, alibi, F{});
      else
        form_p(T{}, alibi, T{});
    };
    if (slope == 0.f)
      run(F{});
    else
      run(T{});
  }
}

// FLASH (ON): the two consumer warpgroups take turns in the element pass
// that forms p (named barriers 1 and 2, warpgroup 0 first), so that one
// warpgroup's pass runs beside the other's products and the two passes do
// not share the special function unit. A warpgroup takes its turn on every
// tile of the block's range, also on one whose rows it skips, so that the
// turns stay paired. RING (off): K14 / K15 take no turns (not yet tried at
// the ring's shapes).
template <bool ON>
struct PassTurns {
  static constexpr int THREADS = hopper::CONSUMERS * hopper::WG;
  int own, other;
  __device__ __forceinline__ explicit PassTurns(int wg) : own(1 + wg), other(2 - wg) {
    if (ON && wg == 1) hopper::named_arrive<THREADS>(1);
  }
  __device__ __forceinline__ void begin() const {
    if (ON) hopper::named_sync<THREADS>(own);
  }
  __device__ __forceinline__ void end() const {
    if (ON) hopper::named_arrive<THREADS>(other);
  }
  __device__ __forceinline__ void skip() const {
    begin();
    end();
  }
  // warpgroup 1 arrived once more than warpgroup 0 waited: take it
  __device__ __forceinline__ void finish() const {
    if (ON && own == 1) hopper::named_sync<THREADS>(own);
  }
};

// the barriers: a full and an empty one for each of NS stages (full[s],
// full[NS + s]), then for each of BUFS buffers of the item's own tiles (Q/dO,
// or K/V) a full and an empty one (full[2 NS + n], full[2 NS + BUFS + n])
template <int NS, int BUFS>
__device__ __forceinline__ void init_barriers(uint64_t* full) {
  using namespace hopper;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&full[NS + s], CONSUMERS * WG);
    }
    for (int n = 0; n < BUFS; ++n) {
      mbar_init(&full[2 * NS + n], 1);
      mbar_init(&full[2 * NS + BUFS + n], CONSUMERS * WG);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// A consumer thread's share of one row of an m64nD f32 accumulator (its
// elements 4 j + 2 u, 4 j + 2 u + 1: columns 8 j + 2 (lane % 4) + {0, 1}),
// rounded to bf16 and written to `row` (16-byte aligned) as 16-byte stores:
// the four threads of a quad exchange their 4-byte pieces (shfl_xor) so that
// each writes whole 8-column blocks, a quarter of the stores and whole
// 32-byte sectors. Every thread of the warp calls it; `in` says whether the
// row is one to write.
template <int D>
__device__ __forceinline__ void store_row_bf16(bf16* row, const float (&acc)[D / 2], int u,
                                               int lane, bool in) {
  const int qp = lane % 4;
  const auto pick = [](const uint32_t (&a)[4], int i) {
    return i & 2 ? (i & 1 ? a[3] : a[2]) : (i & 1 ? a[1] : a[0]);
  };
#pragma unroll
  for (int g = 0; g < D / 32; ++g) {  // blocks 4 g .. 4 g + 3; this thread writes 4 g + qp
    uint32_t w[4], got[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = hopper::pack_bf16(acc[4 * (4 * g + j) + 2 * u], acc[4 * (4 * g + j) + 2 * u + 1]);
#pragma unroll
    for (int r = 0; r < 4; ++r)  // from thread qp ^ r: its piece of block 4 g + qp
      got[r] = __shfl_xor_sync(0xffffffffu, pick(w, qp ^ r), r);
    const uint4 v = make_uint4(pick(got, qp), pick(got, qp ^ 1), pick(got, qp ^ 2),
                               pick(got, qp ^ 3));
    if (in) *reinterpret_cast<uint4*>(row + 8 * (4 * g + qp)) = v;
  }
}

// dq (K14 / K4); the __global__ kernels of ring_flash.cu and
// flash_attention.cu are this function for their mode
template <int D, Mode MODE, bool CAUSAL>
__device__ __forceinline__ void backward_dq(const Params& p, const CUtensorMap* tq,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const CUtensorMap* tdo) {
  using namespace hopper;
  using C = Config<MODE, false, D>;
  using SM = Layout<MODE, false, D>;
  constexpr int BQ = SM::BQ, BK = SM::BK, NS = C::STAGES, BUFS = C::BUFS;
  constexpr bool PERSISTENT = C::PERSISTENT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int* ksegs = reinterpret_cast<int*>(smem + SM::seg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::bars);
  uint64_t* empty = full + NS;
  uint64_t* q_full = empty + NS;     // buffer n's Q and dO have landed
  uint64_t* q_empty = q_full + BUFS;  // the consumers are done with them
  const int items = (p.Sq + BQ - 1) / BQ * p.H * p.B;
  const auto item_at = [&](int i) { return dq_item<CAUSAL>(p, i); };
  if (!block_has_work<PERSISTENT>(items, item_at)) return;  // nothing visible: dq gains 0
  init_barriers<NS, BUFS>(full);

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {  // ------------------------------------- producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x % WG >= 32) return;
    const int lane = threadIdx.x % 32;
    StageRing<NS> ring;
    StageRing<BUFS> buf;
    for (int k = 0, i = flash_fwd::item_index(0); i < items;
         i = next_item<PERSISTENT>(k, items)) {
      const Item it = item_at(i);
      if (it.lo >= it.hi) continue;
      const int kh = it.h / (p.H / p.KVH);
      if (PERSISTENT) mbar_wait(&q_empty[buf.s], buf.phase ^ 1);
      if (lane == 0) {
        bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q + buf.s * SM::q_buf);
        mbar_arrive_expect_tx(&q_full[buf.s], 2 * 2 * BQ * D);
        tma_rows<D>(Qs, tq, &q_full[buf.s], BQ, it.h, it.r0, it.b);
        tma_rows<D>(Qs + BQ * D, tdo, &q_full[buf.s], BQ, it.h, it.r0, it.b);
      }
      buf.next();
      const int* ksegb = p.kseg != nullptr ? p.kseg + static_cast<size_t>(it.b) * p.Sk : nullptr;
      for (int j = it.lo; j < it.hi; ++j, ring.next()) {
        mbar_wait(&empty[ring.s], ring.phase ^ 1);
        const int c0 = j * BK;
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
  } else {  // ---------------------------------------------------- consumers
    regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG, lane = t % 32;
    const PassTurns<MODE == FLASH> turns(wg);
    StageRing<NS> ring;
    StageRing<BUFS> buf;
    for (int k = 0, i = flash_fwd::item_index(0); i < items;
         i = next_item<PERSISTENT>(k, items)) {
      const Item it = item_at(i);
      if (it.lo >= it.hi) continue;  // RING: nothing visible, dq gains 0 (FLASH: never)
      const int h = it.h, b = it.b;
      const int rw = it.r0 + wg * WG_ROWS;            // the warpgroup's first row
      const int ra = rw + (t / 32) * 16 + lane / 4;   // this thread's rows: ra, ra + 8
      int wlo = 0, whi = 0;
      if (rw < p.Sq) key_range<CAUSAL, WG_ROWS, BK>(p, rw, wlo, whi);
      const size_t roff = (static_cast<size_t>(b) * p.H + h) * p.Sq;
      float lse[2], delta[2];
      int qseg[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = ra + 8 * u;
        const bool in = r < p.Sq;
        lse[u] = in ? p.lse[roff + r] : 0.f;
        if constexpr (MODE == RING) lse[u] *= LOG2E;
        delta[u] = in ? p.delta[roff + r] : 0.f;
        qseg[u] = in && p.qseg != nullptr ? p.qseg[static_cast<size_t>(b) * p.Sq + r] : 0;
      }
      const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      const uint32_t q_tile =
          smem_addr(smem + SM::q + (BUFS > 1 ? buf.s * SM::q_buf : 0)) + wg * WG_ROWS * 128;
      const uint32_t do_tile = q_tile + (SM::dout - SM::q);
      uint64_t* const q_free = &q_empty[buf.s];
      mbar_wait(&q_full[buf.s], buf.phase);
      buf.next();
      if constexpr (MODE == FLASH) {  // scaled only now: the loads land while Q and dO do
        fence_regs(lse);
        lse[0] *= LOG2E;
        lse[1] *= LOG2E;
      }

      for (int j = it.lo; j < it.hi; ++j, ring.next()) {
        mbar_wait(&full[ring.s], ring.phase);
        const bool last = j + 1 == it.hi;  // the item's last tile: Q and dO go after it
        if (j >= wlo && j < whi) {
          const int c0 = j * BK;
          const uint32_t k_tile = smem_addr(smem + SM::stages + ring.s * 2 * SM::kv_tile);
          const uint32_t v_tile = k_tile + SM::kv_tile;
          const int* kseg = ksegs + ring.s * BK;
          // S = Q K^T over the whole key tile (m64n128k16)
          float s[BK / 2];  // written whole by the first product (scale-d 0)
          fence_regs(s);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
            Wgmma<BK>::template ss<0>(s, desc_k_major(q_tile, BQ, k), desc_k_major(k_tile, BK, k),
                                      k > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);

          // p = exp(s - lse) on visible keys, in place of s; branch-free, with
          // the visibility test only on tiles that need it. Element i sits in
          // row ra + 8 u at column offset ce = 8 (i / 4) + i % 2 from this
          // thread's first column, so col - row = pos0 + ce - 8 u.
          const int pos0 = p.k_off + c0 + 2 * (lane % 4) - (p.q_off + ra);  // col - row of s[0]
          int lim_hi[2], lim_lo[2];  // FLASH: visible iff lim_lo[u] < ce <= lim_hi[u]
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            lim_hi[u] = min(p.Sk - c0 - 2 * (lane % 4) - 1, CAUSAL ? 8 * u - pos0 : p.Sk);
            if (ra + 8 * u >= p.Sq) lim_hi[u] = -1;                          // a row past Sq
            lim_lo[u] = p.window > 0 ? 8 * u - pos0 - p.window : -1;
          }
          auto form_p = [&](auto masked, auto alibi, auto segments) {
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
              const int u = (i / 2) % 2, ce = 8 * (i / 4) + i % 2, cl = ce + 2 * (lane % 4);
              float x = s[i];
              if constexpr (decltype(alibi)::value)
                x += slope * static_cast<float>(pos0 + ce - 8 * u);
              x = exp2_approx(x * LOG2E - lse[u]);
              if constexpr (decltype(masked)::value) {
                bool vis;
                if constexpr (MODE == RING) {
                  vis = visible<CAUSAL>(p, ra + 8 * u, c0 + cl, qseg[u], kseg[cl]);
                } else {
                  vis = (ce <= lim_hi[u]) & (ce > lim_lo[u]);
                  if constexpr (decltype(segments)::value) vis &= qseg[u] == kseg[cl];
                }
                x = vis ? x : 0.f;
              }
              s[i] = x;
            }
          };
          turns.begin();
          run_pass<MODE>(form_p, tile_masked<CAUSAL, WG_ROWS, BK>(p, rw, c0), slope,
                         p.qseg != nullptr);
          turns.end();

          // by halves of 64 keys, so that dP's registers stay half a tile: dP =
          // dO V^T (m64n64k16), ds = p (dP - delta) rounded to bf16, and dq += ds
          // K (A from registers, K read MN-major); a half's dq product runs
          // while the next half's dP is formed
          uint32_t ds[BK / 4];
#pragma unroll
          for (int hf = 0; hf < BK / 64; ++hf) {
            float dp[32];  // written whole by the first product (scale-d 0)
            fence_regs(dp);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < D / 16; ++k)
              Wgmma<64>::template ss<0>(dp, desc_k_major(do_tile, BQ, k),
                                        desc_k_major(v_tile + hf * 64 * 128, BK, k), k > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dp);
            if (PERSISTENT && hf == BK / 64 - 1 && last)
              mbar_arrive(q_free);  // Q, dO read for the last time
#pragma unroll
            for (int m = 0; m < 16; ++m) {
              const int i = 32 * hf + 2 * m;
              ds[16 * hf + m] = pack_bf16(s[i] * (dp[2 * m] - delta[m % 2]),
                                          s[i + 1] * (dp[2 * m + 1] - delta[m % 2]));
            }
            fence_regs(ds);
            fence_regs(dq);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              uint32_t a[4];
              a_fragment(a, ds, 4 * hf + k);
              Wgmma<D>::template rs<1>(dq, a, desc_mn_major(k_tile + hf * 64 * 128, BK, k));
            }
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(ds);  // the A operand stays put until the product is done
          fence_regs(dq);
        } else {
          turns.skip();
          if (PERSISTENT && last) mbar_arrive(q_free);
        }
        mbar_arrive(&empty[ring.s]);
      }

      // the block owns its rows: one write each, no atomics
      if constexpr (MODE == RING) {  // add into the f32 accumulator
        if (wlo < whi) {
#pragma unroll
          for (int i = 0; i < D / 2; i += 2) {
            const int r = ra + 8 * ((i / 2) % 2), d = 8 * (i / 4) + 2 * (lane % 4);
            if (r >= p.Sq) continue;
            float2* out = reinterpret_cast<float2*>(p.dq + row_index(b, r, h, p.Sq, p.H, D) + d);
            float2 cur = *out;
            cur.x += dq[i];
            cur.y += dq[i + 1];
            *out = cur;
          }
        }
      } else {  // bf16 dq
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = ra + 8 * u;
          store_row_bf16<D>(p.dq_out + row_index(b, min(r, p.Sq - 1), h, p.Sq, p.H, D), dq, u,
                            lane, r < p.Sq);
        }
      }
    }
    turns.finish();
  }
}

// dk and dv (K15 / K5), summed over the G query heads of the group in
// registers
template <int D, Mode MODE, bool CAUSAL>
__device__ __forceinline__ void backward_dkv(const Params& p, const CUtensorMap* tq,
                                             const CUtensorMap* tk, const CUtensorMap* tv,
                                             const CUtensorMap* tdo) {
  using namespace hopper;
  using C = Config<MODE, true, D>;
  using SM = Layout<MODE, true, D>;
  constexpr int BQ = SM::BQ, BK = SM::BK, NS = C::STAGES, BUFS = C::BUFS;
  constexpr bool PERSISTENT = C::PERSISTENT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* rowv = reinterpret_cast<float*>(smem + SM::rows);  // stage s: lse, delta, qseg
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::bars);
  uint64_t* empty = full + NS;
  uint64_t* kv_full = empty + NS;       // buffer n's K and V have landed
  uint64_t* kv_empty = kv_full + BUFS;  // the consumers are done with them
  const int items = (p.Sk + BK - 1) / BK * p.KVH * p.B;
  const auto item_at = [&](int i) { return dkv_item<CAUSAL>(p, i); };
  if (!block_has_work<PERSISTENT>(items, item_at)) return;  // no row sees these keys: dk, dv gain 0
  init_barriers<NS, BUFS>(full);
  const int G = p.H / p.KVH;

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {  // ------------------------------------- producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x % WG >= 32) return;
    const int lane = threadIdx.x % 32;
    StageRing<NS> ring;
    StageRing<BUFS> buf;
    for (int k = 0, i = flash_fwd::item_index(0); i < items;
         i = next_item<PERSISTENT>(k, items)) {
      const Item it = item_at(i);
      if (it.lo >= it.hi) continue;
      const int kh = it.h, b = it.b;
      if (PERSISTENT) mbar_wait(&kv_empty[buf.s], buf.phase ^ 1);
      if (lane == 0) {
        bf16* Ks = reinterpret_cast<bf16*>(smem + SM::k + buf.s * SM::k_buf);
        mbar_arrive_expect_tx(&kv_full[buf.s], 2 * 2 * BK * D);
        tma_rows<D>(Ks, tk, &kv_full[buf.s], BK, kh, it.r0, b);
        tma_rows<D>(Ks + BK * D, tv, &kv_full[buf.s], BK, kh, it.r0, b);
      }
      buf.next();
      const int* qsegb = p.qseg != nullptr ? p.qseg + static_cast<size_t>(b) * p.Sq : nullptr;
      for (int g = 0; g < G; ++g) {
        const int h = kh * G + g;
        const size_t roff = (static_cast<size_t>(b) * p.H + h) * p.Sq;
        for (int i0 = it.lo; i0 < it.hi; ++i0, ring.next()) {
          // this lane's rows of the tile's lse, delta and segment ids, loaded
          // while the stage drains
          const int r0 = i0 * BQ;
          float lv[BQ / 32], dl[BQ / 32];
          int sv[BQ / 32];
#pragma unroll
          for (int u = 0; u < BQ / 32; ++u) {
            const int r = r0 + lane + 32 * u;
            const bool in = r < p.Sq;
            lv[u] = in ? p.lse[roff + r] * LOG2E : 0.f;
            dl[u] = in ? p.delta[roff + r] : 0.f;
            sv[u] = in && qsegb != nullptr ? qsegb[r] : 0;
          }
          mbar_wait(&empty[ring.s], ring.phase ^ 1);
          float* lse = rowv + ring.s * 3 * BQ;
          float* delta = lse + BQ;
          int* qseg = reinterpret_cast<int*>(delta + BQ);
#pragma unroll
          for (int u = 0; u < BQ / 32; ++u) {
            lse[lane + 32 * u] = lv[u];
            delta[lane + 32 * u] = dl[u];
            qseg[lane + 32 * u] = sv[u];
          }
          if (lane == 0) {
            bf16* Qst = reinterpret_cast<bf16*>(smem + SM::stages + ring.s * 2 * SM::q_tile);
            mbar_arrive_expect_tx(&full[ring.s], 2 * SM::q_tile);
            tma_rows<D>(Qst, tq, &full[ring.s], BQ, h, r0, b);
            tma_rows<D>(Qst + BQ * D, tdo, &full[ring.s], BQ, h, r0, b);
          } else {
            mbar_arrive(&full[ring.s]);
          }
        }
      }
    }
  } else {  // ---------------------------------------------------- consumers
    regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG, lane = t % 32;
    const PassTurns<MODE == FLASH> turns(wg);
    StageRing<NS> ring;
    StageRing<BUFS> buf;
    for (int k = 0, i = flash_fwd::item_index(0); i < items;
         i = next_item<PERSISTENT>(k, items)) {
      const Item it = item_at(i);
      if (it.lo >= it.hi) continue;  // RING: no row sees these keys (FLASH: never)
      const int kh = it.h, b = it.b;
      const int cw = it.r0 + wg * WG_ROWS;            // the warpgroup's first key
      const int ka = cw + (t / 32) * 16 + lane / 4;   // this thread's keys: ka, ka + 8
      int wlo = 0, whi = 0;
      if (cw < p.Sk) query_range<CAUSAL, BQ, WG_ROWS>(p, cw, wlo, whi);
      int kseg[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = ka + 8 * u;
        kseg[u] = c < p.Sk && p.kseg != nullptr ? p.kseg[static_cast<size_t>(b) * p.Sk + c] : 0;
      }
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
      const uint32_t k_tile =
          smem_addr(smem + SM::k + (BUFS > 1 ? buf.s * SM::k_buf : 0)) + wg * WG_ROWS * 128;
      const uint32_t v_tile = k_tile + (SM::v - SM::k);
      uint64_t* const kv_free = &kv_empty[buf.s];
      mbar_wait(&kv_full[buf.s], buf.phase);
      buf.next();

      for (int g = 0; g < G; ++g) {
        const int h = kh * G + g;
        const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
        for (int i0 = it.lo; i0 < it.hi; ++i0, ring.next()) {
          mbar_wait(&full[ring.s], ring.phase);
          const bool last = g + 1 == G && i0 + 1 == it.hi;  // K and V go after this tile
          if (i0 >= wlo && i0 < whi) {
            const int r0 = i0 * BQ;
            const uint32_t q_st = smem_addr(smem + SM::stages + ring.s * 2 * SM::q_tile);
            const uint32_t do_st = q_st + SM::q_tile;
            const float* lse = rowv + ring.s * 3 * BQ;
            const float* delta = lse + BQ;
            const int* qseg = reinterpret_cast<const int*>(delta + BQ);
            float s[BQ / 2], dp[BQ / 2];  // written whole by the first product (scale-d 0)

            // S^T = K Q^T: keys are the rows
            fence_regs(s);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < D / 16; ++k)
              Wgmma<BQ>::template ss<0>(s, desc_k_major(k_tile, BK, k), desc_k_major(q_st, BQ, k),
                                        k > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(s);

            // P^T = exp(S^T - lse) on visible pairs, in place of S^T, and rounded
            // to bf16 for dv; branch-free, with the visibility test only on tiles
            // that need it; the lse (delta) of a column pair is one 8-byte load.
            // Element 2 m + e sits in key row ka + 8 u (u = m % 2) at query
            // offset qe = 8 (m / 2) + e from this thread's first query column,
            // so col - row = pos0 + 8 u - qe.
            uint32_t pt[BQ / 4], dst[BQ / 4];
            const int pos0 = p.k_off + ka - (p.q_off + r0 + 2 * (lane % 4));  // col - row of s[0]
            int lim_hi[2], lim_lo[2];  // FLASH: visible iff lim_lo[u] < qe <= lim_hi[u]
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              lim_hi[u] = min(p.Sq - r0 - 2 * (lane % 4) - 1,
                              p.window > 0 ? pos0 + 8 * u + p.window - 1 : p.Sq);
              if (ka + 8 * u >= p.Sk) lim_hi[u] = -1;                        // a key past Sk
              lim_lo[u] = CAUSAL ? pos0 + 8 * u - 1 : -1;
            }
            auto form_p = [&](auto masked, auto alibi, auto segments) {
#pragma unroll
              for (int m = 0; m < BQ / 4; ++m) {
                const int u = m % 2, q2 = 8 * (m / 2) + 2 * (lane % 4);  // columns q2, q2 + 1
                const float2 l2 = *reinterpret_cast<const float2*>(lse + q2);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int i = 2 * m + e, qe = 8 * (m / 2) + e;
                  float x = s[i];
                  if constexpr (decltype(alibi)::value)
                    x += slope * static_cast<float>(pos0 + 8 * u - qe);
                  x = exp2_approx(x * LOG2E - (e ? l2.y : l2.x));
                  if constexpr (decltype(masked)::value) {
                    bool vis;
                    if constexpr (MODE == RING) {
                      vis = visible<CAUSAL>(p, r0 + q2 + e, ka + 8 * u, qseg[q2 + e], kseg[u]);
                    } else {
                      vis = (qe <= lim_hi[u]) & (qe > lim_lo[u]);
                      if constexpr (decltype(segments)::value) vis &= qseg[q2 + e] == kseg[u];
                    }
                    x = vis ? x : 0.f;
                  }
                  s[i] = x;
                }
                pt[m] = pack_bf16(s[2 * m], s[2 * m + 1]);
              }
            };
            turns.begin();
            run_pass<MODE>(form_p, tile_masked<CAUSAL, BQ, WG_ROWS>(p, r0, cw), slope,
                           p.qseg != nullptr);
            turns.end();

            // dP^T = V dO^T, and dv += P^T dO (A from registers, dO read
            // MN-major). dP^T is formed only now, so that its registers and
            // S^T's are not both live beside dk and dv while P^T is formed.
            fence_regs(s);
            fence_regs(dp);
            fence_regs(pt);
            fence_regs(dv);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < D / 16; ++k)
              Wgmma<BQ>::template ss<0>(dp, desc_k_major(v_tile, BK, k), desc_k_major(do_st, BQ, k),
                                        k > 0);
#pragma unroll
            for (int k = 0; k < BQ / 16; ++k) {
              uint32_t a[4];
              a_fragment(a, pt, k);
              Wgmma<D>::template rs<1>(dv, a, desc_mn_major(do_st, BQ, k));
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dp);
            fence_regs(pt);
            fence_regs(dv);
            if (PERSISTENT && last) mbar_arrive(kv_free);  // K, V read for the last time

            // dS^T = P^T (dP^T - delta), rounded to bf16, and dk += dS^T Q
#pragma unroll
            for (int m = 0; m < BQ / 4; ++m) {
              const float2 d2 =
                  *reinterpret_cast<const float2*>(delta + 8 * (m / 2) + 2 * (lane % 4));
              dst[m] = pack_bf16(s[2 * m] * (dp[2 * m] - d2.x),
                                 s[2 * m + 1] * (dp[2 * m + 1] - d2.y));
            }
            fence_regs(dst);
            fence_regs(dk);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < BQ / 16; ++k) {
              uint32_t a[4];
              a_fragment(a, dst, k);
              Wgmma<D>::template rs<1>(dk, a, desc_mn_major(q_st, BQ, k));
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dst);  // the A operand stays put until the product is done
            fence_regs(dk);
          } else {
            turns.skip();
            if (PERSISTENT && last) mbar_arrive(kv_free);
          }
          mbar_arrive(&empty[ring.s]);
        }
      }

      // the block owns its keys: one write each, no atomics
      if constexpr (MODE == RING) {  // add into the f32 accumulators
        if (wlo < whi) {
#pragma unroll
          for (int i = 0; i < D / 2; i += 2) {
            const int c = ka + 8 * ((i / 2) % 2), d = 8 * (i / 4) + 2 * (lane % 4);
            if (c >= p.Sk) continue;
            const size_t off = row_index(b, c, kh, p.Sk, p.KVH, D) + d;
            float2* ok = reinterpret_cast<float2*>(p.dk + off);
            float2* ov = reinterpret_cast<float2*>(p.dv + off);
            float2 ck = *ok, cv = *ov;
            ck.x += dk[i];
            ck.y += dk[i + 1];
            cv.x += dv[i];
            cv.y += dv[i + 1];
            *ok = ck;
            *ov = cv;
          }
        }
      } else {  // bf16 dk, dv
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = ka + 8 * u;
          const size_t off = row_index(b, min(c, p.Sk - 1), kh, p.Sk, p.KVH, D);
          store_row_bf16<D>(p.dk_out + off, dk, u, lane, c < p.Sk);
          store_row_bf16<D>(p.dv_out + off, dv, u, lane, c < p.Sk);
        }
      }
    }
    turns.finish();
  }
}

// The tensor maps of q, do (Q_ROWS-row boxes), k and v (K_ROWS-row boxes)
// from their own strides, then the launch of `kernel` (the mode's dq, or
// dk/dv when DKV): one block per item, or when persistent one block per
// SM (one per item when there are fewer).
template <int D, Mode MODE, bool DKV, typename Kernel>
cudaError_t launch(Kernel kernel, const Params& params, int B, cudaStream_t stream) {
  using SM = Layout<MODE, DKV, D>;
  Params p = params;
  p.B = B;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e;
  if ((e = hopper::rows_map(&tq, p.q, D, p.H, p.Sq, B, p.qsr, p.qsb, SM::Q_ROWS)) != cudaSuccess ||
      (e = hopper::rows_map(&tk, p.k, D, p.KVH, p.Sk, B, p.ksr, p.ksb, SM::K_ROWS)) !=
          cudaSuccess ||
      (e = hopper::rows_map(&tv, p.v, D, p.KVH, p.Sk, B, p.vsr, p.vsb, SM::K_ROWS)) !=
          cudaSuccess ||
      (e = hopper::rows_map(&tdo, p.dout, D, p.H, p.Sq, B, p.dsr, p.dsb, SM::Q_ROWS)) !=
          cudaSuccess)
    return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(SM::bytes));
  if (e != cudaSuccess) return e;
  const long long items =
      DKV ? static_cast<long long>((p.Sk + SM::BK - 1) / SM::BK) * p.KVH * B
          : static_cast<long long>((p.Sq + SM::BQ - 1) / SM::BQ) * p.H * B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  long long blocks = items;
  if (Config<MODE, DKV, D>::PERSISTENT) {
    int device, sms;
    if ((e = cudaGetDevice(&device)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return e;
    blocks = items < sms ? items : sms;
  }
  kernel<<<static_cast<unsigned>(blocks), hopper::WG_THREADS, SM::bytes, stream>>>(p, tq, tk, tv,
                                                                                   tdo);
  return cudaGetLastError();
}

}  // namespace flash_bwd
