// The attention forward for Hopper (sm_90a): one online-softmax mainloop on
// wgmma with register accumulators, fed by TMA, shared by two kernels.
//
// Replaces two TPU kernels that compute the same online softmax:
//   K13 deepspeed_tpu/sequence/ring_flash.py _ring_fwd_kernel (one ring step:
//       fold one K/V shard into the carry m, l, acc at global offsets) ->
//       ring_flash.cu ring_fwd_wgmma, mode RING;
//   K3  deepspeed_tpu/ops/pallas/flash_attention.py _fwd_kernel (out and
//       lse from an empty state) -> flash_attention.cu flash_fwd_wgmma,
//       mode FLASH.
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
  int B;                // set by launch()
};

enum Mode { RING, FLASH };

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

// The block's Q (BQ rows), then a ring of K/V stages with the key tile's
// segment ids. Every tile offset is a multiple of 1024 bytes.
template <int D>
struct Layout {
  static constexpr int BQ = hopper::CONSUMERS * hopper::WG_ROWS;
  static constexpr int BK = D <= 128 ? 128 : 64;       // keys a stage
  static constexpr size_t q = 0;
  static constexpr size_t kv_tile = 2 * BK * D;        // bytes of one K or V tile
  static constexpr size_t stages = q + 2 * BQ * D;     // stage s: K, then V
  static constexpr size_t seg = stages + hopper::STAGES * 2 * kv_tile;
  static constexpr size_t bars = seg + hopper::STAGES * BK * sizeof(int);
  static constexpr size_t bytes = bars + (2 * hopper::STAGES + 2) * sizeof(uint64_t) + 1024;
};

// One work item: BQ query rows of one (batch, head) and the key tiles
// [lo, hi) they can see. Items go longest first: the last query tiles, which
// see the most keys of a causal grid, of every (batch, head) pair, then the
// tiles before them.
struct Item {
  int r0, h, b, lo, hi;
};

template <int BQ, int BK>
__device__ __forceinline__ Item item_at(const Params& p, int i) {
  const int nq = (p.Sq + BQ - 1) / BQ, hb = p.H * p.B;
  Item it;
  it.r0 = (nq - 1 - i / hb) * BQ;
  it.h = i % hb % p.H;
  it.b = i % hb / p.H;
  key_range<BQ, BK>(p, it.r0, it.lo, it.hi);
  return it;
}

// The item a block takes in round k: rounds alternate direction over the
// blocks (a serpentine), so that with items longest first every block's
// total stays within about one item of the others'.
__device__ __forceinline__ int item_index(int k) {
  return k * gridDim.x + (k % 2 == 0 ? blockIdx.x : gridDim.x - 1 - blockIdx.x);
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

// The forward; the __global__ kernels of ring_flash.cu and flash_attention.cu
// are this function for their mode. Persistent: each block takes one item a
// round (item_index), so that the producer loads the next item's Q and first
// K/V tiles while the consumers finish the current one.
template <int D, Mode MODE>
__device__ __forceinline__ void forward(const Params& p, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv) {
  using namespace hopper;
  using SM = Layout<D>;
  constexpr int BQ = SM::BQ, BK = SM::BK;
  constexpr int NB = D < 128 ? D : 128;  // output columns of one P V product
  constexpr int NH = D / NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q);
  int* ksegs = reinterpret_cast<int*>(smem + SM::seg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;  // Q of the current item has landed
  uint64_t* q_empty = q_full + 1;     // the consumers are done with it
  const int items = (p.Sq + BQ - 1) / BQ * p.H * p.B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x % WG >= 32) return;
    const int lane = threadIdx.x % 32;
    Ring ring;
    uint32_t q_phase = 0;
    for (int k = 0, i = item_index(0); i < items; i = item_index(++k)) {
      const Item it = item_at<BQ, BK>(p, i);
      if (it.lo >= it.hi) continue;  // no key to load (RING: the carry stays)
      const int kh = it.h / (p.H / p.KVH);
      mbar_wait(q_empty, q_phase ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(q_full, 2 * BQ * D);
        tma_rows<D>(Qs, tq, q_full, BQ, it.h, it.r0, it.b);
      }
      q_phase ^= 1;
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
    const uint32_t q_tile = smem_addr(Qs) + wg * WG_ROWS * 128;
    const int own = 1 + wg, other = 2 - wg;  // the pass turns' named barriers
    if (wg == 1) named_arrive<CONSUMERS * WG>(1);  // warpgroup 0 takes the first turn
    Ring ring;
    uint32_t q_phase = 0;
    for (int k = 0, i = item_index(0); i < items; i = item_index(++k)) {
      const Item it = item_at<BQ, BK>(p, i);
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
        qseg[u] = in && p.qseg != nullptr ? p.qseg[static_cast<size_t>(b) * p.Sq + r] : 0;
        m[u] = MODE == RING && in ? p.m[roff + r] : -INFINITY;
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
      const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;

      if (it.lo < it.hi) {
        mbar_wait(q_full, q_phase);
        q_phase ^= 1;
      }
      // The key range and the masked-tile test are the block's, so every
      // branch is uniform over the block; a warpgroup's rows that see nothing
      // of a tile keep their state exactly (alpha = 1, p = 0).
      for (int j = it.lo; j < it.hi; ++j, ring.next()) {
        mbar_wait(&full[ring.s], ring.phase);
        const int c0 = j * BK;
        const uint32_t k_tile = smem_addr(smem + SM::stages + ring.s * 2 * SM::kv_tile);
        const uint32_t v_tile = k_tile + SM::kv_tile;
        const int* kseg = ksegs + ring.s * BK;
        // S = Q K^T over the whole key tile
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
        // the instantiation this tile needs: masks only at a mask's edge,
        // segment ids and ALiBi only when given (all uniform over the block)
        auto run = [&](auto alibi) {
          if (!tile_masked<BQ, BK>(p, r0, c0))
            pass(std::false_type{}, std::false_type{}, alibi);
          else if (p.qseg == nullptr)
            pass(std::true_type{}, std::false_type{}, alibi);
          else
            pass(std::true_type{}, std::true_type{}, alibi);
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
          // a row with no visible key gets +inf, so the backward's exp(s - lse) is 0
          if (r < p.Sq && lane % 4 == 0)
            p.lse_out[roff + r] = l[u] > 0.f ? m[u] + logf(l[u]) : INFINITY;
        }
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int e = 0; e < NB / 2; e += 2) {
            const int u = (e / 2) % 2, r = ra + 8 * u;
            const int d = n * NB + 8 * (e / 4) + 2 * (lane % 4);
            if (r < p.Sq)
              *reinterpret_cast<__nv_bfloat162*>(p.out + row_index(b, r, h, p.Sq, p.H, D) + d) =
                  __floats2bfloat162_rn(o[n][e] * inv[u], o[n][e + 1] * inv[u]);
          }
      }
    }
    // warpgroup 1 arrived once more than warpgroup 0 waited: take it
    if (wg == 0) named_sync<CONSUMERS * WG>(own);
  }
}

// The tensor maps of q (BQ-row boxes), k and v (BK-row boxes) from their own
// strides, then the launch of `kernel` (the mode's forward): one persistent
// block per SM, or one per item when there are fewer.
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
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(SM::bytes));
  if (e != cudaSuccess) return e;
  int device, sms;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  const long long items = static_cast<long long>((p.Sq + SM::BQ - 1) / SM::BQ) * p.H * B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(items < sms ? items : sms);
  kernel<<<blocks, hopper::WG_THREADS, SM::bytes, stream>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

}  // namespace flash_fwd
