// One step of ring (context-parallel) flash attention for Hopper (sm_90a):
// the training attention of the port's sequence-parallel path.
//
// Replaces the TPU kernels of deepspeed_tpu/sequence/ring_flash.py:
//   K13 _ring_fwd_kernel -> ring_fwd_wgmma  (fold one K/V shard into the carry;
//                           the forward of flash_fwd_wgmma.cuh in mode RING)
//   K14 _ring_dq_kernel  -> ring_dq_wgmma   (dq of one step, added into the f32
//                           accumulator; ring_dq_kernel at D = 256)
//   K15 _ring_dkv_kernel -> ring_dkv_wgmma  (dk, dv of one step, GQA group summed,
//                           added into the rotating f32 accumulators;
//                           ring_dkv_kernel at D = 256)
// A ring step pairs the local query shard (global rows q_off + r) with the
// K/V shard that visits it (global columns k_off + c). Semantics per row r
// and column c of one (batch, head); q comes in already scaled:
//   s = q . k  (+ slope[h] * (col - row) with ALiBi)
//   visible iff r < Sq, c < Sk, row >= col, (window <= 0 || row - col < window),
//   and qseg[r] == kseg[c] with segment ids.
//   forward: m' = max(m, max s), alpha = exp(m - m'), p = exp(s - m') for
//   visible keys and exactly 0 for the rest, l' = l alpha + sum p,
//   acc' = acc alpha + p v. The carry starts at m = -1e30 (as the TPU
//   carry does), so a tile no row can see leaves it unchanged (alpha = 1).
//   backward: p = exp(s - lse), dp = do . v, ds = p (dp - delta) rounded to
//   bf16, with the wrapper's delta = sum(do * out) per row; dq += ds k,
//   dk += ds^T q, dv += bf16(p)^T do, each added in f32 into the
//   accumulator it is given (the TPU kernels return one step's values and
//   XLA adds them outside).
//
// Tiles: the key tiles of a query tile fall into a masked head (the window's
// edge), a mask-free middle, and a masked tail (the causal edge), as
// _global_q_ranges bounds them; tiles no row of the block can see are
// skipped, never loaded, so a step above the diagonal launches blocks that
// return at once and adds nothing. Mask-free tiles skip the visibility test.
//
// What bounds it on this card: at qwen2-7b's shard shapes (Sq = Sk = 8192,
// H = 28, KVH = 4, D = 128) each step does 4 D (forward), 6 D (dq) and 8 D
// (dk, dv) flops per visible (q, k) pair against ~0.3 GB of bytes, so all
// three are operation-bound: 0.97 ms (forward), 1.46 ms (dq) and 1.95 ms
// (dk, dv) at the card's 989 TFLOP/s for a full step.
//
// All three are built for that on hopper_tiles.cuh: three warpgroups a
// block, two consumers of 64 rows each and a producer whose one warp streams
// tiles by TMA through a ring of two stages guarded by mbarriers;
// setmaxnreg gives the consumers 240 registers a thread and the producer 24.
// Every product is a wgmma with its f32 accumulator in registers, and p and
// ds go from the score accumulators into the next product's A operand
// without leaving registers.
//   K13 (ring_fwd_wgmma, flash_fwd_wgmma.cuh): a persistent grid, one
//   block an SM, over items of 128 query rows of one head, longest first;
//   Q loaded once an item, K/V tiles of 128 keys (64 at D = 256) stream; per
//   tile S = Q K^T, one element pass (online max and sum, alpha; the two
//   warpgroups take turns in it) and O += bf16(P) V, O in registers for the
//   whole loop. The carry m (natural log), l and acc is read into registers
//   at an item's start and written back at its end; items that see no key
//   are skipped. Registers at D = 128: O 64, S 64, P 32 a thread; at D =
//   256 O 128, S 32, P 16.
//   K14 (ring_dq_wgmma): one block per (128 query rows, head, batch), last
//   query tiles first (they see the most keys of a diagonal step). Q and dO
//   are loaded once; K/V tiles of 128 keys stream. Per tile a consumer runs
//   S = Q K^T (m64n128k16, both operands K-major in shared memory), turns S
//   into p in place, then by halves of 64 keys dP = dO V^T (m64n64k16), ds =
//   p (dP - delta) and dq += ds K (A from registers, K read MN-major).
//   Registers at D = 128: dq 64, S 64 and half a dP 32 f32 a thread.
//   K15 (ring_dkv_wgmma): one block per (128 keys, kv head, batch), first
//   key tiles first. K and V are loaded once; Q/dO tiles of 64 rows stream
//   with their lse, delta and segment ids, over the G query heads of the
//   group and each head's visible query tiles. Transposed, so that keys are
//   the rows: S^T = K Q^T (m64n64k16) becomes P^T in place; then dP^T = V
//   dO^T runs beside dv += bf16(P^T) dO, and dk += dS^T Q follows (m64nDk16,
//   A from registers, dO and Q read MN-major). Registers at D = 128: dk 64,
//   dv 64, S^T 32, dP^T 32 f32 a thread (dP^T is formed after P^T so that
//   the two element passes and the lse/delta loads fit in 240); dk and dv
//   stay in registers over the whole group, which is the GQA sum.
// The element passes are branch-free: ALiBi is a multiply by a slope of 0
// when absent, and only tiles at a mask's edge (tile_masked) test
// visibility, through a separate instantiation of the pass.
// Each block adds its accumulators into the global f32 ones once at the
// end: it owns those rows, so there are no atomics and the summation order
// is fixed (the same bits on every run and across the four-card ring).
// D = 256: the f32 accumulators of K15 do not fit in registers; that head
// dim keeps the wmma backward kernels (ring_dq_kernel, ring_dkv_kernel),
// chosen by head dim in launch(). The forward's O (128 registers) and S at
// 64-key tiles fit, so K13 is the wgmma kernel at every head dim.
//
// Layout: q, do (B, Sq, H, D) and k, v (B, Sk, KVH, D) bf16, read in place
// through batch and row strides (D contiguous, heads D apart; the wgmma
// kernels through one TMA tensor map each, built on the host from those
// strides); m, l, lse, delta (B, H, Sq) f32; acc, dq (B, Sq, H, D) f32;
// dk, dv (B, Sk, KVH, D) f32; qseg (B, Sq) and kseg (B, Sk) int32 or null;
// slopes (H,) f32 or null. The wmma kernels: dq one block per (q tile,
// head, batch); dk/dv one block per (key tile, kv head, batch) that walks
// the G = H / KVH query heads of its group (any G, 7 for qwen2), so the
// group sum happens in the block's f32 accumulators.

#include <cstdint>
#include <type_traits>

#include "attention_tiles.cuh"
#include "flash_fwd_wgmma.cuh"

using namespace attn_tiles;
using flash_fwd::row_index;
using hopper::CONSUMER_REGS;
using hopper::CONSUMERS;
using hopper::LOG2E;
using hopper::PRODUCER_REGS;
using hopper::Ring;
using hopper::STAGES;
using hopper::WG;
using hopper::WG_ROWS;
using hopper::WG_THREADS;
using hopper::align1024;
using hopper::tma_rows;

namespace {

// the forward's fields (q, k, v, masks, the carry m, l, acc, strides, shapes;
// causal always 1), then the backward's
struct Params : flash_fwd::Params {
  const bf16* dout;
  const float* lse;
  const float* delta;
  float* dq;           // backward accumulators
  float* dk;
  float* dv;
  long long dsb, dsr;  // batch and row strides of dout, elements
};

// The backward's masks: the forward's (flash_fwd_wgmma.cuh) with the ring's
// causal mask fixed. The forward's take a causal flag, whose tests made K14
// and K15 about 4 % slower on the card, so the backward keeps its own.
__device__ __forceinline__ bool visible(const Params& p, int r, int c, int qs, int ks) {
  const int row = p.q_off + r, col = p.k_off + c;
  return r < p.Sq && c < p.Sk && row >= col && (p.window <= 0 || row - col < p.window) &&
         (p.qseg == nullptr || qs == ks);
}

// true unless every (row, col) of query tile [r0, r0 + BQ) x key tile
// [c0, c0 + BK) is in bounds and visible without a test
template <int BQ, int BK>
__device__ __forceinline__ bool tile_masked(const Params& p, int r0, int c0) {
  if (p.qseg != nullptr || r0 + BQ > p.Sq || c0 + BK > p.Sk) return true;
  const int row_first = p.q_off + r0, col_first = p.k_off + c0;
  if (col_first + BK - 1 > row_first) return true;                          // causal edge
  return p.window > 0 && row_first + BQ - 1 - col_first >= p.window;        // window edge
}

// the key tiles [lo, hi) that any row of query tile [r0, r0 + BQ) can see
template <int BQ, int BK>
__device__ __forceinline__ void key_range(const Params& p, int r0, int& lo, int& hi) {
  const int nk = (p.Sk + BK - 1) / BK;
  const int c_last = p.q_off + min(r0 + BQ, p.Sq) - 1 - p.k_off;  // causal: col <= row
  hi = c_last < 0 ? 0 : min(nk, c_last / BK + 1);
  lo = 0;
  if (p.window > 0) {                                             // col > row - window
    const int c_first = p.q_off + r0 - p.window + 1 - p.k_off;
    lo = c_first <= 0 ? 0 : min(nk, c_first / BK);
  }
}

// the query tiles [lo, hi) with a row that can see a key of tile [c0, c0 + BK)
template <int BQ, int BK>
__device__ __forceinline__ void query_range(const Params& p, int c0, int& lo, int& hi) {
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int r_first = p.k_off + c0 - p.q_off;                     // causal: row >= col
  lo = r_first <= 0 ? 0 : min(nq, r_first / BQ);
  hi = nq;
  if (p.window > 0) {                                             // row < col + window
    const int r_last = p.k_off + min(c0 + BK, p.Sk) - 1 + p.window - 1 - p.q_off;
    hi = r_last < 0 ? 0 : min(nq, r_last / BQ + 1);
  }
}

// ------------------------------------------------------------ dq (wmma, D = 256)

template <int D, int BQ, int BK>
struct RingDqSmem {
  using L = Ld<D, BK>;
  static constexpr size_t q = 0;
  static constexpr size_t dout = align128(q + sizeof(bf16) * BQ * L::T);
  static constexpr size_t k = align128(dout + sizeof(bf16) * BQ * L::T);
  static constexpr size_t v = align128(k + sizeof(bf16) * BK * L::T);
  static constexpr size_t s = align128(v + sizeof(bf16) * BK * L::T);
  static constexpr size_t dp = align128(s + sizeof(float) * BQ * L::S);
  static constexpr size_t ds = align128(dp + sizeof(float) * BQ * L::S);
  static constexpr size_t dq = align128(ds + sizeof(bf16) * BQ * L::P);
  static constexpr size_t rows = align128(dq + sizeof(float) * BQ * L::O);  // lse, delta
  static constexpr size_t qseg = rows + sizeof(float) * 2 * BQ;
  static constexpr size_t kseg = qseg + sizeof(int) * BQ;
  static constexpr size_t bytes = kseg + sizeof(int) * BK;
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(NTHREADS) ring_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = RingDqSmem<D, BQ, BK>;
  using L = Ld<D, BK>;
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + SM::dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::v);
  float* Ss = reinterpret_cast<float*>(smem + SM::s);
  float* dPs = reinterpret_cast<float*>(smem + SM::dp);
  bf16* dSs = reinterpret_cast<bf16*>(smem + SM::ds);
  float* dQs = reinterpret_cast<float*>(smem + SM::dq);
  float* lse = reinterpret_cast<float*>(smem + SM::rows);
  float* delta = lse + BQ;
  int* qseg = reinterpret_cast<int*>(smem + SM::qseg);
  int* kseg = reinterpret_cast<int*>(smem + SM::kseg);

  const int r0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  key_range<BQ, BK>(p, r0, lo, hi);
  if (lo >= hi) return;  // nothing visible: dq gains 0

  const int kh = h / (p.H / p.KVH);
  const int tid = threadIdx.x;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const bf16* kb = p.k + b * p.ksb + static_cast<size_t>(kh) * D;
  const bf16* vb = p.v + b * p.vsb + static_cast<size_t>(kh) * D;
  const size_t roff = (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const int* qsegb = p.qseg != nullptr ? p.qseg + static_cast<size_t>(b) * p.Sq : nullptr;
  const int* ksegb = p.kseg != nullptr ? p.kseg + static_cast<size_t>(b) * p.Sk : nullptr;

  load_rows<D>(Qs, L::T, p.q + b * p.qsb + static_cast<size_t>(h) * D, p.qsr, r0, BQ, p.Sq);
  load_rows<D>(dOs, L::T, p.dout + b * p.dsb + static_cast<size_t>(h) * D, p.dsr, r0, BQ,
               p.Sq);
  load_vec(lse, p.lse + roff, r0, BQ, p.Sq);
  load_vec(delta, p.delta + roff, r0, BQ, p.Sq);
  load_seg(qseg, qsegb, r0, BQ, p.Sq);
  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int i = e / D, d = e % D;
    dQs[i * L::O + d] = r0 + i < p.Sq ? p.dq[row_index(b, r0 + i, h, p.Sq, p.H, D) + d] : 0.f;
  }

  for (int j = lo; j < hi; ++j) {
    const int c0 = j * BK;
    __syncthreads();
    load_rows<D>(Ks, L::T, kb, p.ksr, c0, BK, p.Sk);
    load_rows<D>(Vs, L::T, vb, p.vsr, c0, BK, p.Sk);
    load_seg(kseg, ksegb, c0, BK, p.Sk);
    __syncthreads();
    gemm_nt<BQ, BK, D>(Ss, L::S, Qs, L::T, Ks, L::T);
    gemm_nt<BQ, BK, D>(dPs, L::S, dOs, L::T, Vs, L::T);
    __syncthreads();
    const bool masked = tile_masked<BQ, BK>(p, r0, c0);
    for (int e = tid; e < BQ * BK; e += NTHREADS) {
      const int i = e / BK, c = e % BK, r = r0 + i, col = c0 + c;
      float x = Ss[i * L::S + c];
      if (p.slopes != nullptr) x += slope * static_cast<float>((p.k_off + col) - (p.q_off + r));
      const bool vis = !masked || visible(p, r, col, qseg[i], kseg[c]);
      const float pj = vis ? expf(x - lse[i]) : 0.f;
      dSs[i * L::P + c] = __float2bfloat16(pj * (dPs[i * L::S + c] - delta[i]));
    }
    __syncthreads();
    gemm_nn_acc<BQ, D, BK>(dQs, L::O, dSs, L::P, Ks, L::T);
  }
  __syncthreads();
  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int i = e / D, d = e % D;
    if (r0 + i < p.Sq) p.dq[row_index(b, r0 + i, h, p.Sq, p.H, D) + d] = dQs[i * L::O + d];
  }
}

// -------------------------------------------------------- dk, dv (wmma, D = 256)

template <int D, int BQ, int BK>
struct RingDkvSmem {
  using L = Ld<D, BK>;
  static constexpr size_t k = 0;
  static constexpr size_t v = align128(k + sizeof(bf16) * BK * L::T);
  static constexpr size_t dk = align128(v + sizeof(bf16) * BK * L::T);
  static constexpr size_t dv = align128(dk + sizeof(float) * BK * L::O);
  static constexpr size_t q = align128(dv + sizeof(float) * BK * L::O);
  static constexpr size_t dout = align128(q + sizeof(bf16) * BQ * L::T);
  static constexpr size_t s = align128(dout + sizeof(bf16) * BQ * L::T);
  static constexpr size_t dp = align128(s + sizeof(float) * BQ * L::S);
  static constexpr size_t pb = align128(dp + sizeof(float) * BQ * L::S);
  static constexpr size_t ds = align128(pb + sizeof(bf16) * BQ * L::P);
  static constexpr size_t rows = align128(ds + sizeof(bf16) * BQ * L::P);  // lse, delta
  static constexpr size_t qseg = rows + sizeof(float) * 2 * BQ;
  static constexpr size_t kseg = qseg + sizeof(int) * BQ;
  static constexpr size_t bytes = kseg + sizeof(int) * BK;
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(NTHREADS) ring_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = RingDkvSmem<D, BQ, BK>;
  using L = Ld<D, BK>;
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::v);
  float* dKs = reinterpret_cast<float*>(smem + SM::dk);
  float* dVs = reinterpret_cast<float*>(smem + SM::dv);
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + SM::dout);
  float* Ss = reinterpret_cast<float*>(smem + SM::s);
  float* dPs = reinterpret_cast<float*>(smem + SM::dp);
  bf16* Ps = reinterpret_cast<bf16*>(smem + SM::pb);
  bf16* dSs = reinterpret_cast<bf16*>(smem + SM::ds);
  float* lse = reinterpret_cast<float*>(smem + SM::rows);
  float* delta = lse + BQ;
  int* qseg = reinterpret_cast<int*>(smem + SM::qseg);
  int* kseg = reinterpret_cast<int*>(smem + SM::kseg);

  const int c0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  int q_lo, q_hi;
  query_range<BQ, BK>(p, c0, q_lo, q_hi);
  if (q_lo >= q_hi) return;  // no row sees this key tile: dk, dv gain 0

  const int G = p.H / p.KVH;
  const int tid = threadIdx.x;
  const int* qsegb = p.qseg != nullptr ? p.qseg + static_cast<size_t>(b) * p.Sq : nullptr;
  const int* ksegb = p.kseg != nullptr ? p.kseg + static_cast<size_t>(b) * p.Sk : nullptr;

  load_rows<D>(Ks, L::T, p.k + b * p.ksb + static_cast<size_t>(kh) * D, p.ksr, c0, BK, p.Sk);
  load_rows<D>(Vs, L::T, p.v + b * p.vsb + static_cast<size_t>(kh) * D, p.vsr, c0, BK, p.Sk);
  load_seg(kseg, ksegb, c0, BK, p.Sk);
  for (int e = tid; e < BK * D; e += NTHREADS) {
    const int i = e / D, d = e % D;
    const bool in = c0 + i < p.Sk;
    const size_t off = row_index(b, c0 + i, kh, p.Sk, p.KVH, D) + d;
    dKs[i * L::O + d] = in ? p.dk[off] : 0.f;
    dVs[i * L::O + d] = in ? p.dv[off] : 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
    const bf16* qb = p.q + b * p.qsb + static_cast<size_t>(h) * D;
    const bf16* db = p.dout + b * p.dsb + static_cast<size_t>(h) * D;
    const size_t roff = (static_cast<size_t>(b) * p.H + h) * p.Sq;
    for (int i0 = q_lo; i0 < q_hi; ++i0) {
      const int r0 = i0 * BQ;
      __syncthreads();  // the previous tile's readers are done with Q, dO, P, dS
      load_rows<D>(Qs, L::T, qb, p.qsr, r0, BQ, p.Sq);
      load_rows<D>(dOs, L::T, db, p.dsr, r0, BQ, p.Sq);
      load_vec(lse, p.lse + roff, r0, BQ, p.Sq);
      load_vec(delta, p.delta + roff, r0, BQ, p.Sq);
      load_seg(qseg, qsegb, r0, BQ, p.Sq);
      __syncthreads();
      gemm_nt<BQ, BK, D>(Ss, L::S, Qs, L::T, Ks, L::T);
      gemm_nt<BQ, BK, D>(dPs, L::S, dOs, L::T, Vs, L::T);
      __syncthreads();
      const bool masked = tile_masked<BQ, BK>(p, r0, c0);
      for (int e = tid; e < BQ * BK; e += NTHREADS) {
        const int i = e / BK, c = e % BK, r = r0 + i, col = c0 + c;
        float x = Ss[i * L::S + c];
        if (p.slopes != nullptr) x += slope * static_cast<float>((p.k_off + col) - (p.q_off + r));
        const bool vis = !masked || visible(p, r, col, qseg[i], kseg[c]);
        const float pj = vis ? expf(x - lse[i]) : 0.f;
        Ps[i * L::P + c] = __float2bfloat16(pj);
        dSs[i * L::P + c] = __float2bfloat16(pj * (dPs[i * L::S + c] - delta[i]));
      }
      __syncthreads();
      gemm_tn_acc<BK, D, BQ>(dVs, L::O, Ps, L::P, dOs, L::T);
      gemm_tn_acc<BK, D, BQ>(dKs, L::O, dSs, L::P, Qs, L::T);
    }
  }
  __syncthreads();
  for (int e = tid; e < BK * D; e += NTHREADS) {
    const int i = e / D, d = e % D;
    if (c0 + i >= p.Sk) continue;
    const size_t off = row_index(b, c0 + i, kh, p.Sk, p.KVH, D) + d;
    p.dk[off] = dKs[i * L::O + d];
    p.dv[off] = dVs[i * L::O + d];
  }
}

// ------------------------------------------- dq and dk/dv with wgmma (D 64, 128)
//
// Three warpgroups a block: two consumers of 64 rows each and a producer, of
// which one warp issues the TMA loads and fills the per-tile vectors; the
// producer gives its registers to the consumers (setmaxnreg 24 / 240).
// Stages are guarded by a full barrier (32 producer arrivals plus the TMA
// bytes) and an empty one (every consumer thread arrives once it is done
// with the stage). Products are wgmma m64nNk16 with f32 accumulators in
// registers; P and dS become the A operand of the second product without
// leaving registers (hopper::a_fragment).

// K14: the block's Q and dO (BQ rows), then a ring of K/V stages with the
// key tile's segment ids. Every tile offset is a multiple of 1024 bytes.
template <int D>
struct DqLayout {
  static constexpr int BQ = CONSUMERS * WG_ROWS, BK = 128;  // BK keys a stage
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + 2 * BQ * D;
  static constexpr size_t kv_tile = 2 * BK * D;
  static constexpr size_t stages = dout + 2 * BQ * D;  // stage s: K, then V
  static constexpr size_t seg = stages + STAGES * 2 * kv_tile;
  static constexpr size_t bars = seg + STAGES * BK * sizeof(int);
  static constexpr size_t bytes = bars + (2 * STAGES + 1) * sizeof(uint64_t) + 1024;
};

// K15: the block's K and V (BK rows), then a ring of Q/dO stages with the
// query tile's lse, delta (both f32) and segment ids.
template <int D>
struct DkvLayout {
  static constexpr int BK = CONSUMERS * WG_ROWS, BQ = 64;  // BQ query rows a stage
  static constexpr size_t k = 0;
  static constexpr size_t v = k + 2 * BK * D;
  static constexpr size_t q_tile = 2 * BQ * D;
  static constexpr size_t stages = v + 2 * BK * D;     // stage s: Q, then dO
  static constexpr size_t rows = stages + STAGES * 2 * q_tile;
  static constexpr size_t bars = rows + STAGES * 3 * BQ * sizeof(float);
  static constexpr size_t bytes = bars + (2 * STAGES + 1) * sizeof(uint64_t) + 1024;
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    ring_dq_wgmma(const Params p, const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo) {
  using SM = DqLayout<D>;
  constexpr int BQ = SM::BQ, BK = SM::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + SM::dout);
  int* ksegs = reinterpret_cast<int*>(smem + SM::seg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* once = empty + STAGES;

  // the last query tiles see the most keys of a diagonal step: start them first
  const int nq = (p.Sq + BQ - 1) / BQ, hb = gridDim.x / nq;
  const int r0 = (nq - 1 - static_cast<int>(blockIdx.x) / hb) * BQ;
  const int h = blockIdx.x % hb % p.H, b = blockIdx.x % hb / p.H;
  int lo, hi;
  key_range<BQ, BK>(p, r0, lo, hi);
  if (lo >= hi) return;  // nothing visible: dq gains 0

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], CONSUMERS * WG);
    }
    hopper::mbar_init(once, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {  // ------------------------------------- producer
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x % WG >= 32) return;
    const int lane = threadIdx.x % 32, kh = h / (p.H / p.KVH);
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(once, 2 * 2 * BQ * D);
      tma_rows<D>(Qs, &tq, once, BQ, h, r0, b);
      tma_rows<D>(dOs, &tdo, once, BQ, h, r0, b);
    }
    const int* ksegb = p.kseg != nullptr ? p.kseg + static_cast<size_t>(b) * p.Sk : nullptr;
    Ring ring;
    for (int j = lo; j < hi; ++j, ring.next()) {
      hopper::mbar_wait(&empty[ring.s], ring.phase ^ 1);
      const int c0 = j * BK;
      int* kseg = ksegs + ring.s * BK;
      for (int i = lane; i < BK; i += 32)
        kseg[i] = ksegb != nullptr && c0 + i < p.Sk ? ksegb[c0 + i] : 0;
      if (lane == 0) {
        bf16* Ks = reinterpret_cast<bf16*>(smem + SM::stages + ring.s * 2 * SM::kv_tile);
        hopper::mbar_arrive_expect_tx(&full[ring.s], 2 * SM::kv_tile);
        tma_rows<D>(Ks, &tk, &full[ring.s], BK, kh, c0, b);
        tma_rows<D>(Ks + BK * D, &tv, &full[ring.s], BK, kh, c0, b);
      } else {
        hopper::mbar_arrive(&full[ring.s]);
      }
    }
  } else {  // ---------------------------------------------------- consumers
    hopper::regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG, lane = t % 32;
    const int rw = r0 + wg * WG_ROWS;               // the warpgroup's first row
    const int ra = rw + (t / 32) * 16 + lane / 4;   // this thread's rows: ra, ra + 8
    int wlo = 0, whi = 0;
    if (rw < p.Sq) key_range<WG_ROWS, BK>(p, rw, wlo, whi);
    const size_t roff = (static_cast<size_t>(b) * p.H + h) * p.Sq;
    float lse[2], delta[2];
    int qseg[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = ra + 8 * u;
      const bool in = r < p.Sq;
      lse[u] = in ? p.lse[roff + r] * LOG2E : 0.f;
      delta[u] = in ? p.delta[roff + r] : 0.f;
      qseg[u] = in && p.qseg != nullptr ? p.qseg[static_cast<size_t>(b) * p.Sq + r] : 0;
    }
    const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
    const uint32_t q_tile = hopper::smem_addr(Qs) + wg * WG_ROWS * 128;
    const uint32_t do_tile = hopper::smem_addr(dOs) + wg * WG_ROWS * 128;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    hopper::mbar_wait(once, 0);

    Ring ring;
    for (int j = lo; j < hi; ++j, ring.next()) {
      hopper::mbar_wait(&full[ring.s], ring.phase);
      if (j >= wlo && j < whi) {
        const int c0 = j * BK;
        const uint32_t k_tile = hopper::smem_addr(smem + SM::stages + ring.s * 2 * SM::kv_tile);
        const uint32_t v_tile = k_tile + SM::kv_tile;
        const int* kseg = ksegs + ring.s * BK;
        // S = Q K^T over the whole key tile (m64n128k16)
        float s[BK / 2];  // written whole by the first product (scale-d 0)
        hopper::fence_regs(s);
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hopper::Wgmma<BK>::template ss<0>(s, hopper::desc_k_major(q_tile, BQ, k),
                                            hopper::desc_k_major(k_tile, BK, k), k > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);

        // p = exp(s - lse) on visible keys, in place of s; branch-free, with the
        // visibility test only on tiles that need it
        const int pos0 = p.k_off + c0 + 2 * (lane % 4) - (p.q_off + ra);  // col - row of s[0]
        auto form_p = [&](auto masked) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int u = (i / 2) % 2, cl = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
            const float alibi = slope * static_cast<float>(pos0 + 8 * (i / 4) + i % 2 - 8 * u);
            s[i] = hopper::exp2_approx((s[i] + alibi) * LOG2E - lse[u]);
            if constexpr (decltype(masked)::value)
              s[i] = visible(p, ra + 8 * u, c0 + cl, qseg[u], kseg[cl]) ? s[i] : 0.f;
          }
        };
        if (tile_masked<WG_ROWS, BK>(p, rw, c0))
          form_p(std::true_type{});
        else
          form_p(std::false_type{});

        // by halves of 64 keys, so that dP's registers stay half a tile: dP =
        // dO V^T (m64n64k16), ds = p (dP - delta) rounded to bf16, and dq += ds K
        // (A from registers, K read MN-major); a half's dq product runs while
        // the next half's dP is formed
        uint32_t ds[BK / 4];
#pragma unroll
        for (int hf = 0; hf < BK / 64; ++hf) {
          float dp[32];  // written whole by the first product (scale-d 0)
          hopper::fence_regs(dp);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
            hopper::Wgmma<64>::template ss<0>(dp, hopper::desc_k_major(do_tile, BQ, k),
                                              hopper::desc_k_major(v_tile + hf * 64 * 128, BK, k),
                                              k > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dp);
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            const int i = 32 * hf + 2 * m;
            ds[16 * hf + m] = hopper::pack_bf16(s[i] * (dp[2 * m] - delta[m % 2]),
                                                s[i + 1] * (dp[2 * m + 1] - delta[m % 2]));
          }
          hopper::fence_regs(ds);
          hopper::fence_regs(dq);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            uint32_t a[4];
            hopper::a_fragment(a, ds, 4 * hf + k);
            hopper::Wgmma<D>::template rs<1>(
                dq, a, hopper::desc_mn_major(k_tile + hf * 64 * 128, BK, k));
          }
          hopper::wgmma_commit();
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(ds);  // the A operand stays put until the product is done
        hopper::fence_regs(dq);
      }
      hopper::mbar_arrive(&empty[ring.s]);
    }

    if (wlo < whi) {  // the block owns its rows: add into dq once, no atomics
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
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    ring_dkv_wgmma(const Params p, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo) {
  using SM = DkvLayout<D>;
  constexpr int BQ = SM::BQ, BK = SM::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::v);
  float* rowv = reinterpret_cast<float*>(smem + SM::rows);  // stage s: lse, delta, qseg
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* once = empty + STAGES;

  // the first key tiles are seen by the most query tiles of a diagonal step
  const int nk = (p.Sk + BK - 1) / BK, hb = gridDim.x / nk;
  const int c0 = static_cast<int>(blockIdx.x) / hb * BK;
  const int kh = blockIdx.x % hb % p.KVH, b = blockIdx.x % hb / p.KVH;
  int q_lo, q_hi;
  query_range<BQ, BK>(p, c0, q_lo, q_hi);
  if (q_lo >= q_hi) return;  // no row sees this key tile: dk, dv gain 0
  const int G = p.H / p.KVH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], CONSUMERS * WG);
    }
    hopper::mbar_init(once, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {  // ------------------------------------- producer
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x % WG >= 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(once, 2 * 2 * BK * D);
      tma_rows<D>(Ks, &tk, once, BK, kh, c0, b);
      tma_rows<D>(Vs, &tv, once, BK, kh, c0, b);
    }
    const int* qsegb = p.qseg != nullptr ? p.qseg + static_cast<size_t>(b) * p.Sq : nullptr;
    Ring ring;
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      const size_t roff = (static_cast<size_t>(b) * p.H + h) * p.Sq;
      for (int i0 = q_lo; i0 < q_hi; ++i0, ring.next()) {
        hopper::mbar_wait(&empty[ring.s], ring.phase ^ 1);
        const int r0 = i0 * BQ;
        float* lse = rowv + ring.s * 3 * BQ;
        float* delta = lse + BQ;
        int* qseg = reinterpret_cast<int*>(delta + BQ);
        for (int i = lane; i < BQ; i += 32) {
          const bool in = r0 + i < p.Sq;
          lse[i] = in ? p.lse[roff + r0 + i] * LOG2E : 0.f;
          delta[i] = in ? p.delta[roff + r0 + i] : 0.f;
          qseg[i] = in && qsegb != nullptr ? qsegb[r0 + i] : 0;
        }
        if (lane == 0) {
          bf16* Qst = reinterpret_cast<bf16*>(smem + SM::stages + ring.s * 2 * SM::q_tile);
          hopper::mbar_arrive_expect_tx(&full[ring.s], 2 * SM::q_tile);
          tma_rows<D>(Qst, &tq, &full[ring.s], BQ, h, r0, b);
          tma_rows<D>(Qst + BQ * D, &tdo, &full[ring.s], BQ, h, r0, b);
        } else {
          hopper::mbar_arrive(&full[ring.s]);
        }
      }
    }
  } else {  // ---------------------------------------------------- consumers
    hopper::regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG, lane = t % 32;
    const int cw = c0 + wg * WG_ROWS;               // the warpgroup's first key
    const int ka = cw + (t / 32) * 16 + lane / 4;   // this thread's keys: ka, ka + 8
    int wlo = 0, whi = 0;
    if (cw < p.Sk) query_range<BQ, WG_ROWS>(p, cw, wlo, whi);
    int kseg[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = ka + 8 * u;
      kseg[u] = c < p.Sk && p.kseg != nullptr ? p.kseg[static_cast<size_t>(b) * p.Sk + c] : 0;
    }
    const uint32_t k_tile = hopper::smem_addr(Ks) + wg * WG_ROWS * 128;
    const uint32_t v_tile = hopper::smem_addr(Vs) + wg * WG_ROWS * 128;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    hopper::mbar_wait(once, 0);

    Ring ring;
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
      for (int i0 = q_lo; i0 < q_hi; ++i0, ring.next()) {
        hopper::mbar_wait(&full[ring.s], ring.phase);
        if (i0 >= wlo && i0 < whi) {
          const int r0 = i0 * BQ;
          const uint32_t q_st = hopper::smem_addr(smem + SM::stages + ring.s * 2 * SM::q_tile);
          const uint32_t do_st = q_st + SM::q_tile;
          const float* lse = rowv + ring.s * 3 * BQ;
          const float* delta = lse + BQ;
          const int* qseg = reinterpret_cast<const int*>(delta + BQ);
          float s[BQ / 2], dp[BQ / 2];  // written whole by the first product (scale-d 0)

          // S^T = K Q^T: keys are the rows
          hopper::fence_regs(s);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
            hopper::Wgmma<BQ>::template ss<0>(s, hopper::desc_k_major(k_tile, BK, k),
                                              hopper::desc_k_major(q_st, BQ, k), k > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(s);

          // P^T = exp(S^T - lse) on visible pairs, in place of S^T, and rounded to
          // bf16 for dv; branch-free, with the visibility test only on tiles that
          // need it; the lse (delta) of a column pair is one 8-byte load
          uint32_t pt[BQ / 4], dst[BQ / 4];
          const int pos0 = p.k_off + ka - (p.q_off + r0 + 2 * (lane % 4));  // col - row of s[0]
          auto form_p = [&](auto masked) {
#pragma unroll
            for (int m = 0; m < BQ / 4; ++m) {
              const int u = m % 2, q2 = 8 * (m / 2) + 2 * (lane % 4);  // columns q2, q2 + 1
              const float2 l2 = *reinterpret_cast<const float2*>(lse + q2);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 2 * m + e;
                const float alibi = slope * static_cast<float>(pos0 + 8 * u - 8 * (m / 2) - e);
                s[i] = hopper::exp2_approx((s[i] + alibi) * LOG2E - (e ? l2.y : l2.x));
                if constexpr (decltype(masked)::value)
                  s[i] = visible(p, r0 + q2 + e, ka + 8 * u, qseg[q2 + e], kseg[u]) ? s[i] : 0.f;
              }
              pt[m] = hopper::pack_bf16(s[2 * m], s[2 * m + 1]);
            }
          };
          if (tile_masked<BQ, WG_ROWS>(p, r0, cw))
            form_p(std::true_type{});
          else
            form_p(std::false_type{});

          // dP^T = V dO^T, and dv += P^T dO (A from registers, dO read MN-major).
          // dP^T is formed only now, so that its registers and S^T's are not both
          // live beside dk and dv while P^T is formed.
          hopper::fence_regs(s);
          hopper::fence_regs(dp);
          hopper::fence_regs(pt);
          hopper::fence_regs(dv);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
            hopper::Wgmma<BQ>::template ss<0>(dp, hopper::desc_k_major(v_tile, BK, k),
                                              hopper::desc_k_major(do_st, BQ, k), k > 0);
#pragma unroll
          for (int k = 0; k < BQ / 16; ++k) {
            uint32_t a[4];
            hopper::a_fragment(a, pt, k);
            hopper::Wgmma<D>::template rs<1>(dv, a, hopper::desc_mn_major(do_st, BQ, k));
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dp);
          hopper::fence_regs(pt);
          hopper::fence_regs(dv);

          // dS^T = P^T (dP^T - delta), rounded to bf16, and dk += dS^T Q
#pragma unroll
          for (int m = 0; m < BQ / 4; ++m) {
            const float2 d2 =
                *reinterpret_cast<const float2*>(delta + 8 * (m / 2) + 2 * (lane % 4));
            dst[m] = hopper::pack_bf16(s[2 * m] * (dp[2 * m] - d2.x),
                                       s[2 * m + 1] * (dp[2 * m + 1] - d2.y));
          }
          hopper::fence_regs(dst);
          hopper::fence_regs(dk);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 0; k < BQ / 16; ++k) {
            uint32_t a[4];
            hopper::a_fragment(a, dst, k);
            hopper::Wgmma<D>::template rs<1>(dk, a, hopper::desc_mn_major(q_st, BQ, k));
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dst);  // the A operand stays put until the product is done
          hopper::fence_regs(dk);
        }
        hopper::mbar_arrive(&empty[ring.s]);
      }
    }

    if (wlo < whi) {  // the block owns its keys: add into dk, dv once, no atomics
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
  }
}

// K13 at D 64, 128 and 256: the forward of flash_fwd_wgmma.cuh on the carry
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    ring_fwd_wgmma(const flash_fwd::Params p, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  flash_fwd::forward<D, flash_fwd::RING>(p, &tq, &tk, &tv);
}

// the four tensor maps of q, k, v, do for blocks of q_rows query rows and
// k_rows keys, then the launch
template <typename Kernel>
cudaError_t launch_wgmma(Kernel kernel, size_t smem, int blocks, const Params& p, int B, int D,
                         int q_rows, int k_rows, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e;
  if ((e = hopper::rows_map(&tq, p.q, D, p.H, p.Sq, B, p.qsr, p.qsb, q_rows)) != cudaSuccess ||
      (e = hopper::rows_map(&tk, p.k, D, p.KVH, p.Sk, B, p.ksr, p.ksb, k_rows)) != cudaSuccess ||
      (e = hopper::rows_map(&tv, p.v, D, p.KVH, p.Sk, B, p.vsr, p.vsb, k_rows)) != cudaSuccess ||
      (e = hopper::rows_map(&tdo, p.dout, D, p.H, p.Sq, B, p.dsr, p.dsb, q_rows)) !=
          cudaSuccess)
    return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<blocks, WG_THREADS, smem, stream>>>(p, tq, tk, tv, tdo);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ launch

// tile sizes per head dim: 64-row tiles, 32 for D = 256 (shared memory)
template <int D> struct Tiles { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

enum Kind { FWD, DQ, DKV };

template <int D>
cudaError_t launch(Kind kind, const Params& p, int B, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  switch (kind) {
    case FWD:
      return flash_fwd::launch<D>(ring_fwd_wgmma<D>, p, B, stream);
    case DQ:
      if constexpr (D <= 128) {
        using SM = DqLayout<D>;
        return launch_wgmma(ring_dq_wgmma<D>, SM::bytes, (p.Sq + SM::BQ - 1) / SM::BQ * p.H * B,
                            p, B, D, SM::BQ, SM::BK, stream);
      } else {
        return launch_kernel(ring_dq_kernel<D, BQ, BK>, RingDqSmem<D, BQ, BK>::bytes,
                             dim3((p.Sq + BQ - 1) / BQ, p.H, B), p, stream);
      }
    case DKV:
      if constexpr (D <= 128) {
        using SM = DkvLayout<D>;
        return launch_wgmma(ring_dkv_wgmma<D>, SM::bytes,
                            (p.Sk + SM::BK - 1) / SM::BK * p.KVH * B, p, B, D, SM::BQ, SM::BK,
                            stream);
      } else {
        return launch_kernel(ring_dkv_kernel<D, BQ, BK>, RingDkvSmem<D, BQ, BK>::bytes,
                             dim3((p.Sk + BK - 1) / BK, p.KVH, B), p, stream);
      }
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(Kind kind, const Params& p, int B, int D, void* stream) {
  if (B <= 0 || B > 65535 || p.Sq <= 0 || p.Sk <= 0 || p.KVH <= 0 || p.H % p.KVH != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(kind, p, B, st);
    case 128: return launch<128>(kind, p, B, st);
    case 256: return launch<256>(kind, p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// what launch<D> runs for `kind`: info[0] 1 for the wgmma kernels, 0 for the
// wmma ones; info[1] the dynamic shared memory of a block, bytes; info[2]
// the threads of a block
template <int D>
void kernel_info(Kind kind, int* info) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  info[0] = 0;
  info[2] = NTHREADS;
  switch (kind) {
    case FWD:
      info[0] = 1;
      info[1] = static_cast<int>(flash_fwd::Layout<D>::bytes);
      info[2] = WG_THREADS;
      return;
    case DQ:
      if constexpr (D <= 128) {
        info[0] = 1;
        info[1] = static_cast<int>(DqLayout<D>::bytes);
        info[2] = WG_THREADS;
      } else {
        info[1] = static_cast<int>(RingDqSmem<D, BQ, BK>::bytes);
      }
      return;
    case DKV:
      if constexpr (D <= 128) {
        info[0] = 1;
        info[1] = static_cast<int>(DkvLayout<D>::bytes);
        info[2] = WG_THREADS;
      } else {
        info[1] = static_cast<int>(RingDkvSmem<D, BQ, BK>::bytes);
      }
      return;
  }
}

// strides: batch and row strides (elements) of q, k, v and do, in that order
Params make_params(const void* q, const void* k, const void* v, const void* slopes,
                   const void* qseg, const void* kseg, const long long* strides, int Sq,
                   int Sk, int H, int KVH, int q_off, int k_off, int window) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.slopes = static_cast<const float*>(slopes);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.qsb = strides[0];
  p.qsr = strides[1];
  p.ksb = strides[2];
  p.ksr = strides[3];
  p.vsb = strides[4];
  p.vsr = strides[5];
  p.dsb = strides[6];
  p.dsr = strides[7];
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KVH = KVH;
  p.q_off = q_off;
  p.k_off = k_off;
  p.window = window;
  p.causal = 1;
  return p;
}

}  // namespace

// All three return the cudaError_t of the launch and update their f32
// outputs in place.
extern "C" int ds_ring_fwd(const void* q, const void* k, const void* v, const void* slopes,
                           const void* qseg, const void* kseg, void* m, void* l, void* acc,
                           const long long* strides, int B, int Sq, int Sk, int H, int KVH,
                           int D, int q_off, int k_off, int window, void* stream) {
  Params p = make_params(q, k, v, slopes, qseg, kseg, strides, Sq, Sk, H, KVH, q_off, k_off,
                         window);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.acc = static_cast<float*>(acc);
  return dispatch(FWD, p, B, D, stream);
}

extern "C" int ds_ring_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, const void* slopes,
                          const void* qseg, const void* kseg, void* dq,
                          const long long* strides, int B, int Sq, int Sk, int H, int KVH,
                          int D, int q_off, int k_off, int window, void* stream) {
  Params p = make_params(q, k, v, slopes, qseg, kseg, strides, Sq, Sk, H, KVH, q_off, k_off,
                         window);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  return dispatch(DQ, p, B, D, stream);
}

extern "C" int ds_ring_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* slopes,
                           const void* qseg, const void* kseg, void* dk, void* dv,
                           const long long* strides, int B, int Sq, int Sk, int H, int KVH,
                           int D, int q_off, int k_off, int window, void* stream) {
  Params p = make_params(q, k, v, slopes, qseg, kseg, strides, Sq, Sk, H, KVH, q_off, k_off,
                         window);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  return dispatch(DKV, p, B, D, stream);
}

// The kernel ds_ring_fwd (kind 0), ds_ring_dq (1) or ds_ring_dkv (2) launches
// at head dim D, as kernel_info describes it; cudaErrorInvalidValue for a
// kind or head dim without one.
extern "C" int ds_ring_kernel_info(int kind, int D, int* info) {
  if (kind < FWD || kind > DKV) return cudaErrorInvalidValue;
  switch (D) {
    case 64: kernel_info<64>(static_cast<Kind>(kind), info); return cudaSuccess;
    case 128: kernel_info<128>(static_cast<Kind>(kind), info); return cudaSuccess;
    case 256: kernel_info<256>(static_cast<Kind>(kind), info); return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}
