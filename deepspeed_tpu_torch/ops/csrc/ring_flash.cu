// One step of ring (context-parallel) flash attention for Hopper (sm_90a):
// the training attention of the port's sequence-parallel path.
//
// Replaces the TPU kernels of deepspeed_tpu/sequence/ring_flash.py:
//   K13 _ring_fwd_kernel -> ring_fwd_kernel (fold one K/V shard into the carry)
//   K14 _ring_dq_kernel  -> ring_dq_kernel  (dq of one step, added into the f32 accumulator)
//   K15 _ring_dkv_kernel -> ring_dkv_kernel (dk, dv of one step, GQA group summed,
//                                            added into the rotating f32 accumulators)
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
//   backward: p = exp(s - lse), dp = do . v, ds = p (dp - delta) with the
//   wrapper's delta = sum(do * out) per row; dq += ds k, dk += ds^T q,
//   dv += p^T do, each added in f32 into the accumulator it is given (the
//   TPU kernels return one step's values and XLA adds them outside).
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
// three are operation-bound. The products run on the tensor cores (wmma,
// bf16 in, f32 accumulate) from shared memory, as in flash_attention.cu;
// wgmma, register accumulators and TMA pipelining are later work.
//
// Layout: q, do (B, Sq, H, D) and k, v (B, Sk, KVH, D) bf16, read in place
// through batch and row strides (D contiguous, heads D apart); m, l, lse,
// delta (B, H, Sq) f32; acc, dq (B, Sq, H, D) f32; dk, dv (B, Sk, KVH, D)
// f32; qseg (B, Sq) and kseg (B, Sk) int32 or null; slopes (H,) f32 or null.
// Forward and dq: one block per (q tile, head, batch). dk/dv: one block per
// (key tile, kv head, batch) that walks the G = H / KVH query heads of its
// group (any G, 7 for qwen2), so the group sum happens in the block's f32
// accumulators.

#include <cstdint>

#include "attention_tiles.cuh"

using namespace attn_tiles;

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU carry's "no key yet" max

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;    // backward
  const float* lse;    // backward
  const float* delta;  // backward
  const float* slopes;
  const int* qseg;
  const int* kseg;
  float* m;            // forward carry
  float* l;
  float* acc;
  float* dq;           // backward accumulators
  float* dk;
  float* dv;
  long long qsb, qsr, ksb, ksr, vsb, vsr, dsb, dsr;  // batch and row strides, elements
  int Sq, Sk, H, KVH, q_off, k_off, window;
};

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

__device__ __forceinline__ size_t acc_index(int b, int r, int h, int S, int H, int D) {
  return ((static_cast<size_t>(b) * S + r) * H + h) * D;
}

// ------------------------------------------------------------------ forward

template <int D, int BQ, int BK>
struct RingFwdSmem : FwdSmem<D, BQ, BK> {
  static constexpr size_t qseg = FwdSmem<D, BQ, BK>::bytes;
  static constexpr size_t kseg = qseg + sizeof(int) * BQ;
  static constexpr size_t bytes = kseg + sizeof(int) * BK;
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(NTHREADS) ring_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = RingFwdSmem<D, BQ, BK>;
  using L = Ld<D, BK>;
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::v);
  float* Ss = reinterpret_cast<float*>(smem + SM::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + SM::p);
  float* Os = reinterpret_cast<float*>(smem + SM::o);
  float* row_m = reinterpret_cast<float*>(smem + SM::rows);
  float* row_l = row_m + BQ;
  float* row_alpha = row_l + BQ;
  int* qseg = reinterpret_cast<int*>(smem + SM::qseg);
  int* kseg = reinterpret_cast<int*>(smem + SM::kseg);

  const int r0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  key_range<BQ, BK>(p, r0, lo, hi);
  if (lo >= hi) return;  // no row sees this shard: the carry stays as it is

  const int kh = h / (p.H / p.KVH);
  const int tid = threadIdx.x;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const bf16* qb = p.q + b * p.qsb + static_cast<size_t>(h) * D;
  const bf16* kb = p.k + b * p.ksb + static_cast<size_t>(kh) * D;
  const bf16* vb = p.v + b * p.vsb + static_cast<size_t>(kh) * D;
  const int* qsegb = p.qseg != nullptr ? p.qseg + static_cast<size_t>(b) * p.Sq : nullptr;
  const int* ksegb = p.kseg != nullptr ? p.kseg + static_cast<size_t>(b) * p.Sk : nullptr;
  const size_t roff = (static_cast<size_t>(b) * p.H + h) * p.Sq;

  load_rows<D>(Qs, L::T, qb, p.qsr, r0, BQ, p.Sq);
  load_seg(qseg, qsegb, r0, BQ, p.Sq);
  for (int i = tid; i < BQ; i += NTHREADS) {
    const bool in = r0 + i < p.Sq;
    row_m[i] = in ? p.m[roff + r0 + i] : NEG_INF;
    row_l[i] = in ? p.l[roff + r0 + i] : 0.f;
  }
  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int i = e / D, d = e % D;
    Os[i * L::O + d] = r0 + i < p.Sq ? p.acc[acc_index(b, r0 + i, h, p.Sq, p.H, D) + d] : 0.f;
  }

  for (int j = lo; j < hi; ++j) {
    const int c0 = j * BK;
    __syncthreads();  // the previous tile's readers are done with K, V, P
    load_rows<D>(Ks, L::T, kb, p.ksr, c0, BK, p.Sk);
    load_rows<D>(Vs, L::T, vb, p.vsr, c0, BK, p.Sk);
    load_seg(kseg, ksegb, c0, BK, p.Sk);
    __syncthreads();
    gemm_nt<BQ, BK, D>(Ss, L::S, Qs, L::T, Ks, L::T);
    __syncthreads();
    const bool masked = tile_masked<BQ, BK>(p, r0, c0);
    online_softmax_step<D, BQ, BK>(Ss, Ps, Os, Vs, row_m, row_l, row_alpha,
                                   [&](int i, int c, float x) {
      const int r = r0 + i, col = c0 + c;
      if (p.slopes != nullptr)
        x += slope * static_cast<float>((p.k_off + col) - (p.q_off + r));
      return (!masked || visible(p, r, col, qseg[i], kseg[c])) ? x : -INFINITY;
    });
  }

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int i = e / D, d = e % D;
    if (r0 + i < p.Sq) p.acc[acc_index(b, r0 + i, h, p.Sq, p.H, D) + d] = Os[i * L::O + d];
  }
  for (int i = tid; i < BQ; i += NTHREADS) {
    if (r0 + i >= p.Sq) continue;
    p.m[roff + r0 + i] = row_m[i];
    p.l[roff + r0 + i] = row_l[i];
  }
}

// ----------------------------------------------------------------------- dq

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
    dQs[i * L::O + d] = r0 + i < p.Sq ? p.dq[acc_index(b, r0 + i, h, p.Sq, p.H, D) + d] : 0.f;
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
    if (r0 + i < p.Sq) p.dq[acc_index(b, r0 + i, h, p.Sq, p.H, D) + d] = dQs[i * L::O + d];
  }
}

// ------------------------------------------------------------------- dk, dv

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
    const size_t off = acc_index(b, c0 + i, kh, p.Sk, p.KVH, D) + d;
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
    const size_t off = acc_index(b, c0 + i, kh, p.Sk, p.KVH, D) + d;
    p.dk[off] = dKs[i * L::O + d];
    p.dv[off] = dVs[i * L::O + d];
  }
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
      return launch_kernel(ring_fwd_kernel<D, BQ, BK>, RingFwdSmem<D, BQ, BK>::bytes,
                           dim3((p.Sq + BQ - 1) / BQ, p.H, B), p, stream);
    case DQ:
      return launch_kernel(ring_dq_kernel<D, BQ, BK>, RingDqSmem<D, BQ, BK>::bytes,
                           dim3((p.Sq + BQ - 1) / BQ, p.H, B), p, stream);
    case DKV:
      return launch_kernel(ring_dkv_kernel<D, BQ, BK>, RingDkvSmem<D, BQ, BK>::bytes,
                           dim3((p.Sk + BK - 1) / BK, p.KVH, B), p, stream);
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
