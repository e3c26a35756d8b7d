// FlashAttention-2 forward and backward for Hopper (sm_90a): the training
// attention of the port.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   K3 _fwd_kernel  -> flash_fwd_kernel  (out, and lse = m + log l per row)
//   K4 _dq_kernel   -> flash_dq_kernel   (dq from q, k, v, do, lse, delta)
//   K5 _dkv_kernel  -> flash_dkv_kernel  (dk, dv; GQA groups summed in f32)
// Semantics, per query row r and key column c of one (batch, head); q comes
// in already scaled (the wrapper folds the softmax scale into q):
//   s = q . k  (+ slope[h] * (c - r) with ALiBi)
//   visible iff c < S, r < S, (!causal || r >= c), (window <= 0 || r - c < window),
//   and seg[r] == seg[c] with segment ids.
//   p = exp(s - m) for visible keys and exactly 0 for the rest, so a
//   masked key never contributes exp(0) = 1 (the TPU kernel masks scores to
//   -1e30 against m = -1e30 instead).
//   backward: p = exp(s - lse), dp = do . v, ds = p * (dp - delta) with
//   delta = sum(do * out) per row (computed by the wrapper), dq = ds k,
//   dk = ds^T q, dv = p^T do.
//
// What bounds it on this card: at gpt2-xl's training shape (S = 1024,
// D = 64, causal) the forward's 4 * D flops per visible (q, k) pair and the
// bytes of q, k, v and out read or written once take about the same least
// time (~254 flops per byte against the H100's ~295); the backward's 6 * D
// (dq) and 8 * D (dk, dv) flops per pair make it operation-bound. Inside a
// block every K/V tile is reused by 64 query rows, so both products of every
// tile run on the tensor cores (wmma, bf16 in, f32 accumulate), and causal
// and sliding-window tiles that no row of the block can see are skipped,
// never loaded. This first version keeps tiles, scores and accumulators in
// shared memory and loads K/V with plain 16-byte vector loads: later work is
// wgmma with register accumulators and TMA double buffering.
//
// Layout: q, out, do, dq (B, S, H, D); k, v, dk, dv (B, S, KVH, D), all bf16;
// lse, delta (B, H, S) f32; seg (B, S) int32 or null; slopes (H,) f32 or null.
// Forward and dq: one block per (q tile, head, batch). dk/dv: one block per
// (key tile, kv head, batch) that walks the G = H / KVH query heads of its
// group, so the group sum happens in the block's f32 accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;  // eight warps (1.2-1.4x faster than four at gpt2-xl shapes)
constexpr int NWARPS = NTHREADS / 32;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;    // backward
  const float* lse;    // backward
  const float* delta;  // backward
  const float* slopes;
  const int* seg;
  bf16* out;           // forward
  float* lse_out;      // forward
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int S, H, KVH, causal, window;
};

// Shared-memory row strides (elements): padded so wmma fragment pointers stay
// 32-byte aligned and consecutive rows do not start on the same bank.
template <int D, int BK>
struct Ld {
  static constexpr int T = D + 8;   // bf16 rows of Q, K, V, dO
  static constexpr int S = BK + 4;  // f32 score rows
  static constexpr int P = BK + 8;  // bf16 probability rows
  static constexpr int O = D + 4;   // f32 accumulator rows
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + n) of a strided (row r at src + r * stride) bf16 matrix
// into shared memory, 16 bytes a thread; rows at or past S are zero
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, size_t stride,
                                          int row0, int n, int S) {
  constexpr int VEC = 8;
  constexpr int DV = D / VEC;
  for (int e = threadIdx.x; e < n * DV; e += NTHREADS) {
    const int i = e / DV, d = (e % DV) * VEC, r = row0 + i;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < S) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * stride + d);
    *reinterpret_cast<uint4*>(dst + i * ld + d) = val;
  }
}

// per-row f32 values [row0, row0 + n) of a (B, H, S) array row; 0 past S
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) dst[i] = row0 + i < S ? src[row0 + i] : 0.f;
}

__device__ __forceinline__ void load_seg(int* dst, const int* seg, int row0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += NTHREADS)
    dst[i] = (seg != nullptr && row0 + i < S) ? seg[row0 + i] : 0;
}

// C[M x N] (f32) = A[M x K] B[N x K]^T; A and B row-major bf16
template <int M, int N, int K>
__device__ __forceinline__ void gemm_nt(float* C, int ldc, const bf16* A, int lda,
                                        const bf16* B, int ldb) {
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * (N / 16); t += NWARPS) {
    const int mi = t / (N / 16), ni = t % (N / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, A + mi * 16 * lda + k0, lda);
      wmma::load_matrix_sync(b, B + ni * 16 * ldb + k0, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + mi * 16 * ldc + ni * 16, acc, ldc, wmma::mem_row_major);
  }
}

// C[M x N] (f32) += A[M x K] B[K x N]; A and B row-major bf16
template <int M, int N, int K>
__device__ __forceinline__ void gemm_nn_acc(float* C, int ldc, const bf16* A, int lda,
                                            const bf16* B, int ldb) {
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * (N / 16); t += NWARPS) {
    const int mi = t / (N / 16), ni = t % (N / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + mi * 16 * ldc + ni * 16, ldc, wmma::mem_row_major);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + mi * 16 * lda + k0, lda);
      wmma::load_matrix_sync(b, B + k0 * ldb + ni * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + mi * 16 * ldc + ni * 16, acc, ldc, wmma::mem_row_major);
  }
}

// C[M x N] (f32) += A^T B with A stored [K x M] row-major and B [K x N]
// row-major, bf16
template <int M, int N, int K>
__device__ __forceinline__ void gemm_tn_acc(float* C, int ldc, const bf16* A, int lda,
                                            const bf16* B, int ldb) {
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * (N / 16); t += NWARPS) {
    const int mi = t / (N / 16), ni = t % (N / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + mi * 16 * ldc + ni * 16, ldc, wmma::mem_row_major);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + k0 * lda + mi * 16, lda);
      wmma::load_matrix_sync(b, B + k0 * ldb + ni * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + mi * 16 * ldc + ni * 16, acc, ldc, wmma::mem_row_major);
  }
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col, int qseg, int kseg) {
  return row < p.S && col < p.S && (!p.causal || row >= col) &&
         (p.window <= 0 || row - col < p.window) && (p.seg == nullptr || qseg == kseg);
}

// the key tiles [lo, hi) any row of q tile [r0, r0 + BQ) can see
template <int BQ, int BK>
__device__ __forceinline__ void key_range(const Params& p, int r0, int& lo, int& hi) {
  const int nk = (p.S + BK - 1) / BK;
  hi = p.causal ? min(nk, (r0 + BQ - 1) / BK + 1) : nk;
  lo = p.window > 0 ? max(0, r0 - p.window + 1) / BK : 0;
}

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// ------------------------------------------------------------------ forward

template <int D, int BQ, int BK>
struct FwdSmem {
  using L = Ld<D, BK>;
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(bf16) * BQ * L::T);
  static constexpr size_t v = align128(k + sizeof(bf16) * BK * L::T);
  static constexpr size_t s = align128(v + sizeof(bf16) * BK * L::T);
  static constexpr size_t p = align128(s + sizeof(float) * BQ * L::S);
  static constexpr size_t o = align128(p + sizeof(bf16) * BQ * L::P);
  static constexpr size_t rows = align128(o + sizeof(float) * BQ * L::O);  // m, l, alpha
  static constexpr size_t qseg = rows + sizeof(float) * 3 * BQ;
  static constexpr size_t kseg = qseg + sizeof(int) * BQ;
  static constexpr size_t bytes = kseg + sizeof(int) * BK;
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = FwdSmem<D, BQ, BK>;
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
  const int kh = h / (p.H / p.KVH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const size_t qstride = static_cast<size_t>(p.H) * D, kstride = static_cast<size_t>(p.KVH) * D;
  const bf16* qb = p.q + (static_cast<size_t>(b) * p.S * p.H + h) * D;
  const bf16* kb = p.k + (static_cast<size_t>(b) * p.S * p.KVH + kh) * D;
  const bf16* vb = p.v + (static_cast<size_t>(b) * p.S * p.KVH + kh) * D;
  const int* segb = p.seg != nullptr ? p.seg + static_cast<size_t>(b) * p.S : nullptr;

  load_rows<D>(Qs, L::T, qb, qstride, r0, BQ, p.S);
  load_seg(qseg, segb, r0, BQ, p.S);
  for (int i = tid; i < BQ; i += NTHREADS) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }
  for (int e = tid; e < BQ * D; e += NTHREADS) Os[(e / D) * L::O + e % D] = 0.f;
  int lo, hi;
  key_range<BQ, BK>(p, r0, lo, hi);

  for (int j = lo; j < hi; ++j) {
    const int c0 = j * BK;
    __syncthreads();  // the previous tile's readers are done with K, V, P
    load_rows<D>(Ks, L::T, kb, kstride, c0, BK, p.S);
    load_rows<D>(Vs, L::T, vb, kstride, c0, BK, p.S);
    load_seg(kseg, segb, c0, BK, p.S);
    __syncthreads();
    gemm_nt<BQ, BK, D>(Ss, L::S, Qs, L::T, Ks, L::T);
    __syncthreads();
    // one warp per row: bias, mask, online-softmax update
    for (int i = warp; i < BQ; i += NWARPS) {
      const int row = r0 + i;
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) {
        const int col = c0 + c;
        float x = Ss[i * L::S + c];
        if (p.slopes != nullptr) x += slope * static_cast<float>(col - row);
        x = visible(p, row, col, qseg[i], kseg[c]) ? x : -INFINITY;
        Ss[i * L::S + c] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_old = row_m[i];
      const float m_new = fmaxf(m_old, mx);
      // nothing visible yet: keep the (zero) state as it is
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float x = Ss[i * L::S + c];
        const float pj = x == -INFINITY ? 0.f : expf(x - m_new);
        Ps[i * L::P + c] = __float2bfloat16(pj);
        sum += pj;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        row_m[i] = m_new;
        row_l[i] = row_l[i] * alpha + sum;
        row_alpha[i] = alpha;
      }
    }
    __syncthreads();
    for (int e = tid; e < BQ * D; e += NTHREADS) Os[(e / D) * L::O + e % D] *= row_alpha[e / D];
    __syncthreads();
    gemm_nn_acc<BQ, D, BK>(Os, L::O, Ps, L::P, Vs, L::T);
  }
  __syncthreads();

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int i = e / D, d = e % D, r = r0 + i;
    if (r >= p.S) continue;
    const float l = row_l[i];
    const float o = l > 0.f ? Os[i * L::O + d] / l : 0.f;
    p.out[(static_cast<size_t>(b) * p.S + r) * qstride + static_cast<size_t>(h) * D + d] =
        __float2bfloat16(o);
  }
  for (int i = tid; i < BQ; i += NTHREADS) {
    const int r = r0 + i;
    if (r >= p.S) continue;
    // a row with no visible key (none in practice: every row sees itself)
    // gets +inf, so the backward's exp(s - lse) is 0 there
    p.lse_out[(static_cast<size_t>(b) * p.H + h) * p.S + r] =
        row_l[i] > 0.f ? row_m[i] + logf(row_l[i]) : INFINITY;
  }
}

// ----------------------------------------------------------------------- dq

template <int D, int BQ, int BK>
struct DqSmem {
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
__global__ void __launch_bounds__(NTHREADS) flash_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = DqSmem<D, BQ, BK>;
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
  const int kh = h / (p.H / p.KVH);
  const int tid = threadIdx.x;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const size_t qstride = static_cast<size_t>(p.H) * D, kstride = static_cast<size_t>(p.KVH) * D;
  const size_t qoff = (static_cast<size_t>(b) * p.S * p.H + h) * D;
  const size_t koff = (static_cast<size_t>(b) * p.S * p.KVH + kh) * D;
  const size_t roff = (static_cast<size_t>(b) * p.H + h) * p.S;
  const int* segb = p.seg != nullptr ? p.seg + static_cast<size_t>(b) * p.S : nullptr;

  load_rows<D>(Qs, L::T, p.q + qoff, qstride, r0, BQ, p.S);
  load_rows<D>(dOs, L::T, p.dout + qoff, qstride, r0, BQ, p.S);
  load_vec(lse, p.lse + roff, r0, BQ, p.S);
  load_vec(delta, p.delta + roff, r0, BQ, p.S);
  load_seg(qseg, segb, r0, BQ, p.S);
  for (int e = tid; e < BQ * D; e += NTHREADS) dQs[(e / D) * L::O + e % D] = 0.f;
  int lo, hi;
  key_range<BQ, BK>(p, r0, lo, hi);

  for (int j = lo; j < hi; ++j) {
    const int c0 = j * BK;
    __syncthreads();
    load_rows<D>(Ks, L::T, p.k + koff, kstride, c0, BK, p.S);
    load_rows<D>(Vs, L::T, p.v + koff, kstride, c0, BK, p.S);
    load_seg(kseg, segb, c0, BK, p.S);
    __syncthreads();
    gemm_nt<BQ, BK, D>(Ss, L::S, Qs, L::T, Ks, L::T);
    gemm_nt<BQ, BK, D>(dPs, L::S, dOs, L::T, Vs, L::T);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += NTHREADS) {
      const int i = e / BK, c = e % BK, row = r0 + i, col = c0 + c;
      float x = Ss[i * L::S + c];
      if (p.slopes != nullptr) x += slope * static_cast<float>(col - row);
      const float pj = visible(p, row, col, qseg[i], kseg[c]) ? expf(x - lse[i]) : 0.f;
      dSs[i * L::P + c] = __float2bfloat16(pj * (dPs[i * L::S + c] - delta[i]));
    }
    __syncthreads();
    gemm_nn_acc<BQ, D, BK>(dQs, L::O, dSs, L::P, Ks, L::T);
  }
  __syncthreads();
  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int i = e / D, d = e % D, r = r0 + i;
    if (r >= p.S) continue;
    p.dq[qoff + static_cast<size_t>(r) * qstride + d] = __float2bfloat16(dQs[i * L::O + d]);
  }
}

// ------------------------------------------------------------------- dk, dv

template <int D, int BQ, int BK>
struct DkvSmem {
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
__global__ void __launch_bounds__(NTHREADS) flash_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = DkvSmem<D, BQ, BK>;
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
  const int G = p.H / p.KVH;
  const int tid = threadIdx.x;
  const size_t qstride = static_cast<size_t>(p.H) * D, kstride = static_cast<size_t>(p.KVH) * D;
  const size_t koff = (static_cast<size_t>(b) * p.S * p.KVH + kh) * D;
  const int* segb = p.seg != nullptr ? p.seg + static_cast<size_t>(b) * p.S : nullptr;

  load_rows<D>(Ks, L::T, p.k + koff, kstride, c0, BK, p.S);
  load_rows<D>(Vs, L::T, p.v + koff, kstride, c0, BK, p.S);
  load_seg(kseg, segb, c0, BK, p.S);
  for (int e = tid; e < BK * D; e += NTHREADS) {
    dKs[(e / D) * L::O + e % D] = 0.f;
    dVs[(e / D) * L::O + e % D] = 0.f;
  }
  // the q tiles that can see any key of this tile: causal rows start at the
  // tile's first key; a window ends them window - 1 rows after its last key
  const int nq = (p.S + BQ - 1) / BQ;
  const int q_lo = p.causal ? c0 / BQ : 0;
  const int q_hi = p.window > 0 ? min(nq, (c0 + BK - 1 + p.window - 1) / BQ + 1) : nq;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
    const size_t qoff = (static_cast<size_t>(b) * p.S * p.H + h) * D;
    const size_t roff = (static_cast<size_t>(b) * p.H + h) * p.S;
    for (int i0 = q_lo; i0 < q_hi; ++i0) {
      const int r0 = i0 * BQ;
      __syncthreads();  // the previous tile's readers are done with Q, dO, P, dS
      load_rows<D>(Qs, L::T, p.q + qoff, qstride, r0, BQ, p.S);
      load_rows<D>(dOs, L::T, p.dout + qoff, qstride, r0, BQ, p.S);
      load_vec(lse, p.lse + roff, r0, BQ, p.S);
      load_vec(delta, p.delta + roff, r0, BQ, p.S);
      load_seg(qseg, segb, r0, BQ, p.S);
      __syncthreads();
      gemm_nt<BQ, BK, D>(Ss, L::S, Qs, L::T, Ks, L::T);
      gemm_nt<BQ, BK, D>(dPs, L::S, dOs, L::T, Vs, L::T);
      __syncthreads();
      for (int e = tid; e < BQ * BK; e += NTHREADS) {
        const int i = e / BK, c = e % BK, row = r0 + i, col = c0 + c;
        float x = Ss[i * L::S + c];
        if (p.slopes != nullptr) x += slope * static_cast<float>(col - row);
        const float pj = visible(p, row, col, qseg[i], kseg[c]) ? expf(x - lse[i]) : 0.f;
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
    const int i = e / D, d = e % D, c = c0 + i;
    if (c >= p.S) continue;
    const size_t off = koff + static_cast<size_t>(c) * kstride + d;
    p.dk[off] = __float2bfloat16(dKs[i * L::O + d]);
    p.dv[off] = __float2bfloat16(dVs[i * L::O + d]);
  }
}

// ------------------------------------------------------------------ launch

// tile sizes per head dim: 64-row tiles, 32 for D = 256 (shared memory)
template <int D> struct Tiles { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

enum Kind { FWD, DQ, DKV };

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, dim3 grid, const Params& p,
                          cudaStream_t stream) {
  // the attribute belongs to the current device: set it on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(Kind kind, const Params& p, int B, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  switch (kind) {
    case FWD:
      return launch_kernel(flash_fwd_kernel<D, BQ, BK>, FwdSmem<D, BQ, BK>::bytes,
                           dim3((p.S + BQ - 1) / BQ, p.H, B), p, stream);
    case DQ:
      return launch_kernel(flash_dq_kernel<D, BQ, BK>, DqSmem<D, BQ, BK>::bytes,
                           dim3((p.S + BQ - 1) / BQ, p.H, B), p, stream);
    case DKV:
      return launch_kernel(flash_dkv_kernel<D, BQ, BK>, DkvSmem<D, BQ, BK>::bytes,
                           dim3((p.S + BK - 1) / BK, p.KVH, B), p, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(Kind kind, const Params& p, int B, int D, void* stream) {
  if (B <= 0 || p.S <= 0 || p.KVH <= 0 || p.H % p.KVH != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(kind, p, B, st);
    case 128: return launch<128>(kind, p, B, st);
    case 256: return launch<256>(kind, p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* slopes,
                   const void* seg, int S, int H, int KVH, int causal, int window) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.slopes = static_cast<const float*>(slopes);
  p.seg = static_cast<const int*>(seg);
  p.S = S;
  p.H = H;
  p.KVH = KVH;
  p.causal = causal;
  p.window = window;
  return p;
}

}  // namespace

// All three return the cudaError_t of the launch. bf16 q/k/v/out/do/dq/dk/dv.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, const void* slopes,
                            const void* seg, void* out, void* lse, int B, int S, int H,
                            int KVH, int D, int causal, int window, void* stream) {
  Params p = make_params(q, k, v, slopes, seg, S, H, KVH, causal, window);
  p.out = static_cast<bf16*>(out);
  p.lse_out = static_cast<float*>(lse);
  return dispatch(FWD, p, B, D, stream);
}

extern "C" int ds_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* slopes,
                           const void* seg, void* dq, int B, int S, int H, int KVH, int D,
                           int causal, int window, void* stream) {
  Params p = make_params(q, k, v, slopes, seg, S, H, KVH, causal, window);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  return dispatch(DQ, p, B, D, stream);
}

extern "C" int ds_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* slopes,
                            const void* seg, void* dk, void* dv, int B, int S, int H,
                            int KVH, int D, int causal, int window, void* stream) {
  Params p = make_params(q, k, v, slopes, seg, S, H, KVH, causal, window);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  return dispatch(DKV, p, B, D, stream);
}
