// FlashAttention-2 forward and backward for Hopper (sm_90a): the training
// attention of the port.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   K3 _fwd_kernel  -> flash_fwd_wgmma   (out, and lse = m + log l per row;
//                      the forward of flash_fwd_wgmma.cuh in mode FLASH)
//   K4 _dq_kernel   -> flash_dq_wgmma    (dq from q, k, v, do, lse, delta;
//                      the dq of flash_bwd_wgmma.cuh in mode FLASH;
//                      flash_dq_kernel at D = 256)
//   K5 _dkv_kernel  -> flash_dkv_wgmma   (dk, dv; GQA groups summed in f32
//                      registers; the dk/dv of flash_bwd_wgmma.cuh in mode
//                      FLASH; flash_dkv_kernel at D = 256)
// Semantics, per query row r and key column c of one (batch, head); q comes
// in already scaled (the wrapper folds the softmax scale into q):
//   s = q . k  (+ slope[h] * (c - r) with ALiBi)
//   visible iff c < S, r < S, (!causal || r >= c), (window <= 0 || r - c < window),
//   and seg[r] == seg[c] with segment ids.
//   p = exp(s - m) for visible keys and exactly 0 for the rest, so a
//   masked key never contributes exp(0) = 1 (the TPU kernel masks scores to
//   -1e30 against m = -1e30 instead).
//   backward: p = exp(s - lse), dp = do . v, ds = p * (dp - delta) with
//   delta = sum(do * out) per row (computed by the wrapper), ds rounded to
//   bf16 before dq = ds k and dk = ds^T q, p to bf16 before dv = p^T do.
//
// What bounds it on this card: at gpt2-xl's training shape (S = 1024,
// D = 64, causal) the forward's 4 * D flops per visible (q, k) pair and the
// bytes of q, k, v and out read or written once take about the same least
// time (~254 flops per byte against the H100's ~295: bytes-bound by a
// hair, 0.032 ms); the backward's 6 * D (dq) and 8 * D (dk, dv) flops per
// pair make it operation-bound (0.041 and 0.054 ms).
// The forward is the Hopper design of flash_fwd_wgmma.cuh at every head dim
// (D 64, 128 and 256): a persistent grid, one block an SM (the 240-register
// consumers fill the register file), over items of 128 query rows of one
// (batch, head), longest first; two consumer warpgroups of 64 rows with O in
// registers and a producer warp that TMA-loads an item's Q and streams K/V
// tiles of 128 keys (64 at D = 256) through two mbarrier-guarded stages;
// S = Q K^T and O += bf16(P) V are wgmma products, the softmax one pass in
// registers that the two warpgroups take in turns. At gpt2-xl's shape an
// item walks 1-8 key tiles (1,600 items, about 12 a block), so the next
// item's Q and K/V loads overlap the current item's last products and its
// epilogue (bf16 out, lse).
// The backward at D 64 and 128 is the Hopper design of flash_bwd_wgmma.cuh,
// the mainloops of the ring's K14 and K15 at offset 0 with causal as a
// template parameter: persistent, items of 128 query rows (dq; K/V tiles of
// 128 keys stream) or 128 keys (dk/dv; Q/dO tiles of 64 rows stream over the
// G heads of the group), every product a wgmma with its f32 accumulator in
// registers, and each block writing its rows once in bf16. At D = 256 dk
// and dv do not fit a consumer's registers, so the backward there is still
// the first design: wmma products from shared memory, tiles, scores and
// accumulators in shared memory, K/V by plain 16-byte vector loads, causal
// and sliding-window tiles that no row of the block can see skipped.
//
// Layout: q, out, do, dq (B, S, H, D); k, v, dk, dv (B, S, KVH, D), all bf16;
// lse, delta (B, H, S) f32; seg (B, S) int32 or null; slopes (H,) f32 or null.
// The wmma backward (D = 256): dq one block per (q tile, head, batch); dk/dv
// one block per (key tile, kv head, batch) that walks the G = H / KVH query
// heads of its group, so the group sum happens in the block's f32
// accumulators.

#include <cstdint>

#include "attention_tiles.cuh"
#include "flash_bwd_wgmma.cuh"

using namespace attn_tiles;

namespace {

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

// ----------------------------------------------------------- dq (wmma, D = 256)

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

// ------------------------------------------------------- dk, dv (wmma, D = 256)

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

// K3 at D 64, 128 and 256: the forward of flash_fwd_wgmma.cuh from an empty state
template <int D>
__global__ void __launch_bounds__(hopper::WG_THREADS, 1)
    flash_fwd_wgmma(const flash_fwd::Params p, const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  flash_fwd::forward<D, flash_fwd::FLASH>(p, &tq, &tk, &tv);
}

// K4 and K5 at D 64 and 128: the backward of flash_bwd_wgmma.cuh, bf16 results
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(hopper::WG_THREADS, 1)
    flash_dq_wgmma(const flash_bwd::Params p, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo) {
  flash_bwd::backward_dq<D, flash_bwd::FLASH, CAUSAL>(p, &tq, &tk, &tv, &tdo);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(hopper::WG_THREADS, 1)
    flash_dkv_wgmma(const flash_bwd::Params p, const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo) {
  flash_bwd::backward_dkv<D, flash_bwd::FLASH, CAUSAL>(p, &tq, &tk, &tv, &tdo);
}

// the forward's view of contiguous (B, S, heads, D) tensors at offset 0
flash_fwd::Params fwd_params(const Params& p, int D) {
  flash_fwd::Params f = {};
  f.q = p.q;
  f.k = p.k;
  f.v = p.v;
  f.slopes = p.slopes;
  f.qseg = f.kseg = p.seg;
  f.out = p.out;
  f.lse_out = p.lse_out;
  f.qsr = static_cast<long long>(p.H) * D;
  f.ksr = f.vsr = static_cast<long long>(p.KVH) * D;
  f.qsb = f.qsr * p.S;
  f.ksb = f.vsb = f.ksr * p.S;
  f.Sq = f.Sk = p.S;
  f.H = p.H;
  f.KVH = p.KVH;
  f.window = p.window;
  f.causal = p.causal;
  return f;
}

// the backward's view: the forward's, with do read as q is and the bf16 results
flash_bwd::Params bwd_params(const Params& p, int D) {
  flash_bwd::Params f = {};
  static_cast<flash_fwd::Params&>(f) = fwd_params(p, D);
  f.dout = p.dout;
  f.lse = p.lse;
  f.delta = p.delta;
  f.dq_out = p.dq;
  f.dk_out = p.dk;
  f.dv_out = p.dv;
  f.dsr = f.qsr;
  f.dsb = f.qsb;
  return f;
}

// the wgmma backward of p.causal: causal_kernel (CAUSAL true) or full_kernel
template <int D, bool DKV, typename Kernel>
cudaError_t launch_bwd(Kernel causal_kernel, Kernel full_kernel, const Params& p, int B,
                       cudaStream_t stream) {
  return flash_bwd::launch<D, flash_bwd::FLASH, DKV>(p.causal ? causal_kernel : full_kernel,
                                                     bwd_params(p, D), B, stream);
}

// ------------------------------------------------------------------ launch

// the wmma backward's tiles (D = 256): 32 rows, for shared memory
constexpr int BQ256 = 32, BK256 = 32;

enum Kind { FWD, DQ, DKV };

template <int D>
cudaError_t launch(Kind kind, const Params& p, int B, cudaStream_t stream) {
  switch (kind) {
    case FWD:
      return flash_fwd::launch<D>(flash_fwd_wgmma<D>, fwd_params(p, D), B, stream);
    case DQ:
      if constexpr (D <= 128)
        return launch_bwd<D, false>(flash_dq_wgmma<D, true>, flash_dq_wgmma<D, false>, p, B,
                                    stream);
      else
        return launch_kernel(flash_dq_kernel<D, BQ256, BK256>, DqSmem<D, BQ256, BK256>::bytes,
                             dim3((p.S + BQ256 - 1) / BQ256, p.H, B), p, stream);
    case DKV:
      if constexpr (D <= 128)
        return launch_bwd<D, true>(flash_dkv_wgmma<D, true>, flash_dkv_wgmma<D, false>, p, B,
                                   stream);
      else
        return launch_kernel(flash_dkv_kernel<D, BQ256, BK256>, DkvSmem<D, BQ256, BK256>::bytes,
                             dim3((p.S + BK256 - 1) / BK256, p.KVH, B), p, stream);
  }
  return cudaErrorInvalidValue;
}

// what launch<D> runs for `kind`: info[0] 1 for the wgmma kernels, 0 for the
// wmma ones; info[1] the dynamic shared memory of a block, bytes; info[2]
// the threads of a block
template <int D>
void kernel_info(Kind kind, int* info) {
  info[0] = 1;
  info[2] = hopper::WG_THREADS;
  switch (kind) {
    case FWD: info[1] = static_cast<int>(flash_fwd::Layout<D>::bytes); return;
    case DQ:
      if constexpr (D <= 128) {
        info[1] = static_cast<int>(flash_bwd::Layout<flash_bwd::FLASH, false, D>::bytes);
      } else {
        info[0] = 0;
        info[1] = static_cast<int>(DqSmem<D, BQ256, BK256>::bytes);
        info[2] = NTHREADS;
      }
      return;
    case DKV:
      if constexpr (D <= 128) {
        info[1] = static_cast<int>(flash_bwd::Layout<flash_bwd::FLASH, true, D>::bytes);
      } else {
        info[0] = 0;
        info[1] = static_cast<int>(DkvSmem<D, BQ256, BK256>::bytes);
        info[2] = NTHREADS;
      }
      return;
  }
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

// The kernel ds_flash_fwd (kind 0), ds_flash_dq (1) or ds_flash_dkv (2)
// launches at head dim D, as kernel_info describes it; cudaErrorInvalidValue
// for a kind or head dim without one.
extern "C" int ds_flash_kernel_info(int kind, int D, int* info) {
  if (kind < FWD || kind > DKV) return cudaErrorInvalidValue;
  switch (D) {
    case 64: kernel_info<64>(static_cast<Kind>(kind), info); return cudaSuccess;
    case 128: kernel_info<128>(static_cast<Kind>(kind), info); return cudaSuccess;
    case 256: kernel_info<256>(static_cast<Kind>(kind), info); return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}
