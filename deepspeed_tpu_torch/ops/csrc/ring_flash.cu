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
//   K13 (ring_fwd_wgmma): the forward of flash_fwd_wgmma.cuh in mode RING,
//   persistent, items of 128 query rows longest first; the carry is read at
//   an item's start and written back at its end.
//   K14 (ring_dq_wgmma) and K15 (ring_dkv_wgmma): the backward mainloops of
//   flash_bwd_wgmma.cuh in mode RING (always causal, one block per item of
//   128 query rows (dq) or 128 keys (dk, dv), the f32 accumulators added
//   into once at the block's end), the same mainloops that K4 and K5 run in
//   mode FLASH. That header describes the design.
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

#include "attention_tiles.cuh"
#include "flash_bwd_wgmma.cuh"

using namespace attn_tiles;
using flash_bwd::RING;
using flash_fwd::row_index;
using hopper::WG_THREADS;

namespace {

// the forward's fields (q, k, v, masks, the carry m, l, acc, strides, shapes;
// causal always 1), then the backward's (dout, lse, delta, the f32
// accumulators dq, dk, dv); the masks are flash_bwd's, causal
using Params = flash_bwd::Params;

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
  flash_bwd::key_range<true, BQ, BK>(p, r0, lo, hi);
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
    const bool masked = flash_bwd::tile_masked<true, BQ, BK>(p, r0, c0);
    for (int e = tid; e < BQ * BK; e += NTHREADS) {
      const int i = e / BK, c = e % BK, r = r0 + i, col = c0 + c;
      float x = Ss[i * L::S + c];
      if (p.slopes != nullptr) x += slope * static_cast<float>((p.k_off + col) - (p.q_off + r));
      const bool vis = !masked || flash_bwd::visible<true>(p, r, col, qseg[i], kseg[c]);
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
  flash_bwd::query_range<true, BQ, BK>(p, c0, q_lo, q_hi);
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
      const bool masked = flash_bwd::tile_masked<true, BQ, BK>(p, r0, c0);
      for (int e = tid; e < BQ * BK; e += NTHREADS) {
        const int i = e / BK, c = e % BK, r = r0 + i, col = c0 + c;
        float x = Ss[i * L::S + c];
        if (p.slopes != nullptr) x += slope * static_cast<float>((p.k_off + col) - (p.q_off + r));
        const bool vis = !masked || flash_bwd::visible<true>(p, r, col, qseg[i], kseg[c]);
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

// K14 and K15 at D 64 and 128: the backward of flash_bwd_wgmma.cuh on the
// f32 accumulators
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    ring_dq_wgmma(const Params p, const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo) {
  flash_bwd::backward_dq<D, RING, true>(p, &tq, &tk, &tv, &tdo);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    ring_dkv_wgmma(const Params p, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo) {
  flash_bwd::backward_dkv<D, RING, true>(p, &tq, &tk, &tv, &tdo);
}

// K13 at D 64, 128 and 256: the forward of flash_fwd_wgmma.cuh on the carry
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    ring_fwd_wgmma(const flash_fwd::Params p, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  flash_fwd::forward<D, flash_fwd::RING>(p, &tq, &tk, &tv);
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
        return flash_bwd::launch<D, RING, false>(ring_dq_wgmma<D>, p, B, stream);
      } else {
        return launch_kernel(ring_dq_kernel<D, BQ, BK>, RingDqSmem<D, BQ, BK>::bytes,
                             dim3((p.Sq + BQ - 1) / BQ, p.H, B), p, stream);
      }
    case DKV:
      if constexpr (D <= 128) {
        return flash_bwd::launch<D, RING, true>(ring_dkv_wgmma<D>, p, B, stream);
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
        info[1] = static_cast<int>(flash_bwd::Layout<flash_bwd::RING, false, D>::bytes);
        info[2] = WG_THREADS;
      } else {
        info[1] = static_cast<int>(RingDqSmem<D, BQ, BK>::bytes);
      }
      return;
    case DKV:
      if constexpr (D <= 128) {
        info[0] = 1;
        info[1] = static_cast<int>(flash_bwd::Layout<flash_bwd::RING, true, D>::bytes);
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
