// Block-sparse flash attention forward for Hopper (sm_90a): K11.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/sparse_flash.py
// (_kernel, launched by sparse_flash_attention through _fwd_kernel_call):
// sparse_fwd_wgmma, the forward of flash_fwd_wgmma.cuh in mode SPARSE.
// Semantics, per query row r of one (batch, head), over the keys of its
// query tile's live blocks only:
//   s = (q . k) * scale in f32 (scale after the dot, as the TPU kernel),
//   p = exp(s - m) for keys whose mask bit is set and exactly 0 for the rest,
//   online softmax, p rounded to bf16 before P.V while l sums the f32 p,
//   out = acc / l (0 where l = 0: a row that sees no key outputs 0; the TPU
//   kernel instead averages the V rows it visited).
// The layout comes compiled by ops/sparse_flash.py compile_key_blocks, once
// per layout: for each 128-row query tile, the 16-key blocks that any of its
// rows sees, in ascending order, 8 to a stage of 128 keys, each stage with
// the mask words of its gathered columns (128 rows x 4 words) and a flag for
// "every bit set"; and the query tiles by stage count, most first.
//
// What bounds it on this card: at bert-large's width (D = 64, 16 heads, B 4,
// S 4096, block 16) the Fixed layout lets through 26 % of the pairs, but all
// 1024 of its 128 x 128 tiles are live, so the grain that skips is the
// layout's own 16-key block: 70 blocks an item (95.7 % of the gathered pairs
// useful), 4 D flops a pair, 0.073 ms at 989 TFLOP/s, against 0.040 ms of
// bytes; BSLongformer and BigBird (19 and 26 blocks an item) are
// bytes-bound. The walk is K3's mainloop (wgmma with register accumulators,
// a producer warp streaming three stages by TMA, persistent longest-first
// items dealt on the host to the least loaded block, the two consumer
// warpgroups taking turns in the softmax), with a stage's K and V gathered
// from 8 boxes of 16 rows each.
//
// Layout: q, k, v, out (B, S, H, D) bf16 (kv heads already repeated to H);
// S a multiple of 128.

#include <cstdint>

#include "flash_fwd_wgmma.cuh"

namespace {

// K11 at D 64 and 128: the forward of flash_fwd_wgmma.cuh over the key-block tables
template <int D>
__global__ void __launch_bounds__(hopper::WG_THREADS, 1)
    sparse_fwd_wgmma(const flash_fwd::Params p, const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  flash_fwd::forward<D, flash_fwd::SPARSE>(p, &tq, &tk, &tv);
}

constexpr int KEY_BLOCK = 16;  // rows of one K or V box

// q by 128-row boxes, k and v by 16-row boxes (one key block each)
template <int D>
cudaError_t launch(const flash_fwd::Params& p, cudaStream_t stream) {
  using SM = flash_fwd::Layout<D, flash_fwd::SPARSE>;
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = hopper::rows_map(&tq, p.q, D, p.H, p.Sq, p.B, p.qsr, p.qsb, SM::BQ)) != cudaSuccess ||
      (e = hopper::rows_map(&tk, p.k, D, p.H, p.Sk, p.B, p.ksr, p.ksb, KEY_BLOCK)) != cudaSuccess ||
      (e = hopper::rows_map(&tv, p.v, D, p.H, p.Sk, p.B, p.vsr, p.vsb, KEY_BLOCK)) != cudaSuccess)
    return e;
  return flash_fwd::launch_items<D, flash_fwd::SPARSE>(sparse_fwd_wgmma<D>, p, stream, tq, tk, tv);
}

enum Kind { FWD };

}  // namespace

// q, k, v, out: (B, S, H, D) bf16, D in {64, 128}, S % 128 == 0. The
// tables of compile_key_blocks: order (S / 128,), stage_start (S / 128 + 1,),
// blocks (stages, 8), bits (stages, 128, 4), full (stages,); the items'
// deal to `grid` blocks (deal_items): deal_start (grid + 1,), deal
// (S / 128 * H * B,); all int32. Returns the cudaError_t of the launch.
extern "C" int ds_sparse_flash_fwd(const void* q, const void* k, const void* v,
                                   const void* order, const void* stage_start,
                                   const void* blocks, const void* bits, const void* full,
                                   const void* deal_start, const void* deal, int grid,
                                   void* out, int B, int S, int H, int D, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % 128 || grid <= 0) return cudaErrorInvalidValue;
  flash_fwd::Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.qsr = p.ksr = p.vsr = static_cast<long long>(H) * D;
  p.qsb = p.ksb = p.vsb = p.qsr * S;
  p.Sq = p.Sk = S;
  p.H = p.KVH = H;
  p.B = B;
  p.order = static_cast<const int*>(order);
  p.stage_start = static_cast<const int*>(stage_start);
  p.kblocks = static_cast<const int*>(blocks);
  p.kmask = static_cast<const uint4*>(bits);
  p.kfull = static_cast<const int*>(full);
  p.deal_start = static_cast<const int*>(deal_start);
  p.deal = static_cast<const int*>(deal);
  p.blocks = grid;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, st);
    case 128: return launch<128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// The kernel ds_sparse_flash_fwd (kind 0) launches at head dim D: info[0] 1
// (wgmma), info[1] the dynamic shared memory of a block, bytes, info[2] the
// threads of a block; cudaErrorInvalidValue for a kind or head dim without one.
extern "C" int ds_sparse_kernel_info(int kind, int D, int* info) {
  if (kind != FWD) return cudaErrorInvalidValue;
  info[0] = 1;
  info[2] = hopper::WG_THREADS;
  switch (D) {
    case 64: info[1] = static_cast<int>(flash_fwd::Layout<64, flash_fwd::SPARSE>::bytes); break;
    case 128: info[1] = static_cast<int>(flash_fwd::Layout<128, flash_fwd::SPARSE>::bytes); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}
