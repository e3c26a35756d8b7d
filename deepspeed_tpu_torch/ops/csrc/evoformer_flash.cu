// Evoformer (DS4Science) bias-flash attention forward for Hopper (sm_90a): K12.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/evoformer_flash.py
// (_evo_fwd_kernel, launched by evoformer_flash_fwd): evo_fwd_wgmma, the
// forward of flash_fwd_wgmma.cuh in mode EVO. AlphaFold-style attention over
// (B, N, H, S, D) MSA activations: per (batch, MSA row n, head h) and query
// row r,
//   q_scaled = bf16(q x bf16(scale)) (in the kernel; the TPU wrapper's
//   pre-scale, bit for bit),
//   s[c] = q_scaled[r] . k[c] (f32) + b1[b, n, c] + b2[b, h, r, c],
//   online softmax with m starting at -1e30, p = exp(s - m) rounded to bf16
//   before P.V while l sums the f32 p, out = acc / l (0 where l = 0).
// Biases are f32 (the wrapper converts); either may be absent (null). A
// -inf bias gives p = 0; a finite mask bias such as -1e9 is an ordinary
// logit. The (B, N, H, S, S) logits never reach device memory.
//
// What bounds it on this card: at the main path's shape (1, 512, 256, 4, 64)
// a (row, head) pair does 4 S S D flops against 4 S D 2 bytes of q, k, v and
// out, and every MSA row n reads the (S, S) pair bias of its head again:
// q, k, v, out and each bias read once are 270 MB, 0.081 ms at 3.35 TB/s,
// against 0.070 ms of operations. The pair bias (1 MB at 4 heads) stays in
// L2; each stage stages its 128 x BK tile in shared memory by TMA beside K
// and V (D 64 and 128; from L2 in the pass at D 256), so the pass reads it
// conflict-free in the accumulator's fragment order. The mainloop is K3's
// (wgmma with register accumulators, persistent items of 128 query rows of
// one (b n, h), the two consumer warpgroups taking turns in the pass).
//
// Layout: q, k, v are (B, N, H, S, D) bf16 views with D contiguous and every
// stride a multiple of 8 elements, read through 5-D tensor maps over
// (D, H, S, N, B) from their own strides, so the (B, N, S, H, D) storage
// DS4Sci_EvoformerAttention passes is read in place; out is (B, N, S, H, D)
// storage. b1 (B * N, S), b2 (B, H, S, S) f32, contiguous. S a multiple of
// 128.

#include <cstdint>

#include "flash_fwd_wgmma.cuh"

namespace {

// K12 at D 64, 128 and 256: the forward of flash_fwd_wgmma.cuh with the biases
template <int D>
__global__ void __launch_bounds__(hopper::WG_THREADS, 1)
    evo_fwd_wgmma(const flash_fwd::Params p, const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tb) {
  flash_fwd::forward<D, flash_fwd::EVO>(p, &tq, &tk, &tv, &tb);
}

// the 5-D map of a (B, N, H, S, D) bf16 view with element strides st over
// (B, N, H, S), in boxes of `rows` rows of one head; the stride of a
// dimension of extent 1 is never read, so it is replaced by a valid one
cudaError_t view_map(CUtensorMap* map, const void* base, const long long* st, int B, int N,
                     int H, int S, int D, int rows) {
  const long long valid = st[3] * S;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(H == 1 ? valid : st[2]) * 2,
                                 static_cast<cuuint64_t>(st[3]) * 2,
                                 static_cast<cuuint64_t>(N == 1 ? valid : st[1]) * 2,
                                 static_cast<cuuint64_t>(B == 1 ? valid : st[0]) * 2};
  const cuuint32_t box[5] = {64, 1, static_cast<cuuint32_t>(rows), 1, 1};
  return hopper::tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 5, dims, strides, box);
}

template <int D>
cudaError_t launch(const flash_fwd::Params& p, const long long* strides, int B,
                   cudaStream_t stream) {
  using SM = flash_fwd::Layout<D, flash_fwd::EVO>;
  const int N = p.N, H = p.H, S = p.Sq;
  CUtensorMap tq, tk, tv, tb = {};
  cudaError_t e;
  if ((e = view_map(&tq, p.q, strides, B, N, H, S, D, SM::BQ)) != cudaSuccess ||
      (e = view_map(&tk, p.k, strides + 4, B, N, H, S, D, SM::BK)) != cudaSuccess ||
      (e = view_map(&tv, p.v, strides + 8, B, N, H, S, D, SM::BK)) != cudaSuccess)
    return e;
  if (SM::B2_STAGED && p.b2 != nullptr) {  // (S cols, S rows, H, B) f32, 32 x BQ boxes
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
    const cuuint64_t row = static_cast<cuuint64_t>(S) * 4;
    const cuuint64_t st[3] = {row, row * S, row * S * H};
    const cuuint32_t box[4] = {32, SM::BQ, 1, 1};
    if ((e = hopper::tiled_map(&tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.b2, 4, dims, st, box)) !=
        cudaSuccess)
      return e;
  }
  return flash_fwd::launch_items<D, flash_fwd::EVO>(evo_fwd_wgmma<D>, p, stream, tq, tk, tv, tb);
}

enum Kind { FWD };

}  // namespace

// q, k, v: (B, N, H, S, D) bf16 views, D in {64, 128, 256}, S % 128 == 0;
// strides: 12 element strides, (B, N, H, S) of q, k, v in that order. out
// (B, N, S, H, D) bf16, contiguous. b1 (B * N, S) and b2 (B, H, S, S) f32 or
// null. scale: the softmax scale (q is multiplied by it rounded to bf16).
// Returns the cudaError_t of the launch.
extern "C" int ds_evoformer_flash_fwd(const void* q, const void* k, const void* v,
                                      const void* b1, const void* b2, void* out,
                                      const long long* strides, int B, int N, int H, int S,
                                      int D, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || S <= 0 || S % 128) return cudaErrorInvalidValue;
  flash_fwd::Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.Sq = p.Sk = S;
  p.H = p.KVH = H;
  p.N = N;
  p.B = B * N;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, strides, B, st);
    case 128: return launch<128>(p, strides, B, st);
    case 256: return launch<256>(p, strides, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// The kernel ds_evoformer_flash_fwd (kind 0) launches at head dim D: info[0]
// 1 (wgmma), info[1] the dynamic shared memory of a block, bytes, info[2]
// the threads of a block; cudaErrorInvalidValue for a kind or head dim
// without one.
extern "C" int ds_evoformer_kernel_info(int kind, int D, int* info) {
  if (kind != FWD) return cudaErrorInvalidValue;
  info[0] = 1;
  info[2] = hopper::WG_THREADS;
  switch (D) {
    case 64: info[1] = static_cast<int>(flash_fwd::Layout<64, flash_fwd::EVO>::bytes); break;
    case 128: info[1] = static_cast<int>(flash_fwd::Layout<128, flash_fwd::EVO>::bytes); break;
    case 256: info[1] = static_cast<int>(flash_fwd::Layout<256, flash_fwd::EVO>::bytes); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}
