// Block-sparse flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/sparse_flash.py
// (_kernel, launched by sparse_flash_attention through _fwd_kernel_call).
// The sparsity layout is compiled per 128-row query tile into
//   table  (QT, MA) int32  the live 128-key tiles of each query tile, padded
//   counts (QT,)    int32  how many entries of table are live
//   bits   (QT, MA, 128, 4) uint32  the token mask of each live tile (causality
//                          folded in), bit c % 32 of word c / 32 of row r
// The TPU kernel reads the mask as (128, 128) f32 tiles; the wrapper packs
// them to bits once per layout (64 KB -> 2 KB a tile), so at S = 4096 the
// Fixed layout's 1024 live tiles take 2 MB, not 67 MB, and stay in L2.
// Semantics, per query row r of one (batch, head), over the live tiles only:
//   s = (q . k) * scale in f32 (scale after the dot, as the TPU kernel),
//   p = exp(s - m) for keys whose mask bit is set and exactly 0 for the rest,
//   online softmax with m starting at -1e30, p rounded to bf16 before P.V
//   while l sums the f32 p, out = acc / l (l == 0 -> 1: a row that sees no
//   key outputs 0; the TPU kernel instead averages the V rows it visited).
//
// What bounds it on this card: at bert-large's width (D = 64) a live tile
// costs 4 * 128 * 128 * 64 flops against 2 * 128 * 64 * 2 bytes of K and V,
// 256 flops a byte, about the H100's 295: near the ridge, so both products
// run on the tensor cores (wmma, bf16 in, f32 accumulate) and a dead tile is
// never loaded. Each block takes 64 query rows (half a layout tile) and walks
// its tile list in two 64-key halves, so a block fits in 72 KB (D = 64) or
// 113 KB (D = 128) of shared memory and 4096 blocks fill the card at the
// main path's shape. Later work: wgmma with register accumulators, TMA
// double buffering, skipping 64 x 64 halves whose bits are all 0.
//
// Layout: q, k, v, out (B, S, H, D) bf16 (kv heads already repeated to H);
// S a multiple of 128.

#include <cstdint>

#include "attention_tiles.cuh"

using namespace attn_tiles;

namespace {

constexpr int TILE = 128;             // the layout tables' query and key tile
constexpr int WORDS = TILE / 32;      // mask words a tile row
constexpr int BQ = 64, BK = 64;       // this kernel's query rows and key columns a step

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* table;
  const int* counts;
  const uint32_t* bits;
  bf16* out;
  int S, H, MA;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) sparse_fwd_kernel(const Params p) {
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

  const int r0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int qt = r0 / TILE, tile_row = r0 % TILE;
  const size_t stride = static_cast<size_t>(p.H) * D;
  const size_t base = (static_cast<size_t>(b) * p.S * p.H + h) * D;

  load_rows<D>(Qs, L::T, p.q + base + r0 * stride, stride, BQ);
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    row_m[i] = -1e30f;
    row_l[i] = 0.f;
  }
  for (int e = threadIdx.x; e < BQ * D; e += NTHREADS) Os[(e / D) * L::O + e % D] = 0.f;

  const int live = p.counts[qt];
  for (int j = 0; j < live; ++j) {
    const int kt = p.table[qt * p.MA + j];
    // this block's rows of the tile's mask
    const uint32_t* tb =
        p.bits + (static_cast<size_t>(qt * p.MA + j) * TILE + tile_row) * WORDS;
    for (int half = 0; half < TILE / BK; ++half) {
      const int c0 = kt * TILE + half * BK;
      __syncthreads();  // the previous step's readers are done with K, V, P
      load_rows<D>(Ks, L::T, p.k + base + c0 * stride, stride, BK);
      load_rows<D>(Vs, L::T, p.v + base + c0 * stride, stride, BK);
      __syncthreads();
      gemm_nt<BQ, BK, D>(Ss, L::S, Qs, L::T, Ks, L::T);
      __syncthreads();
      const float scale = p.scale;
      online_softmax_step<D, BQ, BK>(
          Ss, Ps, Os, Vs, row_m, row_l, row_alpha, [&](int i, int c, float x) {
            const int col = half * BK + c;
            const bool on = (tb[i * WORDS + col / 32] >> (col % 32)) & 1u;
            return on ? x * scale : -INFINITY;
          });
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BQ * D; e += NTHREADS) {
    const int i = e / D, d = e % D;
    const float l = row_l[i];
    p.out[base + (r0 + i) * stride + d] = __float2bfloat16(Os[i * L::O + d] / (l == 0.f ? 1.f : l));
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  return launch_kernel(sparse_fwd_kernel<D>, FwdSmem<D, BQ, BK>::bytes,
                       dim3(p.S / BQ, p.H, B), p, stream);
}

}  // namespace

// q, k, v, out: (B, S, H, D) bf16, D in {64, 128}, S % 128 == 0; table
// (S / 128, MA) and counts (S / 128,) int32; bits (S / 128, MA, 128, 4)
// uint32. Returns the cudaError_t of the launch.
extern "C" int ds_sparse_flash_fwd(const void* q, const void* k, const void* v,
                                   const void* table, const void* counts, const void* bits,
                                   void* out, int B, int S, int H, int D, int MA, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % TILE || MA <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.table = static_cast<const int*>(table);
  p.counts = static_cast<const int*>(counts);
  p.bits = static_cast<const uint32_t*>(bits);
  p.out = static_cast<bf16*>(out);
  p.S = S;
  p.H = H;
  p.MA = MA;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, B, st);
    case 128: return launch<128>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}
