// Evoformer (DS4Science) bias-flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/evoformer_flash.py
// (_evo_fwd_kernel, launched by evoformer_flash_fwd). AlphaFold-style
// attention over (B, N, H, S, D) MSA activations: per (batch, MSA row n,
// head h) and query row r,
//   s[c] = q_scaled[r] . k[c]  (f32)  + b1[b, n, c]  + b2[b, h, r, c]
//   online softmax with m starting at -1e30, p = exp(s - m) rounded to bf16
//   before P.V while l sums the f32 p, out = acc / l (l == 0 -> 1).
// q comes in already scaled (the wrapper multiplies it by the scale rounded
// to q's dtype, as the TPU wrapper does). Biases are f32 (the wrapper
// converts); either may be absent (null). A -inf bias gives p = 0; a finite
// mask bias such as -1e9 is an ordinary logit. The (B, N, H, S, S) logits
// never reach device memory.
//
// What bounds it on this card: at the main path's shape (S = 256, D = 64) a
// (row, head) pair does 4 * S * S * D flops against 3 * S * D * 2 bytes of
// q, k, v and S * S * 4 bytes of pair bias, which every MSA row n reads
// again (the TPU kernel too): the pair bias is N times smaller than the
// reads it causes, so it is served from L2 (1 MB at 4 heads). The flops run
// on the tensor cores (wmma, bf16 in, f32 accumulate); one block takes 64
// query rows of one (b * n, h) and streams 64-key tiles of K and V with the
// b1 row slice and the b2 tile read straight from global memory in the
// softmax pass. Later work: wgmma, TMA double buffering, a block over
// several MSA rows sharing each b2 tile.
//
// Layout: q, k, v, out are (B, N, H, S, D) bf16 views with D contiguous and
// every row 16-byte aligned; each tensor's element strides over (B, N, H, S)
// are arguments, so (B, N, S, H, D) storage is read in place. b1 (B * N, S),
// b2 (B, H, S, S) f32, contiguous. S a multiple of 64.

#include <cstdint>

#include "attention_tiles.cuh"

using namespace attn_tiles;

namespace {

constexpr int BQ = 64, BK = 64;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* b1;
  const float* b2;
  bf16* out;
  long long st[4][4];  // strides over (B, N, H, S) of q, k, v, out
  int N, H, S;
};

__device__ __forceinline__ size_t offset(const long long* st, int b, int n, int h) {
  return static_cast<size_t>(b * st[0] + n * st[1] + h * st[2]);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) evo_fwd_kernel(const Params p) {
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

  const int r0 = blockIdx.x * BQ, h = blockIdx.y, bn = blockIdx.z;
  const int b = bn / p.N, n = bn % p.N;
  const bf16* qb = p.q + offset(p.st[0], b, n, h);
  const bf16* kb = p.k + offset(p.st[1], b, n, h);
  const bf16* vb = p.v + offset(p.st[2], b, n, h);
  const size_t sq = p.st[0][3], sk = p.st[1][3], sv = p.st[2][3];
  const float* b1 = p.b1 != nullptr ? p.b1 + static_cast<size_t>(bn) * p.S : nullptr;
  const float* b2 = p.b2 != nullptr
                        ? p.b2 + (static_cast<size_t>(b) * p.H + h) * p.S * p.S +
                              static_cast<size_t>(r0) * p.S
                        : nullptr;

  load_rows<D>(Qs, L::T, qb + r0 * sq, sq, BQ);
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    row_m[i] = -1e30f;
    row_l[i] = 0.f;
  }
  for (int e = threadIdx.x; e < BQ * D; e += NTHREADS) Os[(e / D) * L::O + e % D] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += BK) {
    __syncthreads();  // the previous step's readers are done with K, V, P
    load_rows<D>(Ks, L::T, kb + c0 * sk, sk, BK);
    load_rows<D>(Vs, L::T, vb + c0 * sv, sv, BK);
    __syncthreads();
    gemm_nt<BQ, BK, D>(Ss, L::S, Qs, L::T, Ks, L::T);
    __syncthreads();
    const int S = p.S;
    online_softmax_step<D, BQ, BK>(
        Ss, Ps, Os, Vs, row_m, row_l, row_alpha, [&](int i, int c, float x) {
          if (b1 != nullptr) x += b1[c0 + c];
          if (b2 != nullptr) x += b2[static_cast<size_t>(i) * S + c0 + c];
          return x;
        });
  }
  __syncthreads();
  bf16* ob = p.out + offset(p.st[3], b, n, h);
  const size_t so = p.st[3][3];
  for (int e = threadIdx.x; e < BQ * D; e += NTHREADS) {
    const int i = e / D, d = e % D;
    const float l = row_l[i];
    ob[(r0 + i) * so + d] = __float2bfloat16(Os[i * L::O + d] / (l == 0.f ? 1.f : l));
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  return launch_kernel(evo_fwd_kernel<D>, FwdSmem<D, BQ, BK>::bytes,
                       dim3(p.S / BQ, p.H, B * p.N), p, stream);
}

}  // namespace

// q, k, v, out: (B, N, H, S, D) bf16 views, D in {64, 128, 256}, S % 64 == 0;
// strides: 16 element strides, (B, N, H, S) of q, k, v, out in that order.
// b1 (B * N, S) and b2 (B, H, S, S) f32 or null. Returns the cudaError_t of
// the launch.
extern "C" int ds_evoformer_flash_fwd(const void* q, const void* k, const void* v,
                                      const void* b1, const void* b2, void* out,
                                      const long long* strides, int B, int N, int H, int S,
                                      int D, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || S <= 0 || S % BQ || static_cast<long long>(B) * N > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<bf16*>(out);
  for (int t = 0; t < 4; ++t)
    for (int a = 0; a < 4; ++a) p.st[t][a] = strides[t * 4 + a];
  p.N = N;
  p.H = H;
  p.S = S;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, B, st);
    case 128: return launch<128>(p, B, st);
    case 256: return launch<256>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}
