// Weight-only-quantized matmul y = x @ dequant(Wq) for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/woq_matmul.py
// (_woq_kernel, launched by woq_matmul). x (M, K) bf16; the weight stays in
// its packed form in device memory and is dequantized tile by tile in shared
// memory, so the bf16 weight never exists in device memory:
//   int8: q (K, N) int8, w[k][n] = q[k][n];
//   int4: two nibble planes q (K/2, N): byte row i holds w[i] in its low and
//         w[i + K/2] in its high nibble, sign-extended (>= 8 -> -16);
//   fp6 (e3m2): three byte planes q (3, K/4, N) whose 24-bit word at
//         (i, n) holds the code of row i + p K/4 at bits 6p; a code decodes
//         as sign (bit 5) * (e == 0 ? m / 16 : (1 + m / 4) 2^(e - 3)).
// Each dequantized value is multiplied by its (K/g, N) f32 group scale and
// rounded to bf16 before the product (the TPU kernel's (w * s).astype(x)),
// and the products accumulate in f32; y is written in bf16.
//
// What bounds it on this card: at decode (M = 4) bytes, the packed weight
// read once (1, 0.5 or 0.75 byte an element) against 8 flops an element;
// at M = 2048 the tensor cores (2 M K N flops). The design is the simple
// one: a block owns a 64 x 128 output tile and walks K in 32-row steps, its
// 256 threads loading the x tile and dequantizing the weight tile into
// shared memory (16-byte loads where N allows), eight warps running wmma
// bf16 products with f32 accumulators. A small-M call has too few output
// tiles for 132 SMs, so K is split over up to `splitk` blocks that write f32
// partials, summed and rounded by a second pass. Ragged M and N are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int NTHREADS = 256;
constexpr int XLD = BK + 8;    // padded shared-memory row strides (elements)
constexpr int WLD = BN + 8;
constexpr int CLD = BN + 4;

struct Args {
  const __nv_bfloat16* x;
  const int8_t* q;
  const float* scales;
  __nv_bfloat16* out;
  float* part;          // (splitk, M, N) f32 when splitk > 1
  int M, K, N, g, splitk, k_per_split, vec_x, vec_q;
};

__device__ __forceinline__ float fp6_decode(int code) {
  const int e = (code >> 2) & 0x7;
  const float m = static_cast<float>(code & 0x3);
  const float mag = e == 0 ? m / 16.f : (1.f + 0.25f * m) * exp2f(static_cast<float>(e - 3));
  return (code & 0x20) ? -mag : mag;
}

// the dequantized (unscaled) weight at (k, n) from its byte(s) b0, b1, b2
template <int BITS>
__device__ __forceinline__ float decode(int k, int K, uint32_t b0, uint32_t b1, uint32_t b2) {
  if constexpr (BITS == 8) {
    return static_cast<float>(static_cast<int8_t>(b0));
  } else if constexpr (BITS == 4) {
    const int nib = k < K / 2 ? (b0 & 0xF) : (b0 >> 4) & 0xF;
    return static_cast<float>(nib >= 8 ? nib - 16 : nib);
  } else {
    const uint32_t word = b0 | (b1 << 8) | (b2 << 16);
    return fp6_decode((word >> (6 * (k / (K / 4)))) & 0x3F);
  }
}

template <int BITS>
__global__ void __launch_bounds__(NTHREADS) woq_kernel(Args a) {
  __shared__ __align__(128) unsigned char smem[BM * CLD * sizeof(float)];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);            // BM x XLD
  __nv_bfloat16* wsm = xs + BM * XLD;                                     // BK x WLD
  float* cs = reinterpret_cast<float*>(smem);                             // BM x CLD (epilogue)

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, kz = blockIdx.z;
  const int k_begin = kz * a.k_per_split;
  const int k_end = min(a.K, k_begin + a.k_per_split);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;   // 2 x 4 warps, 32 x 32 each
  // byte-row geometry of the packed planes
  const int rows_per_plane = BITS == 8 ? a.K : (BITS == 4 ? a.K / 2 : a.K / 4);
  const size_t plane = static_cast<size_t>(rows_per_plane) * a.N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int xr = tid / 4, xc = (tid % 4) * 8;       // x tile: 8 elements a thread
  const int wr = tid / 8, wc = (tid % 8) * 16;      // w tile: 16 elements a thread
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // x tile (BM x BK)
    {
      const int m = m0 + xr;
      __nv_bfloat16* dst = xs + xr * XLD + xc;
      if (m < a.M && a.vec_x) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(a.x + static_cast<size_t>(m) * a.K + k0 + xc);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i] = m < a.M ? a.x[static_cast<size_t>(m) * a.K + k0 + xc + i]
                           : __float2bfloat16_rn(0.f);
      }
    }
    // weight tile (BK x BN), dequantized and scaled
    {
      const int k = k0 + wr;
      const int n = n0 + wc;
      const int r = BITS == 8 ? k : (BITS == 4 ? k % (a.K / 2) : k % (a.K / 4));
      const int8_t* src = a.q + static_cast<size_t>(r) * a.N + n;
      const float* srow = a.scales + static_cast<size_t>(k / a.g) * a.N + n;
      __nv_bfloat16* dst = wsm + wr * WLD + wc;
      if (a.vec_q && n + 16 <= a.N) {
        uint4 p0 = *reinterpret_cast<const uint4*>(src), p1 = p0, p2 = p0;
        if constexpr (BITS == 6) {
          p1 = *reinterpret_cast<const uint4*>(src + plane);
          p2 = *reinterpret_cast<const uint4*>(src + 2 * plane);
        }
        const uint8_t* c0 = reinterpret_cast<const uint8_t*>(&p0);
        const uint8_t* c1 = reinterpret_cast<const uint8_t*>(&p1);
        const uint8_t* c2 = reinterpret_cast<const uint8_t*>(&p2);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          dst[i] = __float2bfloat16_rn(decode<BITS>(k, a.K, c0[i], c1[i], c2[i]) * srow[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float w = 0.f;
          if (n + i < a.N) {
            const uint32_t b0 = static_cast<uint8_t>(src[i]);
            const uint32_t b1 = BITS == 6 ? static_cast<uint8_t>(src[i + plane]) : 0u;
            const uint32_t b2 = BITS == 6 ? static_cast<uint8_t>(src[i + 2 * plane]) : 0u;
            w = decode<BITS>(k, a.K, b0, b1, b2) * srow[i];
          }
          dst[i] = __float2bfloat16_rn(w);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wm * 32 + i * 16) * XLD + kk, XLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], wsm + kk * WLD + wn * 32 + j * 16, WLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * CLD + wn * 32 + j * 16, acc[i][j], CLD,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += NTHREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) continue;
    const float v = cs[r * CLD + c];
    if (a.splitk > 1) {
      a.part[(static_cast<size_t>(kz) * a.M + m) * a.N + n] = v;
    } else {
      a.out[static_cast<size_t>(m) * a.N + n] = __float2bfloat16_rn(v);
    }
  }
}

__global__ void splitk_sum_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                                  size_t mn, int splitk) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < mn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splitk; ++z) s += part[z * mn + i];
    out[i] = __float2bfloat16_rn(s);
  }
}

template <int BITS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.splitk);
  woq_kernel<BITS><<<grid, NTHREADS, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splitk == 1) return e;
  const size_t mn = static_cast<size_t>(a.M) * a.N;
  const size_t want = (mn + 255) / 256;
  splitk_sum_kernel<<<static_cast<int>(want < 4096 ? want : 4096), 256, 0, stream>>>(
      a.part, a.out, mn, a.splitk);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16; q int8 (K, N) / int4 planes (K/2, N) / fp6 planes
// (3, K/4, N); scales (K/g, N) f32; out (M, N) bf16; part (splitk, M, N) f32
// scratch when splitk > 1 (else ignored). K % (g * planes) == 0, g % 32 == 0;
// each of the splitk K ranges is k_per_split rows (a multiple of 32).
// Returns the cudaError_t of the launches.
extern "C" int ds_woq_matmul(const void* x, const void* q, const void* scales, void* out,
                             void* part, int M, int K, int N, int g, int bits, int splitk,
                             int k_per_split, void* stream) {
  const int planes = bits == 8 ? 1 : (bits == 4 ? 2 : 4);
  if (M <= 0 || N <= 0 || K <= 0 || g <= 0 || g % BK || K % (g * planes) || splitk <= 0 ||
      k_per_split % BK || (bits != 8 && bits != 4 && bits != 6))
    return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.q = static_cast<const int8_t*>(q);
  a.scales = static_cast<const float*>(scales);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.M = M;
  a.K = K;
  a.N = N;
  a.g = g;
  a.splitk = splitk;
  a.k_per_split = k_per_split;
  a.vec_x = aligned(x) && K % 8 == 0;
  a.vec_q = aligned(q) && N % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8: return launch<8>(a, st);
    case 4: return launch<4>(a, st);
    default: return launch<6>(a, st);
  }
}
