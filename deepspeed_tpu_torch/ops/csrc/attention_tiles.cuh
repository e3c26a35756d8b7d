// Tile helpers shared by the attention kernels of the port (flash_attention.cu,
// sparse_flash.cu, evoformer_flash.cu, ring_flash.cu): bf16 rows staged in shared memory
// with 16-byte loads, wmma products with f32 accumulators, warp reductions.
// One block has NTHREADS threads; every helper is called by all of them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstddef>

namespace attn_tiles {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;  // eight warps: 1.2-1.4x faster than four at gpt2-xl shapes
constexpr int NWARPS = NTHREADS / 32;

// Shared-memory row strides (elements): padded so wmma fragment pointers stay
// 32-byte aligned and consecutive rows do not start on the same bank.
template <int D, int BK>
struct Ld {
  static constexpr int T = D + 8;   // bf16 rows of Q, K, V
  static constexpr int S = BK + 4;  // f32 score rows
  static constexpr int P = BK + 8;  // bf16 probability rows
  static constexpr int O = D + 4;   // f32 accumulator rows
};

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Q, K, V, scores, probabilities, accumulator, and three f32 values a row
// (m, l, alpha), for BQ query rows against BK keys at head dim D
template <int D, int BQ, int BK>
struct FwdSmem {
  using L = Ld<D, BK>;
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(bf16) * BQ * L::T);
  static constexpr size_t v = align128(k + sizeof(bf16) * BK * L::T);
  static constexpr size_t s = align128(v + sizeof(bf16) * BK * L::T);
  static constexpr size_t p = align128(s + sizeof(float) * BQ * L::S);
  static constexpr size_t o = align128(p + sizeof(bf16) * BQ * L::P);
  static constexpr size_t rows = align128(o + sizeof(float) * BQ * L::O);
  static constexpr size_t bytes = rows + sizeof(float) * 3 * BQ;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// n rows of a strided bf16 matrix (row i at src + i * stride) into shared
// memory, 16 bytes a thread; D contiguous and every row 16-byte aligned
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, size_t stride,
                                          int n) {
  constexpr int VEC = 8;
  constexpr int DV = D / VEC;
  for (int e = threadIdx.x; e < n * DV; e += NTHREADS) {
    const int i = e / DV, d = (e % DV) * VEC;
    *reinterpret_cast<uint4*>(dst + i * ld + d) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(i) * stride + d);
  }
}

// rows [row0, row0 + n) of a strided (row r at src + r * stride) bf16 matrix
// into shared memory, 16 bytes a thread; rows at or past S are zero (the
// overload above takes whole tiles)
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

// One online-softmax step of the forward, after the scores of this key tile
// are in Ss: `score(i, c, x)` turns row i's raw product x at tile column c
// into its logit, or -INFINITY for a masked key (p = 0 exactly). Keeps the
// running max m (starting at -1e30, as the TPU kernels do), the f32 sum l
// of p, writes p rounded to bf16 into Ps, then rescales the accumulator by
// alpha and adds P V. Ends with the block synchronised.
template <int D, int BQ, int BK, typename Score>
__device__ __forceinline__ void online_softmax_step(float* Ss, bf16* Ps, float* Os,
                                                    const bf16* Vs, float* row_m,
                                                    float* row_l, float* row_alpha,
                                                    Score score) {
  using L = Ld<D, BK>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < BQ; i += NWARPS) {
    float mx = -INFINITY;
    for (int c = lane; c < BK; c += 32) {
      const float x = score(i, c, Ss[i * L::S + c]);
      Ss[i * L::S + c] = x;
      mx = fmaxf(mx, x);
    }
    mx = warp_max(mx);
    const float m_old = row_m[i];
    const float m_new = fmaxf(m_old, mx);
    const float alpha = expf(m_old - m_new);
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
  for (int e = threadIdx.x; e < BQ * D; e += NTHREADS) Os[(e / D) * L::O + e % D] *= row_alpha[e / D];
  __syncthreads();
  gemm_nn_acc<BQ, D, BK>(Os, L::O, Ps, L::P, Vs, L::T);
  __syncthreads();
}

// the dynamic shared-memory limit belongs to the current device: set it on
// every launch, then launch and return the launch's error
template <typename Kernel, typename Params>
cudaError_t launch_kernel(Kernel kernel, size_t smem, dim3 grid, const Params& p,
                          cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace attn_tiles
