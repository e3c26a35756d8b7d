// Tile helpers of the wmma backwards at head dim 256 (flash_attention.cu's
// flash_dq_kernel / flash_dkv_kernel, ring_flash.cu's ring_dq_kernel /
// ring_dkv_kernel), whose dk and dv do not fit the wgmma design's registers:
// bf16 rows staged in shared memory with 16-byte loads, wmma products with
// f32 accumulators. One block has NTHREADS threads; every helper is called
// by all of them.
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
