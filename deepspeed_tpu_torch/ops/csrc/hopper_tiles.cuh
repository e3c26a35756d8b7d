// Hopper (sm_90a) primitives for the port's attention kernels: TMA tile loads
// into 128-byte-swizzled shared memory, mbarrier pipelines, wgmma with f32
// accumulators in registers, and register reallocation between warpgroups.
// Raw PTX, no CUTLASS. Used by the backward of flash_bwd_wgmma.cuh (K14 /
// K15 in ring_flash.cu, K4 / K5 in flash_attention.cu), the forward of
// flash_fwd_wgmma.cuh (K13 in ring_flash.cu, K3 in flash_attention.cu, K11
// in sparse_flash.cu, K12 in evoformer_flash.cu), fused decode attention
// (K2, decode_attention.cu: TMA, mbarriers, and the warp-level mma.sync,
// ldmatrix and cp.async below) and the weight-only-quantized matmul (K6,
// woq_matmul.cu: wgmma rs at large M, mma.sync at small M). The kernel
// layout the attention kernels serve: consumer warpgroups of 64 rows
// whose f32 accumulators live in registers (setmaxnreg raises a consumer to
// 240 registers a thread, enough for three or four 64 x 128 f32 tiles, and
// drops the producer to 24), and one producer warp feeding a ring of
// shared-memory stages by TMA, each stage guarded by a full and an empty
// mbarrier.
//
// Tile layout. A bf16 tile of R rows by D columns (D a multiple of 64) sits
// in shared memory as D / 64 column blocks of R rows x 128 bytes, each
// block 1024-byte aligned and 128-byte swizzled (16-byte chunk c of row r
// at chunk c ^ (r % 8)), exactly as a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// and a {64, 1, R, 1} box writes it. wgmma reads such a tile two ways:
//   K-major (the product's depth runs along the row, as Q in Q K^T): 16
//     columns at a time, the descriptor's start 32 bytes further per step
//     and one column block further every 4 steps; 8-row groups 1024 bytes
//     apart (SBO);
//   MN-major (the depth runs down the rows, as K in dS K): 16 rows at a
//     time, the start 2048 bytes further per step; 8-row groups 1024 bytes
//     apart (SBO), and the next 64 output columns one column block further
//     (LBO = R x 128 bytes).
// Fragments. A wgmma m64nN accumulator gives thread t of the warpgroup (warp
// w = t / 32, lane l) element d[4 j + 2 h + e] at row 16 w + l / 4 + 8 h,
// column 8 j + 2 (l % 4) + e. The A fragment of an m64k16 product holds, for
// depth step k, a[i] = the bf16 pair of columns 16 k + 8 (i / 2) + 2 (l % 4)
// + {0, 1} at row 16 w + l / 4 + 8 (i % 2): so an accumulator's 16 columns
// 16 k .. 16 k + 15 become A operand k by packing d[8 k + 2 i], d[8 k + 2 i + 1]
// into a[i], with no data movement (a_fragment).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ descriptors

constexpr uint64_t SWIZZLE_128B = 1ull << 62;

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile at shared
// address `addr` (1024-byte aligned but for the K-major 32-byte steps)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | SWIZZLE_128B;
}

// operand for depth step k (16 columns) of a K-major tile of `rows` rows
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int rows, int k) {
  return desc_sw128(tile + (k / 4) * rows * 128 + (k % 4) * 32, 16, 1024);
}

// operand for depth step k (16 rows) of an MN-major tile of `rows` rows
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int rows, int k) {
  return desc_sw128(tile + k * 16 * 128, rows * 128, 1024);
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x by the special function unit, subnormal results flushed to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of depth step k from an accumulator's columns 16 k .. 16 k + 15,
// already rounded to bf16 pairs: packed[8 k / 2 + i] holds d[8 k + 2 i], d[8 k + 2 i + 1]
template <int N>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const uint32_t (&packed)[N],
                                           int k) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = packed[4 * k + i];
}

// m64nNk16, bf16 in, f32 accumulate. ss: A (K-major) and B from shared
// memory, `accumulate` 0 overwrites D; rs: A from registers, D += A B (at
// N = 128 `accumulate` 0 overwrites D too).
// TRANS_B = 0: B K-major; 1: B MN-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
  // D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (a_fragment), B from
  // shared memory
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
  // D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (a_fragment), B from
  // shared memory
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
};

// -------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// arrive, and expect `bytes` more of TMA transfer before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// orders this thread's shared-memory stores before later reads of the async
// proxy (wgmma, TMA) that a barrier hands them to
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// named barrier `id` (1-15; 0 is __syncthreads) of THREADS threads: wait
// until they have all arrived, or arrive without waiting
template <int THREADS>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}
template <int THREADS>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

// -------------------------------------------------------------------- TMA

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// one box of a 5-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// one box of a 2-D / 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// --------------------------------------------------------------- cp.async

// 16 bytes from global to shared memory; src_bytes 0 reads nothing and
// writes zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 8 bytes from global to shared memory (through L1)
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}
// an arrival on `bar` once this thread's earlier cp.async copies have landed
// (the pending count rises by one now, so the phase waits for it)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -------------------------------------------- warp-level mma.sync, ldmatrix
//
// m16n8k16, bf16 in, f32 accumulate, D += A B. Thread l of the warp (g =
// l / 4, t = l % 4) holds a[0] = A[g][2t, 2t + 1], a[1] = A[g + 8][2t, 2t + 1],
// a[2] = A[g][2t + 8, 2t + 9], a[3] = A[g + 8][2t + 8, 2t + 9] (bf16 pairs, the
// lower column in the low half); b0 = B[2t, 2t + 1][g], b1 = B[2t + 8, 2t + 9][g];
// d[0], d[1] = D[g][2t, 2t + 1] and d[2], d[3] = D[g + 8][2t, 2t + 1].
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, lane i giving the address of
// row i % 8 of matrix i / 8: r[m] holds, for lane l, row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 of matrix m; with .trans, rows 2 (l % 4) and
// 2 (l % 4) + 1 of column l / 4
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// --------------------------------------------------- register reallocation

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------- the block layout
//
// Three warpgroups a block: two consumers of 64 rows each and a producer, of
// which one warp issues the TMA loads; the producer gives its registers to
// the consumers. Stages are guarded by a full barrier (32 producer arrivals
// plus the TMA bytes) and an empty one (every consumer thread arrives once
// it is done with the stage).

constexpr int WG = 128;                         // threads of a warpgroup
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int WG_THREADS = (CONSUMERS + 1) * WG;
constexpr int WG_ROWS = 64;                     // a consumer's rows (wgmma M)
constexpr int STAGES = 2;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

// the first 1024-byte aligned byte of dynamic shared memory, as an offset
// from the array so that the compiler keeps it a shared-memory pointer
__device__ __forceinline__ unsigned char* align1024(unsigned char* smem) {
  return smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
}

// the position in a ring of N stages: stage s in its phase of parity `phase`
template <int N = STAGES>
struct StageRing {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == N) {
      s = 0;
      phase ^= 1;
    }
  }
};
using Ring = StageRing<>;

// D / 64 column blocks of `rows` rows of one head into a swizzled tile
template <int D>
__device__ __forceinline__ void tma_rows(__nv_bfloat16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int head, int row0, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_4d(dst + c * rows * 64, map, bar, c * 64, head, row0, b);
}

// the same from a 5-D (D, heads, S, N, B) map at (n, b)
template <int D>
__device__ __forceinline__ void tma_rows5(__nv_bfloat16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int head, int row0, int n,
                                          int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_5d(dst + c * rows * 64, map, bar, c * 64, head, row0, n, b);
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point) fetched through the
// runtime, so the library needs no -lcuda; null when libcuda lacks it
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                           12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` dimensions (dims[0] contiguous; strides[i] the
// byte stride of dimension i + 1) read in boxes of `box` into the
// 128-byte-swizzled layout (box[0] elements of 128 bytes), or row after row
// unswizzled with CU_TENSOR_MAP_SWIZZLE_NONE; out-of-range elements read as
// zeros.
inline cudaError_t tiled_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                             int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                             const cuuint32_t* box,
                             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a bf16 (B, S, heads, D) tensor read in place: row r of
// head h in batch b at base + b * batch_stride + r * row_stride + h * D
// (elements), read as boxes of `box_rows` rows of one head by 64 columns
// into the 128-byte-swizzled layout; rows at or past S read as zeros.
inline cudaError_t rows_map(CUtensorMap* map, const void* base, int D, int heads, int S, int B,
                            long long row_stride, long long batch_stride, int box_rows) {
  if (B == 1) batch_stride = row_stride * S;  // unread; keep it a valid stride
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4, dims, strides, box);
}

}  // namespace hopper
