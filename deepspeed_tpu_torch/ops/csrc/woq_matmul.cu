// Weight-only-quantized matmul y = x @ dequant(Wq) for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/woq_matmul.py
// (_woq_kernel, launched by woq_matmul). x (M, K) bf16; the weight stays in
// its packed form in device memory and is dequantized on chip, so the bf16
// weight never exists in device memory:
//   int8: q (K, N) int8, w[k][n] = q[k][n];
//   int4: two nibble planes q (K/2, N): byte row i holds w[i] in its low and
//         w[i + K/2] in its high nibble, sign-extended (>= 8 -> -16);
//   fp6 (e3m2): three byte planes q (3, K/4, N) whose 24-bit word at
//         (i, n) holds the code of row i + p K/4 at bits 6p; a code decodes
//         as sign (bit 5) * (e == 0 ? m / 16 : (1 + m / 4) 2^(e - 3)).
// Each dequantized value is multiplied by its (K/g, N) f32 group scale in
// f32 and rounded to bf16 before the product (the TPU kernel's
// (w * s).astype(x)), so the weight tiles are the plain version's bit for
// bit; the products accumulate in f32; y is written in bf16. A k value is
// (slab p, byte row r) = p Kp + r with Kp = K / PK byte rows a plane and PK
// = 1, 2, 4 k values a byte position holds (int8, int4, fp6).
//
// What bounds it on this card: at decode (M = 4) bytes, the packed weight
// read once (1, 0.5 or 0.75 byte an element) against 8 flops an element;
// at M = 2048 the tensor cores (2 M K N flops), with the dequantization on
// the ALUs beside them. Three hand-written routes, chosen on the host by
// shape before the launch (woq_route in ops/woq_matmul.py):
//
// stream (M up to 16 at int8, 8 at int4 and fp6, N % 16 == 0): a
//   weight-streaming kernel. A block is four warps over 128 columns and a
//   run of K steps (16 k values each), the warps taking every fourth step;
//   a quad of lanes owns 16 columns, and lane t of the quad loads its byte
//   rows of a step as 16-byte ld.global.nc pieces (4, 2 or 3 for int8,
//   int4, fp6), U steps ahead in registers (48-96 KB in flight an SM). The
//   bytes become the A operand of mma.sync m16n8k16 with N as the rows
//   (y^T = W^T x^T): a thread's 16 columns are 8 products' row pairs, and
//   its 4 k values their depths, so a 16-byte load feeds 8 products with no
//   exchange between lanes; x's matching 4 values (the B operand, rows past
//   M zero) sit side by side in the slice the block stages in shared memory
//   by cp.async, with the chunk's group scales. Dequantization is bit
//   tricks in registers: int8 bytes by prmt into 0x4B0000xx and one
//   subtract, nibbles by a masked xor into the same form, fp6 codes shifted
//   into a float's exponent and mantissa and scaled by 2^124 (exact,
//   denormals kept); a thread reads a group's 16 scales of a slab once.
//   mma.sync rather than f32 FMAs: the products then cost one instruction
//   per 256 weights instead of 8 FMAs for each at M = 4, which leaves the
//   ALUs to the dequantization (measured: PERF.md section 6). The blocks
//   that split one column tile's K form a thread-block cluster (up to 8)
//   and sum their four warps' and then their blocks' partial sums in a fixed
//   order through distributed shared memory: one launch, deterministic.
// wgmma (larger M, N % 16 == 0): a persistent wgmma mainloop over
//   128-column by BM-row output tiles (BM 256 where that still gives every
//   SM a tile, else 128). A producer warp TMA-loads, per stage of 64 byte
//   rows, the x slabs (BM x 64 k, K-major, 128-byte swizzle: all PK of
//   them, or one of fp6's four at BM 256, the byte rows then coming once
//   for each slab), the PB packed weight planes (64 byte rows x 128
//   columns, 128-byte swizzle) and the two group-scale rows each slab needs
//   into a ring of 2-4 stages on full and empty mbarriers. Each of two
//   consumer warpgroups owns 64 columns and computes y^T = W^T x^T: it
//   reads its bytes from shared memory (conflict-free through the swizzle),
//   dequantizes them in registers straight into the A fragment of wgmma
//   m64n128k16 (rs), and reads x as the B operand from the slab. Register A rather than a
//   dequantized bf16 tile in shared memory (ss, MN-major): the weight never
//   makes the round trip through shared memory, and a fragment dequantized
//   once feeds BM / 128 wgmmas. Fragments go in batches (two k16 steps of
//   every slab of the stage, or one step's four slabs for fp6 at BM 128) in
//   two buffers: a batch is dequantized while the previous one's wgmmas run.
//   f32 accumulators stay in registers (BM / 2 a thread); the tile's first
//   product overwrites them (scale-d 0); the epilogue writes bf16 pairs. No
//   split: deterministic.
// simt (N % 16 != 0, or a pointer off 16 bytes): the first design, kept as
//   the route for exactly those shapes: a block owns a 64 x 128 output tile
//   and walks K in 32-row steps, dequantizing into shared memory for wmma;
//   split-K partials summed in order by a second pass. Ragged M and N
//   masked.
// Ragged M is masked on every route (TMA fills rows past M with zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "hopper_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------- bit-trick dequantization

// signed byte `i` (0-3) of w as f32: 0x4B0000 (b ^ 0x80) is 2^23 + b + 128
__device__ __forceinline__ float i8_value(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, i | 0x7440)) - 8388736.f;
}
// the sign-extended nibble at bit `sh` of w as f32: 0x4B00000 (n ^ 8) is 2^23 + n + 8
__device__ __forceinline__ float i4_value(uint32_t w, int sh) {
  return __int_as_float(((w >> sh) & 0xFu) ^ 0x4B000008u) - 8388616.f;
}
// e3m2 code p of a 24-bit word as f32: sign to bit 31, exponent and mantissa
// to bits 21-25, times 2^124 (exact; e == 0 lands on a denormal, m / 16)
__device__ __forceinline__ float fp6_value(uint32_t word, int p) {
  const uint32_t c = word >> (6 * p);
  return __int_as_float(((c & 0x1Fu) << 21) | ((c & 0x20u) << 26)) * __int_as_float(0x7D800000);
}
// bytes i of a, b and c as the low three bytes of a word (the top byte is
// not defined: the fp6 codes read bits 0-23 only)
__device__ __forceinline__ uint32_t bytes3(uint32_t a, uint32_t b, uint32_t c, int i) {
  return __byte_perm(__byte_perm(a, b, i | ((i + 4) << 4)), c, 0x0010 | ((i + 4) << 8));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// ======================================================= simt route (ragged)

namespace simt {

using namespace nvcuda;

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int NTHREADS = 256;
constexpr int XLD = BK + 8;    // padded shared-memory row strides (elements)
constexpr int WLD = BN + 8;
constexpr int CLD = BN + 4;

struct Args {
  const bf16* x;
  const int8_t* q;
  const float* scales;
  bf16* out;
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
  bf16* xs = reinterpret_cast<bf16*>(smem);            // BM x XLD
  bf16* wsm = xs + BM * XLD;                                     // BK x WLD
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
      bf16* dst = xs + xr * XLD + xc;
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
      bf16* dst = wsm + wr * WLD + wc;
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
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

__global__ void splitk_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
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


}  // namespace simt

// ===================================================== stream route (small M)

namespace stream {

constexpr int WARPS = 4, THREADS = WARPS * 32;
constexpr int COLS = 128;   // a block's columns: 16 a quad of lanes; the 4 warps split K

// PK k values a byte position holds, PB byte planes, RT byte rows a thread
// loads a step, U steps prefetched, MINB blocks an SM the registers allow
template <int BITS>
struct Fmt;
template <>
struct Fmt<8> {
  static constexpr int PK = 1, PB = 1, RT = 4, U = 4, MINB = 3;
};
template <>
struct Fmt<4> {
  static constexpr int PK = 2, PB = 1, RT = 2, U = 8, MINB = 3;
};
template <>
struct Fmt<6> {
  static constexpr int PK = 4, PB = 3, RT = 1, U = 4, MINB = 2;
};

struct Args {
  const bf16* x;
  const uint8_t* q;
  const float* scales;
  bf16* out;
  int M, K, N, g, Kp;
  int steps_block;   // steps of one block (its share of K); the cluster covers K
  int chunk;         // steps of one staged x slice (a multiple of WARPS U)
  int xs_stride;     // elements of a row of the x slice: PK chunk RPS + 16
  int groups;        // scale rows a chunk touches in each slab, at most
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// a float in the shared memory of block `rank` of the cluster, at the
// address `p` has in this block's
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(hopper::smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// the unscaled weight at depth d (0-3) of column c (0-15) of a thread's step
template <int BITS, int LOADS>
__device__ __forceinline__ float value(const uint4 (&raw)[LOADS], int d, int c) {
  if constexpr (BITS == 8) {
    return i8_value(word_of(raw[d], c / 4), c % 4);
  } else if constexpr (BITS == 4) {   // depths: (row 0, lo), (row 1, lo), (row 0, hi), (row 1, hi)
    return i4_value(word_of(raw[d % 2], c / 4), 8 * (c % 4) + 4 * (d / 2));
  } else {                            // depth d is code d of the column's 24-bit word
    return fp6_value(bytes3(word_of(raw[0], c / 4), word_of(raw[1], c / 4),
                            word_of(raw[2], c / 4), c % 4), d);
  }
}

template <int BITS, int MT>
__global__ void __launch_bounds__(THREADS, Fmt<BITS>::MINB) woq_stream(const Args a) {
  using F = Fmt<BITS>;
  constexpr int RPS = 4 * F::RT;            // byte rows a step
  constexpr int LOADS = F::RT * F::PB;      // 16-byte loads a thread a step
  constexpr int MP = MT * 8;                // rows of x the products take
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                       // [MP][xs_stride]
  float* scs = reinterpret_cast<float*>(xs + MP * a.xs_stride);       // [PK][groups][COLS]
  float* red = scs + F::PK * a.groups * COLS;                         // [MP][COLS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, qd = lane / 4, j = lane % 4;
  const int tile = blockIdx.x, n0 = tile * COLS;
  const int col = n0 + qd * 16;                         // this quad's 16 columns
  const bool live = col < a.N;                          // N % 16 == 0: all 16 or none
  const int s_begin = blockIdx.y * a.steps_block;
  const int s_end = min(s_begin + a.steps_block, a.Kp / RPS);
  const int chr = a.chunk * RPS;                        // byte rows of a chunk
  const size_t plane = static_cast<size_t>(a.Kp) * a.N;
  const uint8_t* qcol = a.q + col;

  // warp w takes the block's steps s_begin + w + WARPS i; the bytes of its
  // step i are byte rows s RPS + j RT + t of planes pb, prefetched U steps
  // ahead
  uint4 raw[F::U][LOADS];
  auto load = [&](uint4(&dst)[LOADS], int i) {
    const int s = s_begin + warp + WARPS * i;
    if (s >= s_end) return;
    const size_t row = static_cast<size_t>(s) * RPS + j * F::RT;
#pragma unroll
    for (int t = 0; t < F::RT; ++t)
#pragma unroll
      for (int pb = 0; pb < F::PB; ++pb)
        dst[t * F::PB + pb] =
            live ? __ldg(reinterpret_cast<const uint4*>(qcol + pb * plane + (row + t) * a.N))
                 : make_uint4(0u, 0u, 0u, 0u);
  };
#pragma unroll
  for (int u = 0; u < F::U; ++u) load(raw[u], u);

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int tt = 0; tt < 8; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][tt][e] = 0.f;
  float sc[F::PK][16];
  int i = 0;   // this warp's step count so far (a multiple of U at every chunk)
  for (int c0 = s_begin; c0 < s_end; c0 += a.chunk) {
    const int c1 = min(c0 + a.chunk, s_end);
    const int r0 = c0 * RPS, rows = (c1 - c0) * RPS;
    const int g0 = r0 / a.g;
    __syncthreads();   // the previous chunk's slice and scales are read
    // x's live rows of this chunk in each slab and the chunk's scale rows of
    // each slab for the block's columns, all by cp.async at once
    const int x4 = F::PK * (rows / 4);   // 8-byte pieces of a row
    for (int e = threadIdx.x; e < a.M * x4; e += THREADS) {
      const int m = e / x4, p = (e % x4) / (rows / 4), r4 = 4 * (e % (rows / 4));
      hopper::cp_async_8(hopper::smem_addr(xs + m * a.xs_stride + p * chr + r4),
                 a.x + static_cast<size_t>(m) * a.K + p * a.Kp + r0 + r4);
    }
    const int ng = (r0 + rows - 1) / a.g - g0 + 1;
    for (int e = threadIdx.x; e < F::PK * ng * (COLS / 4); e += THREADS) {
      const int p = e / (ng * (COLS / 4)), rest = e % (ng * (COLS / 4));
      const int gi = rest / (COLS / 4), c4 = 4 * (rest % (COLS / 4));
      if (n0 + c4 < a.N)
        hopper::cp_async_16(
            hopper::smem_addr(scs + (p * a.groups + gi) * COLS + c4),
            a.scales + static_cast<size_t>(p * (a.Kp / a.g) + g0 + gi) * a.N + n0 + c4, 16u);
    }
    hopper::cp_async_wait_all();
    __syncthreads();
    int gcur = -1;
    const int n_w = (c1 - c0 - warp + WARPS - 1) / WARPS;   // this warp's steps in the chunk
    for (int i0 = 0; i0 < n_w; i0 += F::U) {
#pragma unroll
      for (int u = 0; u < F::U; ++u) {
        if (i0 + u < n_w) {
          const int s = c0 + warp + WARPS * (i0 + u);
          const int rl = (s - c0) * RPS;   // the step's first row in the chunk
          const int gi = (s * RPS) / a.g - g0;
          if (gi != gcur) {   // a new group: its 16 scales of each slab
            gcur = gi;
#pragma unroll
            for (int p = 0; p < F::PK; ++p)
#pragma unroll
              for (int v4 = 0; v4 < 4; ++v4) {
                const float4 v = *reinterpret_cast<const float4*>(
                    scs + (p * a.groups + gi) * COLS + qd * 16 + 4 * v4);
                sc[p][4 * v4] = v.x;
                sc[p][4 * v4 + 1] = v.y;
                sc[p][4 * v4 + 2] = v.z;
                sc[p][4 * v4 + 3] = v.w;
              }
          }
          // B: x at this lane's 4 depths, rows qd of each 8-row tile (0 past M)
          uint32_t bx[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const bf16* xr = xs + (mt * 8 + qd) * a.xs_stride + rl;
            if (mt * 8 + qd >= a.M) {
              bx[mt][0] = bx[mt][1] = 0u;
            } else if constexpr (BITS == 8) {
              const uint2 v = *reinterpret_cast<const uint2*>(xr + 4 * j);
              bx[mt][0] = v.x;
              bx[mt][1] = v.y;
            } else if constexpr (BITS == 4) {
              bx[mt][0] = *reinterpret_cast<const uint32_t*>(xr + 2 * j);
              bx[mt][1] = *reinterpret_cast<const uint32_t*>(xr + chr + 2 * j);
            } else {
              const uint16_t* h = reinterpret_cast<const uint16_t*>(xr + j);
              bx[mt][0] = h[0] | (static_cast<uint32_t>(h[chr]) << 16);
              bx[mt][1] = h[2 * chr] | (static_cast<uint32_t>(h[3 * chr]) << 16);
            }
          }
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) {
            const int c0c = 2 * tt, c1c = 2 * tt + 1;
            auto v = [&](int d, int c) {   // depth d's scale set: its slab
              const int set = F::PK == 1 ? 0 : (F::PK == 2 ? d / 2 : d);
              return __fmul_rn(value<BITS>(raw[u], d, c), sc[set][c]);
            };
            const uint32_t af[4] = {hopper::pack_bf16(v(0, c0c), v(1, c0c)),
                                    hopper::pack_bf16(v(0, c1c), v(1, c1c)),
                                    hopper::pack_bf16(v(2, c0c), v(3, c0c)),
                                    hopper::pack_bf16(v(2, c1c), v(3, c1c))};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              hopper::mma_16816(acc[mt][tt], af, bx[mt][0], bx[mt][1]);
          }
          load(raw[u], i + u + F::U);
        }
      }
      i += F::U;
    }
  }

  // the four warps' sums into `red`, in warp order; a thread holds y[m][n]
  // at m = mt 8 + 2 j + e, n = col + 2 tt (acc[e]) and n + 1 (acc[2 + e])
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) {
            float2* r = reinterpret_cast<float2*>(red + (mt * 8 + 2 * j + e) * COLS + qd * 16 +
                                                  2 * tt);
            const float2 mine = make_float2(acc[mt][tt][e], acc[mt][tt][2 + e]);
            if (w == 0) {
              *r = mine;
            } else {
              const float2 o = *r;
              *r = make_float2(o.x + mine.x, o.y + mine.y);
            }
          }
    }
    __syncthreads();
  }
  // the cluster's blocks (the K splits of these columns) sum their sums in
  // rank order, each block taking every cs-th element
  const int cs = gridDim.y;
  const uint32_t rank = cluster_rank();
  cluster_sync();
  for (int e = threadIdx.x + rank * THREADS; e < a.M * COLS; e += THREADS * cs) {
    const int m = e / COLS, n = n0 + e % COLS;
    if (n >= a.N) continue;
    float sum = 0.f;
    for (int r = 0; r < cs; ++r) sum += ld_cluster(red + e, r);
    a.out[static_cast<size_t>(m) * a.N + n] = __float2bfloat16_rn(sum);
  }
  cluster_sync();   // no block leaves while another reads its shared memory
}

template <int BITS, int MT>
cudaError_t launch(Args a, int cs, cudaStream_t stream) {
  using F = Fmt<BITS>;
  if (a.chunk % (WARPS * F::U)) return cudaErrorInvalidValue;   // the plan's unit
  a.xs_stride = F::PK * a.chunk * 4 * F::RT + 16;
  const size_t smem = static_cast<size_t>(MT) * 8 * a.xs_stride * sizeof(bf16) +
                      static_cast<size_t>(F::PK) * a.groups * COLS * 4 +
                      static_cast<size_t>(MT) * 8 * COLS * 4;
  cudaError_t e = cudaFuncSetAttribute(woq_stream<BITS, MT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + COLS - 1) / COLS, cs, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, woq_stream<BITS, MT>, a);
}

// one n8 tile of rows, or two for int8 above 8 rows (the route's largest M,
// STREAM_MAX_M in ops/woq_matmul.py: 16 at int8, 8 at int4 and fp6)
template <int BITS>
cudaError_t launch_m(const Args& a, int cs, cudaStream_t stream) {
  if constexpr (BITS == 8) {
    if (a.M > 8) return launch<BITS, 2>(a, cs, stream);
  }
  return launch<BITS, 1>(a, cs, stream);
}

}  // namespace stream

// ====================================================== wgmma route (large M)

namespace wg {

using namespace hopper;

constexpr int BN = 128, BR = 64;   // columns and byte rows of a stage

// PK k values a byte position holds and PB byte planes, by bit width
template <int BITS>
struct Planes;
template <>
struct Planes<8> {
  static constexpr int PK = 1, PB = 1;
};
template <>
struct Planes<4> {
  static constexpr int PK = 2, PB = 1;
};
template <>
struct Planes<6> {
  static constexpr int PK = 4, PB = 3;
};

// a tile of BM_ rows (256, or 128 where 256-row tiles leave SMs idle), the
// x slabs a stage holds (all PK, but one at a time for fp6 at 256 rows, so
// that its byte rows come once for each slab: three stages of one slab
// measured faster than two of two) and the stages that fit
template <int BITS, int BM_>
struct Fmt : Planes<BITS> {
  static constexpr int BM = BM_;
  static constexpr int SL = BM == 256 && Planes<BITS>::PK == 4 ? 1 : Planes<BITS>::PK;
  static constexpr int XSLAB = BM * 128;           // BM rows x 64 k of bf16
  static constexpr int WPLANE = BR * BN;           // 64 byte rows x 128 columns
  static constexpr int SCALES = 2 * BN * 4;        // two group rows x 128 columns of f32
  static constexpr int STAGE = SL * (XSLAB + SCALES) + Planes<BITS>::PB * WPLANE;
  static constexpr int FIT = (232448 - 1024 - 64) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 2 && BYTES <= 232448, "shared memory");
};

struct Args {
  const float* scales;
  bf16* out;
  int M, K, N, g, Kp;
};

// the unscaled weight of byte row i (0-3: rows 2j, 2j+1, 2j+8, 2j+9 of the
// step), column h (0: n, 1: n + 1), slab p
template <int BITS, int PB>
__device__ __forceinline__ float value(const uint32_t (&raw)[PB][4], int i, int h, int p) {
  if constexpr (BITS == 8) {
    return i8_value(raw[0][i], h);
  } else if constexpr (BITS == 4) {
    return i4_value(raw[0][i], 8 * h + 4 * p);
  } else {
    return fp6_value(bytes3(raw[0][i], raw[1][i], raw[2][i], h), p);
  }
}

template <int BITS, int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
    woq_wgmma(const Args a, const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap ts) {
  using F = Fmt<BITS, BM>;
  using SM = F;
  constexpr int MT = BM / 128;   // wgmma n128 products a fragment feeds
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::BARS);
  uint64_t* empty = full + F::STAGES;
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  if (threadIdx.x == 0) {
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * WG);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int m_tiles = (a.M + F::BM - 1) / F::BM;
  const int tiles = m_tiles * ((a.N + BN - 1) / BN);
  const int kstages = (a.Kp + BR - 1) / BR;

  if (wg == CONSUMERS) {  // ------------------------------------------ producer
    regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      StageRing<F::STAGES> ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * F::BM, n0 = (t / m_tiles) * BN;
        for (int ks = 0; ks < kstages; ++ks)
          for (int hh = 0; hh < F::PK / F::SL; ++hh, ring.next()) {
            mbar_wait(&empty[ring.s], ring.phase ^ 1);
            unsigned char* st = smem + ring.s * SM::STAGE;
            mbar_arrive_expect_tx(&full[ring.s], SM::STAGE);
#pragma unroll
            for (int pl = 0; pl < F::SL; ++pl)
              tma_load_2d(st + pl * SM::XSLAB, &tx, &full[ring.s],
                          (hh * F::SL + pl) * a.Kp + ks * BR, m0);
#pragma unroll
            for (int pb = 0; pb < F::PB; ++pb)
              tma_load_3d(st + F::SL * SM::XSLAB + pb * SM::WPLANE, &tw, &full[ring.s], n0,
                          ks * BR, pb);
            // the two scale rows from the stage's first group, each slab
#pragma unroll
            for (int pl = 0; pl < F::SL; ++pl)
              tma_load_2d(st + F::SL * SM::XSLAB + F::PB * SM::WPLANE + pl * SM::SCALES, &ts,
                          &full[ring.s], n0, ((hh * F::SL + pl) * a.Kp + ks * BR) / a.g);
          }
      }
    }
    return;
  }

  // --------------------------------------------------------------- consumers
  regs_inc<CONSUMER_REGS>();
  const int warp = tid / 32, lane = tid % 32, qd = lane / 4, j = lane % 4;
  // A rows 16 warp + qd and + 8 are this thread's columns nl and nl + 1
  const int nl = 64 * wg + 16 * warp + 2 * qd;
  const int chunk = nl >> 4, inb = nl & 15;
  constexpr int KB = F::SL == 4 ? 1 : 2;   // k16 steps a batch (a stage holds 4)
  constexpr int FR = KB * F::SL;            // A fragments a batch
  float acc[MT][64];
  uint32_t afr[2][FR][4];
  StageRing<F::STAGES> ring;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % m_tiles) * F::BM, n0 = (t / m_tiles) * BN;
    const int n = n0 + nl;
    const bool live = n < a.N;   // N even: n + 1 too
    // acc is written whole by the tile's first product (scale-d 0)
    int prev = -1;
    for (int kh = 0; kh < kstages * (F::PK / F::SL); ++kh) {
      const int ks = kh / (F::PK / F::SL), hh = kh % (F::PK / F::SL);
      mbar_wait(&full[ring.s], ring.phase);
      const unsigned char* st = smem + ring.s * SM::STAGE;
      const uint32_t xs0 = smem_addr(st);
      const unsigned char* wsm = st + F::SL * SM::XSLAB;
      const float* ssm = reinterpret_cast<const float*>(wsm + F::PB * SM::WPLANE);
      // this thread's bytes of the stage: rows 2j, 2j+1, 2j+8, 2j+9 of each step
      uint32_t raw[4][F::PB][4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int pb = 0; pb < F::PB; ++pb)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rl = 16 * s + 2 * j + (i & 1) + 8 * (i >> 1);
            raw[s][pb][i] = *reinterpret_cast<const uint16_t*>(
                wsm + pb * SM::WPLANE + rl * 128 + ((chunk ^ (rl & 7)) << 4) + inb);
          }
      // batches of KB k16 steps by the stage's SL slabs: dequantized
      // together (the loads and conversions of several fragments in flight),
      // issued together, one batch in flight while the next is dequantized
#pragma unroll
      for (int bt = 0; bt < 4 / KB; ++bt) {
        if (ks * BR + 16 * KB * bt >= a.Kp) break;   // the block's own bound
        const int buf = bt & 1;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
#pragma unroll
          for (int pl = 0; pl < F::SL; ++pl) {
            const int s = bt * KB + kk, p = hh * F::SL + pl;
            const int row = (p * a.Kp + ks * BR + 16 * s) / a.g - (p * a.Kp + ks * BR) / a.g;
            const float2 sc = *reinterpret_cast<const float2*>(ssm + (pl * 2 + row) * BN + nl);
            auto v = [&](int i, int h) {
              return __fmul_rn(value<BITS, F::PB>(raw[s], i, h, p), h ? sc.y : sc.x);
            };
            uint32_t(&f)[4] = afr[buf][kk * F::SL + pl];
            f[0] = pack_bf16(v(0, 0), v(1, 0));
            f[1] = pack_bf16(v(0, 1), v(1, 1));
            f[2] = pack_bf16(v(2, 0), v(3, 0));
            f[3] = pack_bf16(v(2, 1), v(3, 1));
          }
#pragma unroll
        for (int f = 0; f < FR; ++f) fence_regs(afr[buf][f]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
#pragma unroll
          for (int pl = 0; pl < F::SL; ++pl) {
            const int s = bt * KB + kk;
            const int accumulate = kh > 0 || bt > 0 || kk > 0 || pl > 0;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              Wgmma<128>::rs<0>(acc[mt], afr[buf][kk * F::SL + pl],
                                desc_k_major(xs0 + pl * SM::XSLAB + mt * 128 * 128, F::BM, s),
                                accumulate);
          }
        wgmma_commit();
        wgmma_wait<1>();   // the previous batch's products are done
#pragma unroll
        for (int f = 0; f < FR; ++f) fence_regs(afr[buf ^ 1][f]);
        if (bt == 0 && prev >= 0) mbar_arrive(&empty[prev]);
      }
      prev = ring.s;
      ring.next();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      fence_regs(afr[0][f]);
      fence_regs(afr[1][f]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    mbar_arrive(&empty[prev]);
    // d[4 jj + 2 h + e] is y[m][n + h] at m = m0 + 128 mt + 8 jj + 2 j + e
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 128 * mt + 8 * jj + 2 * j + e;
          if (m < a.M && live)
            *reinterpret_cast<uint32_t*>(a.out + static_cast<size_t>(m) * a.N + n) =
                pack_bf16(acc[mt][4 * jj + e], acc[mt][4 * jj + 2 + e]);
        }
  }
}

template <int BITS, int BM>
cudaError_t launch(const Args& a, const void* x, const void* q, const void* scales, int sms,
                   cudaStream_t stream) {
  using F = Fmt<BITS, BM>;
  CUtensorMap tx, tw, ts;
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(a.K), static_cast<cuuint64_t>(a.M)};
  const cuuint64_t xs[1] = {static_cast<cuuint64_t>(a.K) * 2};
  const cuuint32_t xb[2] = {64, static_cast<cuuint32_t>(F::BM)};
  cudaError_t e = tiled_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, xd, xs, xb);
  if (e != cudaSuccess) return e;
  const cuuint64_t wd[3] = {static_cast<cuuint64_t>(a.N), static_cast<cuuint64_t>(a.Kp),
                            static_cast<cuuint64_t>(F::PB)};
  const cuuint64_t ws[2] = {static_cast<cuuint64_t>(a.N),
                            static_cast<cuuint64_t>(a.N) * a.Kp};
  const cuuint32_t wb[3] = {BN, BR, 1};
  e = tiled_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 3, wd, ws, wb);
  if (e != cudaSuccess) return e;
  const cuuint64_t sd[2] = {static_cast<cuuint64_t>(a.N), static_cast<cuuint64_t>(a.K / a.g)};
  const cuuint64_t ss[1] = {static_cast<cuuint64_t>(a.N) * 4};
  const cuuint32_t sb[2] = {BN, 2};
  e = tiled_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, 2, sd, ss, sb,
                CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(woq_wgmma<BITS, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           F::BYTES);
  if (e != cudaSuccess) return e;
  const int tiles = ((a.M + F::BM - 1) / F::BM) * ((a.N + BN - 1) / BN);
  woq_wgmma<BITS, BM><<<tiles < sms ? tiles : sms, WG_THREADS, F::BYTES, stream>>>(a, tx, tw,
                                                                                      ts);
  return cudaGetLastError();
}

// 256-row tiles where they give every SM one, else 128-row tiles
template <int BITS>
cudaError_t launch_rows(const Args& a, const void* x, const void* q, const void* scales, int sms,
                        cudaStream_t stream) {
  if (((a.M + 255) / 256) * ((a.N + BN - 1) / BN) >= sms)
    return launch<BITS, 256>(a, x, q, scales, sms, stream);
  return launch<BITS, 128>(a, x, q, scales, sms, stream);
}

}  // namespace wg

}  // namespace

// x (M, K) bf16; q int8 (K, N) / int4 planes (K/2, N) / fp6 planes
// (3, K/4, N); scales (K/g, N) f32; out (M, N) bf16. K % (g * PK) == 0 and
// g % 32 == 0. route 0 (simt): splits K ranges of `per` rows (a multiple of
// 32), part (splits, M, N) f32 scratch when splits > 1. route 1 (stream, M
// <= 16 at int8, 8 at int4 / fp6, N % 16 == 0): clusters of `splits` (<= 8) blocks along K, each
// block `per` steps of 16 k values staged `chunk` steps (a multiple of 4 U)
// at a time. route 2 (wgmma, N % 16 == 0): persistent over min(tiles, sms)
// blocks. Routes 1 and 2 need x, q and scales 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int ds_woq_matmul(const void* x, const void* q, const void* scales, void* out,
                             void* part, int M, int K, int N, int g, int bits, int route,
                             int splits, int per, int chunk, int sms, void* stream) {
  const int pk = bits == 8 ? 1 : (bits == 4 ? 2 : 4);
  if (M <= 0 || N <= 0 || K <= 0 || g <= 0 || g % 32 || K % (g * pk) || splits <= 0 ||
      per <= 0 || (bits != 8 && bits != 4 && bits != 6) || route < 0 || route > 2)
    return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (per % simt::BK) return cudaErrorInvalidValue;
    simt::Args a;
    a.x = static_cast<const bf16*>(x);
    a.q = static_cast<const int8_t*>(q);
    a.scales = static_cast<const float*>(scales);
    a.out = static_cast<bf16*>(out);
    a.part = static_cast<float*>(part);
    a.M = M;
    a.K = K;
    a.N = N;
    a.g = g;
    a.splitk = splits;
    a.k_per_split = per;
    a.vec_x = aligned(x) && K % 8 == 0;
    a.vec_q = aligned(q) && N % 16 == 0;
    switch (bits) {
      case 8: return simt::launch<8>(a, st);
      case 4: return simt::launch<4>(a, st);
      default: return simt::launch<6>(a, st);
    }
  }
  if (N % 16 || !aligned(x) || !aligned(q) || !aligned(scales)) return cudaErrorInvalidValue;
  if (route == 1) {
    if (M > (bits == 8 ? 16 : 8) || splits > 8) return cudaErrorInvalidValue;
    stream::Args a;
    a.x = static_cast<const bf16*>(x);
    a.q = static_cast<const uint8_t*>(q);
    a.scales = static_cast<const float*>(scales);
    a.out = static_cast<bf16*>(out);
    a.M = M;
    a.K = K;
    a.N = N;
    a.g = g;
    a.Kp = K / pk;
    a.steps_block = per;
    a.chunk = chunk;
    a.groups = (chunk * (16 / pk) - 1) / g + 2;
    switch (bits) {
      case 8: return stream::launch_m<8>(a, splits, st);
      case 4: return stream::launch_m<4>(a, splits, st);
      default: return stream::launch_m<6>(a, splits, st);
    }
  }
  wg::Args a;
  a.scales = static_cast<const float*>(scales);
  a.out = static_cast<bf16*>(out);
  a.M = M;
  a.K = K;
  a.N = N;
  a.g = g;
  a.Kp = K / pk;
  switch (bits) {
    case 8: return wg::launch_rows<8>(a, x, q, scales, sms, st);
    case 4: return wg::launch_rows<4>(a, x, q, scales, sms, st);
    default: return wg::launch_rows<6>(a, x, q, scales, sms, st);
  }
}
