// Fused single-token decode attention over a contiguous KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// (_decode_kernel, launched by fused_decode_attention). Semantics, for
// sequence b and query head h = kh * G + g (G = H / KVH heads per kv head):
//   s_j = (q . k_j) * scale        for cache slots j < cache_len[b]
//   p_j = exp(s_j - m),  l = sum_j p_j,  acc = sum_j bf16(p_j) * v_j
//   out = acc / l, and 0 for a sequence with cache_len == 0
// The scale multiplies the f32 dot (it is not folded into q; the kernel
// multiplies by scale * log2 e and takes powers of 2), and p is rounded to
// the cache dtype before the P.V product while l sums the f32 p, as the TPU
// kernel does. Slots at or past cache_len are never read.
//
// What bounds it on this card: bytes. Each live K and V row is read once
// (2 * D bytes per slot and kv head in bf16) for ~4 flops per byte, far below
// the ~295 flops/byte where the tensor cores would matter. At the main shape
// (B 4, 8192 live slots, 8 kv heads, D 128) that is 134 MB, 0.040 ms at
// 3.35 TB/s, so the design's job is to keep enough bytes in flight on every
// SM and to keep the arithmetic off the loads' path.
//
// Design. Work items are (sequence, chunk of its live slots, kv head, group
// of up to 16 query rows); a chunk is a run of 64-slot tiles. The plan is a
// pure function of cache_len, KVH, the row groups and the SM count
// (plan() in ops/decode_attention.py holds the same arithmetic and the CPU
// tests check it): T = sum_b ceil(len_b / 64) live tiles, tpc = max(1,
// ceil(T KVH RG / SMs)) tiles a chunk, n_b = max(1, ceil(tiles_b / tpc))
// chunks of sequence b cutting its tiles evenly, items ordered by (b, chunk,
// kv head, row group). Every block evaluates it from the device's
// cache_len, so the call needs no host sync and no chunk lies past
// cache_len; the grid is SMs + B KVH RG (grid_size), an upper bound of the
// items, and blocks past the last item exit. A block is one producer warp
// and four consumer warps. The producer streams the chunk's K and V tiles (64 slots
// of one kv head, one TMA box per 64 columns, 128-byte swizzle) through a
// ring of 4 stages (3 at D 256; 32 KB a stage at D 128), each stage guarded
// by a full and an empty mbarrier; the tile that holds cache_len is copied
// by cp.async with its dead rows zero-filled, never read. Each consumer warp
// takes 16 slots of a stage: S = Q K^T by mma.sync m16n8k16 (Q, the item's
// query rows, as the A operand in registers for the whole chunk; K by
// ldmatrix), the online softmax on the score fragments (a row's max over
// the 4 threads that hold it: 2 shuffles per 16 slots), and O += P V with P
// straight from the score registers and V by ldmatrix.trans; O stays in f32
// registers. The four warps merge through shared memory in a fixed order.
// A chunk that is its sequence's only one writes out; otherwise it writes
// its (m, l, acc) and bumps a counter, and the block that arrives last for
// its (sequence, kv head, row group) merges every chunk's partial in chunk
// order and resets the counter: one launch, and the same bits on every run
// whichever block finishes last.
//
// Layout: q/out (B, H, D) bf16; k/v (B, S, KVH, D) bf16; lens (B,) int32;
// ws_acc (B, KVH, RG, maxc, 16, D) f32 and ws_ml (..., 16, 2) f32 scratch,
// counters (B, KVH, RG) int32, zero, and left zero. D in {64, 128, 192, 256};
// any G (query rows taken 16 at a time, RG = ceil(G / 16)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int R = 64;                       // cache slots a tile (a TMA box of rows)
constexpr int CWARPS = 4;                   // consumer warps, 16 slots of a tile each
constexpr int NTHREADS = (CWARPS + 1) * 32;
constexpr int ROWS = 16;                    // query rows an item (the mma's M)
constexpr int MERGE_BAR = 1;                // named barrier of the consumer warps

template <int D>
struct Cfg {
  static constexpr int STAGES = D == 256 ? 3 : 4;
  static constexpr int TILE = R * D * 2;    // one K or V tile, bytes
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BARRIERS = STAGES * STAGE;
  static constexpr int SMEM = BARRIERS + 2 * STAGES * 8 + 16 + 1024;
  // the merge of the four warps reuses the ring
  static_assert(CWARPS * ROWS * (D + 2) * 4 <= STAGES * STAGE, "merge buffer");
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* lens;
  float* ws_acc;
  float* ws_ml;
  int* counters;
  bf16* out;
  int B, H, KVH, S, G, RG, sms, maxc, grid;
  float scale_log2;   // scale * log2(e)
};

struct Item {
  int b, kh, rg, j, n, t0, t1, len;
};

__device__ __forceinline__ int live_len(const Args& a, int b) {
  return min(max(a.lens[b], 0), a.S);
}

// item i of the plan (see the header); false past the last item
__device__ bool find_item(const Args& a, int i, Item& it) {
  int total = 0;
  for (int b = 0; b < a.B; ++b) total += (live_len(a, b) + R - 1) / R;
  const int per = a.KVH * a.RG;
  const long long units = static_cast<long long>(total) * per;
  const int tpc = max(1, static_cast<int>((units + a.sms - 1) / a.sms));
  for (int b = 0; b < a.B; ++b) {
    const int len = live_len(a, b);
    const int tb = (len + R - 1) / R;
    const int n = max(1, (tb + tpc - 1) / tpc);
    if (i < n * per) {
      const int j = i / per, rest = i % per;
      it = {b, rest / a.RG, rest % a.RG, j, n, j * tb / n, (j + 1) * tb / n, len};
      return true;
    }
    i -= n * per;
  }
  return false;
}

// byte offset of element (row r, column c; c a multiple of 8) in a swizzled tile
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c / 64) * (R * 128) + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    decode_kernel(const Args a, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARRIERS);
  uint64_t* empty = full + C::STAGES;
  int* last_flag = reinterpret_cast<int*>(empty + C::STAGES);

  Item it;
  if (!find_item(a, blockIdx.x, it)) return;   // the same for the whole block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = min(ROWS, a.G - it.rg * ROWS);
  const size_t head0 = static_cast<size_t>(it.kh) * a.G + it.rg * ROWS;
  bf16* out = a.out + (static_cast<size_t>(it.b) * a.H + head0) * D;
  if (it.len == 0) {   // an empty sequence: its one item writes zeros
    for (int i = threadIdx.x; i < rows * D; i += NTHREADS) out[i] = __float2bfloat16_rn(0.f);
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int ntiles = it.t1 - it.t0;
  const int end = min(it.t1 * R, it.len);

  if (warp == CWARPS) {  // ------------------------------------------ producer
    StageRing<C::STAGES> ring;
    bool copied = false;
    for (int t = 0; t < ntiles; ++t, ring.next()) {
      const int row0 = (it.t0 + t) * R;
      unsigned char* st = smem + ring.s * C::STAGE;
      mbar_wait(&empty[ring.s], ring.phase ^ 1);
      if (row0 + R <= end) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[ring.s], C::STAGE);
          tma_rows<D>(reinterpret_cast<bf16*>(st), &tk, &full[ring.s], R, it.kh, row0, it.b);
          tma_rows<D>(reinterpret_cast<bf16*>(st + C::TILE), &tv, &full[ring.s], R, it.kh, row0,
                      it.b);
        }
      } else {  // the tile holding cache_len: live rows only
        constexpr int CH = D / 8;   // 16-byte pieces a row
        for (int i = lane; i < 2 * R * CH; i += 32) {
          const int which = i / (R * CH), r = (i / CH) % R, c = i % CH;
          const bool live = row0 + r < end;
          const bf16* src = (which ? a.v : a.k) +
                            ((static_cast<size_t>(it.b) * a.S + (live ? row0 + r : row0)) * a.KVH +
                             it.kh) * D + c * 8;
          cp_async_16(smem_addr(st + which * C::TILE + swz<D>(r, c * 8)), src, live ? 16u : 0u);
        }
        cp_async_mbar_arrive(&full[ring.s]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[ring.s]);
        copied = true;
      }
    }
    if (copied) cp_async_wait_all();
    return;
  }

  // --------------------------------------------------------------- consumers
  const int g = lane / 4, t4 = lane % 4;
  // Q rows g and g + 8 of the item as the A operand, D / 16 depth steps
  uint32_t qa[D / 16][4];
  {
    const bf16* q0 = a.q + (static_cast<size_t>(it.b) * a.H + head0 + g) * D + 2 * t4;
    const bf16* q1 = q0 + 8 * D;
    const bool l0 = g < rows, l1 = g + 8 < rows;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qa[ks][0] = l0 ? ld_pair(q0 + 16 * ks) : 0u;
      qa[ks][1] = l1 ? ld_pair(q1 + 16 * ks) : 0u;
      qa[ks][2] = l0 ? ld_pair(q0 + 16 * ks + 8) : 0u;
      qa[ks][3] = l1 ? ld_pair(q1 + 16 * ks + 8) : 0u;
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // rows g and g + 8 (log2 units)

  // ldmatrix row addresses: lane i gives row i % 8 of matrix i / 8
  const int mi = lane / 8;
  const int k_row = 16 * warp + (mi / 2) * 8 + lane % 8, k_col = (mi % 2) * 8;   // K, non-trans
  const int v_row = 16 * warp + (mi % 2) * 8 + lane % 8, v_col = (mi / 2) * 8;   // V, trans

  StageRing<C::STAGES> ring;
  for (int t = 0; t < ntiles; ++t, ring.next()) {
    const int row0 = (it.t0 + t) * R;
    mbar_wait(&full[ring.s], ring.phase);
    const uint32_t kt = smem_addr(smem + ring.s * C::STAGE), vt = kt + C::TILE;
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + swz<D>(k_row, 16 * ks + k_col));
      mma_16816(sc[0], qa[ks], kb[0], kb[1]);
      mma_16816(sc[1], qa[ks], kb[2], kb[3]);
    }
    // scores in log2 units; slots at or past cache_len (the last tile only) -inf
    const bool tail = row0 + R > end;
#pragma unroll
    for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n8][e] *= a.scale_log2;
        if (tail && row0 + 16 * warp + 8 * n8 + 2 * t4 + (e & 1) >= end) sc[n8][e] = -INFINITY;
      }
    float x0 = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
    float x1 = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    const float u0 = n0 == -INFINITY ? 0.f : n0, u1 = n1 == -INFINITY ? 0.f : n1;
    const float alpha0 = exp2_approx(m0 - u0), alpha1 = exp2_approx(m1 - u1);
    float p[2][4];
#pragma unroll
    for (int n8 = 0; n8 < 2; ++n8) {
      p[n8][0] = exp2_approx(sc[n8][0] - u0);
      p[n8][1] = exp2_approx(sc[n8][1] - u0);
      p[n8][2] = exp2_approx(sc[n8][2] - u1);
      p[n8][3] = exp2_approx(sc[n8][3] - u1);
    }
    l0 = l0 * alpha0 + ((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
    l1 = l1 * alpha1 + ((p[0][2] + p[0][3]) + (p[1][2] + p[1][3]));
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha0;
      o[i][1] *= alpha0;
      o[i][2] *= alpha1;
      o[i][3] *= alpha1;
    }
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + swz<D>(v_row, 16 * dp + v_col));
      mma_16816(o[2 * dp], pa, vb[0], vb[1]);
      mma_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[ring.s]);
  }
  // l over the quad of threads that share a row
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // merge the four warps in shared memory (the ring, now idle), in warp order
  float* wm = reinterpret_cast<float*>(smem);                 // [CWARPS][ROWS] m
  float* wl = wm + CWARPS * ROWS;                             // [CWARPS][ROWS] l
  float* wacc = wl + CWARPS * ROWS;                           // [CWARPS][ROWS][D]
  named_sync<CWARPS * 32>(MERGE_BAR);   // every warp is done reading the ring
  if (t4 == 0) {
    wm[warp * ROWS + g] = m0;
    wm[warp * ROWS + g + 8] = m1;
    wl[warp * ROWS + g] = l0;
    wl[warp * ROWS + g + 8] = l1;
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    float* r0p = wacc + (warp * ROWS + g) * D + 8 * i + 2 * t4;
    float* r1p = r0p + 8 * D;
    r0p[0] = o[i][0];
    r0p[1] = o[i][1];
    r1p[0] = o[i][2];
    r1p[1] = o[i][3];
  }
  named_sync<CWARPS * 32>(MERGE_BAR);
  const int tid = threadIdx.x;   // 0 .. 127
  const size_t part = ((static_cast<size_t>(it.b) * a.KVH + it.kh) * a.RG + it.rg) * a.maxc;
  for (int i = tid; i < rows * D; i += CWARPS * 32) {
    const int r = i / D, d = i % D;
    float mm = wm[r];
#pragma unroll
    for (int w = 1; w < CWARPS; ++w) mm = fmaxf(mm, wm[w * ROWS + r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) {
      const float f = exp2_approx(wm[w * ROWS + r] - mm);   // 0 for a warp with no slot
      ll += wl[w * ROWS + r] * f;
      aa += wacc[(w * ROWS + r) * D + d] * f;
    }
    if (it.n == 1) {
      out[r * D + d] = __float2bfloat16_rn(aa / ll);
    } else {
      const size_t row = (part + it.j) * ROWS + r;
      a.ws_acc[row * D + d] = aa;
      if (d == 0) {
        a.ws_ml[row * 2] = mm;
        a.ws_ml[row * 2 + 1] = ll;
      }
    }
  }
  if (it.n == 1) return;

  // the last of the sequence's chunks to finish merges them all, in order
  __threadfence();
  named_sync<CWARPS * 32>(MERGE_BAR);
  int* counter = a.counters + (static_cast<size_t>(it.b) * a.KVH + it.kh) * a.RG + it.rg;
  if (tid == 0) *last_flag = atomicAdd(counter, 1) == it.n - 1;
  named_sync<CWARPS * 32>(MERGE_BAR);
  if (!*last_flag) return;
  __threadfence();
  for (int i = tid; i < rows * D; i += CWARPS * 32) {
    const int r = i / D, d = i % D;
    float mm = -INFINITY;
    for (int c = 0; c < it.n; ++c) mm = fmaxf(mm, __ldcg(a.ws_ml + ((part + c) * ROWS + r) * 2));
    float ll = 0.f, aa = 0.f;
    for (int c = 0; c < it.n; ++c) {
      const size_t row = (part + c) * ROWS + r;
      const float f = exp2_approx(__ldcg(a.ws_ml + row * 2) - mm);
      ll += __ldcg(a.ws_ml + row * 2 + 1) * f;
      aa += __ldcg(a.ws_acc + row * D + d) * f;
    }
    out[r * D + d] = __float2bfloat16_rn(aa / ll);
  }
  if (tid == 0) *counter = 0;
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  CUtensorMap tk, tv;
  const long long row = static_cast<long long>(a.KVH) * D;
  cudaError_t e = rows_map(&tk, a.k, D, a.KVH, a.S, a.B, row, row * a.S, R);
  if (e != cudaSuccess) return e;
  e = rows_map(&tv, a.v, D, a.KVH, a.S, a.B, row, row * a.S, R);
  if (e != cudaSuccess) return e;
  // the attribute belongs to the current device: set it on every launch
  e = cudaFuncSetAttribute(decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg<D>::SMEM);
  if (e != cudaSuccess) return e;
  decode_kernel<D><<<a.grid, NTHREADS, Cfg<D>::SMEM, stream>>>(a, tk, tv);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, D), k/v (B, S, KVH, D) bf16, lens (B,) int32, scratch ws_acc
// (B, KVH, RG, maxc, 16, D) and ws_ml (B, KVH, RG, maxc, 16, 2) f32 with
// RG = ceil(H / KVH / 16), counters (B, KVH, RG) int32 zero (and left zero),
// out (B, H, D) bf16; sms the SMs the plan spreads over; maxc >= the most
// chunks the plan gives a sequence and grid >= its items (decode_attention.py
// max_chunks, grid_size). D in {64, 128, 192, 256}. Returns the cudaError_t
// of the launch.
extern "C" int ds_decode_attention(const void* q, const void* k, const void* v, const void* lens,
                                   void* ws_acc, void* ws_ml, void* counters, void* out, int B,
                                   int H, int KVH, int S, int D, int sms, int maxc, int grid,
                                   float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || sms <= 0 || maxc <= 0 ||
      grid <= 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.lens = static_cast<const int*>(lens);
  a.ws_acc = static_cast<float*>(ws_acc);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.counters = static_cast<int*>(counters);
  a.out = static_cast<bf16*>(out);
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.G = H / KVH;
  a.RG = (a.G + ROWS - 1) / ROWS;
  a.sms = sms;
  a.maxc = maxc;
  a.grid = grid;
  a.scale_log2 = scale * LOG2E;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(a, st);
    case 128: return launch<128>(a, st);
    case 192: return launch<192>(a, st);
    case 256: return launch<256>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
