// Paged ragged attention for Hopper (sm_90a): decode (C == 1) and chunked
// prefill (C > 1) over in-place KV pages, in one launch a call.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/paged_attention.py
// (_paged_kernel, launched by paged_ragged_attention). Semantics, per query
// row r = c * G + g of kv head kh (G = H / KVH query heads per kv head):
//   s = (q . k) * scale  (+ slope[h] * (key_pos - pos) with ALiBi)
//   s = softcap * tanh(s / softcap)                       (when softcap != 0)
//   visible iff key_pos >= 0, key_pos <= pos, and key_pos > pos - window
//   (window <= 0 is global); pool slots at or beyond the chunk start cs are
//   stale and invisible; the chunk's own keys (chunk_k/chunk_v, positions as
//   key positions, -1 = dead) are processed as a final virtual page.
//   p is rounded to bf16 before P.V while l sums the f32 p. A row with no
//   visible key (a pad row, pos == -1) outputs 0.
//
// What bounds it on this card: bytes at decode, where each live K/V slot is
// read once for ~4 flops a byte per query row (the main case, llama3-8b at 16
// slots, reads 33 MB: 0.0098 ms at 3.35 TB/s); at a 128-token prefill chunk
// the bytes (58 MB) and the tensor-core operations (~0.014 ms at 989
// TFLOP/s) come close. The host chooses one of two routes by shape
// (ops/paged_attention.py route):
//
// Route "split" (small C * G, and every C at D 80 and 96): paged_split<D>,
// K2's design (decode_attention.cu) with the block table. Work items are
// (sequence, row group of 16 query rows, chunk of its live pool slots, kv
// head). A row group's live slots are [lo, hi): hi = min(cs, MB * bs) with a
// chunk (min(its last position + 1, MB * bs) without), lo = the window floor
// of its first position; it is cut into 64-slot tiles from lo rounded down
// to 64. The plan is a pure function of positions, window, bs, MB, KVH, the
// row groups and the SM count (ops/paged_attention.py plan holds the same
// arithmetic and the CPU tests check it): T live tiles in all, tpc =
// max(1, ceil(T KVH / SMs)) tiles a chunk, a row group's tiles cut evenly
// into max(1, ceil(tiles / tpc)) chunks, items ordered by (sequence, row
// group, chunk, kv head). One warp of every block evaluates it on the card
// from positions (no host sync, nothing built per call on the host); blocks
// past the last item exit. A row group with no live row gets one item that
// writes its zeros. The last chunk of a (sequence, row group, kv head) also
// folds in the chunk's own keys that its rows can see. A block is one
// producer warp and four consumer warps (two blocks an SM up to D 128). The
// producer streams 64-slot K and V tiles through a ring of 3 stages by
// cp.async, two lanes a row (a row's address through the block table once;
// a tile spans 64 / bs pages at bs 16 or 32, part of one at bs 128), into
// rows padded to D + 8 elements (any D a multiple of 8, and conflict-free
// ldmatrix rows); a dead row (below lo, at
// or past hi, a pad chunk row) is zero-filled, never read, so a NaN parked
// in a stale slot, in trash block 0 or in a pad chunk row cannot reach a
// live row. Each consumer warp takes 16 slots of a stage: S = Q K^T by
// mma.sync m16n8k16 (Q in registers for the whole item), the masks as per-row
// slot limits, ALiBi and softcap, the online softmax on the score fragments
// in log2 units, O += P V with O in f32 registers. The four warps merge in
// shared memory in warp order; an item that is its row group's only chunk
// writes out, otherwise it writes its (m, l, acc) and bumps a counter, and
// the block arriving last for its (sequence, row group, kv head) merges
// every chunk in chunk order and resets the counter: one launch, the same
// bits on every run.
//
// Route "wgmma" (C * G large, D 64 / 128 / 256): paged_fwd_wgmma<D>, mode
// PAGED of the forward mainloop (flash_fwd_wgmma.cuh): items of 128 query
// rows of one (sequence, kv head), later row tiles first, on a persistent
// grid; Q gathered by cp.async, interior pool tiles by TMA page by page,
// boundary and chunk tiles by cp.async with dead rows zero-filled; wgmma
// for S and P.V with the accumulators in registers.
//
// Layout: q/out (B, C, H, D); kpool/vpool (L, KVH, NB, bs, D); block_tables
// (B, MB) int32; positions (B, C) int32; chunk_k/chunk_v (B, C, KVH, D) or
// null; slopes (H,) f32 or null; split scratch ws_acc (B, RG, KVH, maxc, 16,
// D) and ws_ml (..., 16, 2) f32, counters (B, RG, KVH) int32, zero and left
// zero. bf16 throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_fwd_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TK = 64;                      // pool slots a tile
constexpr int CWARPS = 4;                   // consumer warps, 16 slots of a tile each
constexpr int NTHREADS = (CWARPS + 1) * 32;
constexpr int ROWS = 16;                    // query rows an item (the mma's M)
constexpr int MERGE_BAR = 1;                // named barrier of the consumer warps
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;          // a padded shared-memory row, elements
  static constexpr int STAGES = 3;
  static constexpr int TILE = TK * LD * 2;  // one K or V tile, bytes
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BARRIERS = STAGES * STAGE;
  static constexpr int ITEM = BARRIERS + 2 * STAGES * 8;
  static constexpr int SMEM = ITEM + 64 + 16;
  // the merge of the four warps reuses the ring
  static_assert(CWARPS * ROWS * (D + 2) * 4 <= STAGES * STAGE, "merge buffer");
};

struct Args {
  const bf16* q;
  const bf16* kpool;
  const bf16* vpool;
  const bf16* chunk_k;
  const bf16* chunk_v;
  const int* tables;
  const int* pos;
  const float* slopes;
  float* ws_acc;
  float* ws_ml;
  int* counters;
  bf16* out;
  int B, C, H, KVH, G, R, RG, NB, bs, lbs, MB, layer, window, sms, maxc;  // bs = 1 << lbs
  float scale, softcap;
};

// A row group's live pool slots [lo, hi), its tiles from `base` (lo rounded
// down to TK), the least and greatest live position of its rows (pmax < 0:
// no live row) and the pool's end for its rows (cs with a chunk)
struct Unit {
  int lo, hi, base, tiles, pmin, pmax, pool_end;
};

// One work item (see the header); valid == 0 past the last item
struct Item {
  int valid, b, rg, kh, j, n, s0, s1, base, ntp, ck_lo, ck_hi, pmin, pmax, pool_end;
};

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o; o >>= 1) x = min(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ Unit unit_of(const Args& a, int b, int rg) {
  const int* pos = a.pos + static_cast<size_t>(b) * a.C;
  const int r1 = min(rg * ROWS + ROWS, a.R);
  int pmin = INT_MAX, pmax = -1;
  for (int c = rg * ROWS / a.G; c <= (r1 - 1) / a.G; ++c) {
    const int v = pos[c];
    if (v >= 0) {
      pmin = min(pmin, v);
      pmax = max(pmax, v);
    }
  }
  Unit u = {0, 0, 0, 0, pmin, pmax, 0};
  if (pmax < 0) return u;
  int end = a.MB * a.bs;   // the block table's last slot
  if (a.chunk_k != nullptr) {
    int cs = INT_MAX;      // the chunk's first position: later slots are stale
    for (int c = 0; c < a.C; ++c)
      if (pos[c] >= 0) cs = min(cs, pos[c]);
    end = min(end, cs);
  }
  u.pool_end = end;
  const int hi = a.chunk_k != nullptr ? end : min(end, pmax + 1);
  const int lo = a.window > 0 ? max(pmin - a.window + 1, 0) : 0;
  if (lo < hi) {
    u.lo = lo;
    u.hi = hi;
    u.base = lo / TK * TK;
    u.tiles = (hi - u.base + TK - 1) / TK;
  }
  return u;
}

// Item i of the plan, evaluated by one whole warp (every lane returns it):
// the lanes take the (sequence, row group) units 32 at a time
__device__ Item find_item(const Args& a, int i) {
  const int lane = threadIdx.x % 32, units = a.B * a.RG;
  // the first 32 units stay in registers: one pass over positions when
  // there are no more
  const Unit first = lane < units ? unit_of(a, lane / a.RG, lane % a.RG) : Unit{};
  long long total = 0;
  for (int u0 = 0; u0 < units; u0 += 32) {
    int t = u0 == 0 ? first.tiles
                    : u0 + lane < units ? unit_of(a, (u0 + lane) / a.RG, (u0 + lane) % a.RG).tiles
                                        : 0;
    for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(FULL, t, o);
    total += t;
  }
  const long long work = total * a.KVH;
  const int tpc = static_cast<int>(max(1LL, (work + a.sms - 1) / a.sms));
  Item it = {};
  for (int u0 = 0; u0 < units; u0 += 32) {
    const int u = u0 + lane;
    Unit un = {};
    int n = 0;
    if (u < units) {
      un = u0 == 0 ? first : unit_of(a, u / a.RG, u % a.RG);
      n = max(1, (un.tiles + tpc - 1) / tpc);
    }
    const int cnt = n * a.KVH;
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    const int sum = __shfl_sync(FULL, incl, 31);
    if (i < sum) {
      const int src = __ffs(__ballot_sync(FULL, i >= incl - cnt && i < incl)) - 1;
      const int k = i - (incl - cnt), j = k / a.KVH;
      const int t0 = j * un.tiles / max(n, 1), t1 = (j + 1) * un.tiles / max(n, 1);
      const int f[12] = {u / a.RG, u % a.RG, k % a.KVH, j, n,
                         max(un.base + t0 * TK, un.lo), min(un.base + t1 * TK, un.hi),
                         un.base + t0 * TK, t1 - t0, un.pmin, un.pmax, un.pool_end};
      int g[12];
#pragma unroll
      for (int x = 0; x < 12; ++x) g[x] = __shfl_sync(FULL, f[x], src);
      it = {1, g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[8], 0, 0, g[9], g[10], g[11]};
      // the chunk's keys its rows can see, folded in by the last chunk
      int klo = INT_MAX, khi = -1;
      if (a.chunk_k != nullptr && it.pmax >= 0 && it.j == it.n - 1) {
        const int floor_pos = a.window > 0 ? it.pmin - a.window + 1 : 0;
        const int* pos = a.pos + static_cast<size_t>(it.b) * a.C;
        for (int c = lane; c < a.C; c += 32) {
          const int v = pos[c];
          if (v >= 0 && v <= it.pmax && v >= floor_pos) {
            klo = min(klo, c);
            khi = max(khi, c);
          }
        }
        klo = warp_min(klo);
        khi = warp_max(khi);
      }
      it.ck_lo = khi >= 0 ? klo : 0;
      it.ck_hi = khi >= 0 ? khi + 1 : 0;
      return it;
    }
    i -= sum;
  }
  return it;
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two blocks an SM up to D 128 (registers capped at 204 a thread)
template <int D>
__global__ void __launch_bounds__(NTHREADS, D <= 128 ? 2 : 1) paged_split(const Args a) {
  using Cf = Cfg<D>;
  constexpr int LD = Cf::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cf::BARRIERS);
  uint64_t* empty = full + Cf::STAGES;
  Item* shared_item = reinterpret_cast<Item*>(smem + Cf::ITEM);
  int* last_flag = reinterpret_cast<int*>(smem + Cf::ITEM + 64);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    const Item found = find_item(a, blockIdx.x);
    if (lane == 0) *shared_item = found;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const Item it = *shared_item;
  if (!it.valid) return;   // the same for the whole block
  const int nct = (it.ck_hi - it.ck_lo + TK - 1) / TK;   // chunk tiles
  const int ntiles = it.ntp + nct;
  const int* pos = a.pos + static_cast<size_t>(it.b) * a.C;

  if (warp == CWARPS) {  // ------------------------------------------ producer
    if (ntiles == 0) return;
    StageRing<Cf::STAGES> ring;
    const size_t head = (static_cast<size_t>(a.layer) * a.KVH + it.kh) * a.NB;
    const int* bt = a.tables + static_cast<size_t>(it.b) * a.MB;
    constexpr int CH = D / 8;   // 16-byte pieces a row (even at every D)
    // two lanes a row, 32 contiguous bytes an instruction pair; a row's
    // address (through the block table) once
    const int sub = lane % 2;
    for (int t = 0; t < ntiles; ++t, ring.next()) {
      mbar_wait(&empty[ring.s], ring.phase ^ 1);
      const uint32_t kt = smem_addr(smem + ring.s * Cf::STAGE), vt = kt + Cf::TILE;
      const bool pool = t < it.ntp;
      for (int r = lane / 2; r < TK; r += 16) {
        size_t off = 0;
        bool live;
        if (pool) {
          const int slot = it.base + t * TK + r;
          live = slot >= it.s0 && slot < it.s1;
          if (live) off = ((head + bt[slot >> a.lbs]) * a.bs + (slot & (a.bs - 1))) * D;
        } else {
          const int c = it.ck_lo + (t - it.ntp) * TK + r;
          live = c < it.ck_hi && pos[c] >= 0;
          if (live) off = ((static_cast<size_t>(it.b) * a.C + c) * a.KVH + it.kh) * D;
        }
        const bf16* ksrc = (pool ? a.kpool : a.chunk_k) + off;
        const bf16* vsrc = (pool ? a.vpool : a.chunk_v) + off;
        const uint32_t dst = r * LD * 2;
#pragma unroll
        for (int ch = sub; ch < CH; ch += 2) {
          cp_async_16(kt + dst + ch * 16, ksrc + ch * 8, live ? 16u : 0u);
          cp_async_16(vt + dst + ch * 16, vsrc + ch * 8, live ? 16u : 0u);
        }
      }
      cp_async_mbar_arrive(&full[ring.s]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[ring.s]);
    }
    cp_async_wait_all();
    return;
  }

  // --------------------------------------------------------------- consumers
  const int g = lane / 4, t4 = lane % 4;
  const int rows = min(ROWS, a.R - it.rg * ROWS);
  // this thread's rows g and g + 8 of the item: position, head, slot limits
  int prow[2], kmax[2], kmin[2];
  float slope[2];
  const bf16* qrow[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = it.rg * ROWS + g + 8 * u;
    const bool in = g + 8 * u < rows;
    const int c = in ? r / a.G : 0, h = it.kh * a.G + (in ? r % a.G : 0);
    prow[u] = in ? pos[c] : -1;
    slope[u] = a.slopes != nullptr ? a.slopes[h] : 0.f;
    kmax[u] = min(prow[u], it.pool_end - 1);              // pool slots <= kmax
    kmin[u] = a.window > 0 ? prow[u] - a.window + 1 : 0;  // keys >= kmin
    qrow[u] = prow[u] >= 0 ? a.q + ((static_cast<size_t>(it.b) * a.C + c) * a.H + h) * D + 2 * t4
                           : nullptr;
  }
  uint32_t qa[D / 16][4];   // Q rows g and g + 8 as the A operand (dead rows 0)
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qa[ks][0] = qrow[0] ? ld_pair(qrow[0] + 16 * ks) : 0u;
    qa[ks][1] = qrow[1] ? ld_pair(qrow[1] + 16 * ks) : 0u;
    qa[ks][2] = qrow[0] ? ld_pair(qrow[0] + 16 * ks + 8) : 0u;
    qa[ks][3] = qrow[1] ? ld_pair(qrow[1] + 16 * ks + 8) : 0u;
  }
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // rows g, g + 8 (log2 units)
  const bool alibi = a.slopes != nullptr, capped = a.softcap != 0.f;

  // ldmatrix row addresses: lane i gives row i % 8 of matrix i / 8
  const int mi = lane / 8;
  const int k_row = 16 * warp + (mi / 2) * 8 + lane % 8, k_col = (mi % 2) * 8;   // K, non-trans
  const int v_row = 16 * warp + (mi % 2) * 8 + lane % 8, v_col = (mi / 2) * 8;   // V, trans

  StageRing<Cf::STAGES> ring;
  for (int t = 0; t < ntiles; ++t, ring.next()) {
    mbar_wait(&full[ring.s], ring.phase);
    const uint32_t kt = smem_addr(smem + ring.s * Cf::STAGE), vt = kt + Cf::TILE;
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + (k_row * LD + 16 * ks + k_col) * 2);
      mma_16816(sc[0], qa[ks], kb[0], kb[1]);
      mma_16816(sc[1], qa[ks], kb[2], kb[3]);
    }
    // logits in log2 units, invisible keys -inf: a pool slot by the row's
    // limits, a chunk key by its position
    const bool pool = t < it.ntp;
#pragma unroll
    for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e / 2, kk = 16 * warp + 8 * n8 + 2 * t4 + (e & 1);
        int kp;
        bool vis;
        if (pool) {
          kp = it.base + t * TK + kk;
          vis = kp >= it.s0 && kp < it.s1 && kp <= kmax[u] && kp >= kmin[u];
        } else {
          const int c = it.ck_lo + (t - it.ntp) * TK + kk;
          kp = c < it.ck_hi ? pos[c] : -1;
          vis = kp >= 0 && kp <= prow[u] && kp >= kmin[u];
        }
        float x = sc[n8][e] * a.scale;
        if (alibi) x = fmaf(slope[u], static_cast<float>(kp - prow[u]), x);
        if (capped) x = softcap_tanh(x, a.softcap);
        sc[n8][e] = vis ? x * LOG2E : -INFINITY;
      }
    float x0 = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
    float x1 = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
    x0 = fmaxf(x0, __shfl_xor_sync(FULL, x0, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(FULL, x1, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(FULL, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(FULL, x1, 2));
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
      ldmatrix_x4_trans(vb, vt + (v_row * LD + 16 * dp + v_col) * 2);
      mma_16816(o[2 * dp], pa, vb[0], vb[1]);
      mma_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[ring.s]);
  }
  // l over the quad of threads that share a row
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 2);

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
  const size_t part = ((static_cast<size_t>(it.b) * a.RG + it.rg) * a.KVH + it.kh) * a.maxc;
  // out rows of the item: row i is query row rg * 16 + i
  auto out_at = [&](int i) {
    const int r = it.rg * ROWS + i;
    return a.out + ((static_cast<size_t>(it.b) * a.C + r / a.G) * a.H + it.kh * a.G + r % a.G) * D;
  };
  for (int i = tid; i < rows * D; i += CWARPS * 32) {
    const int r = i / D, d = i % D;
    float mm = wm[r];
#pragma unroll
    for (int w = 1; w < CWARPS; ++w) mm = fmaxf(mm, wm[w * ROWS + r]);
    const float um = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) {
      const float f = exp2_approx(wm[w * ROWS + r] - um);   // 0 for a warp with no key
      ll += wl[w * ROWS + r] * f;
      aa += wacc[(w * ROWS + r) * D + d] * f;
    }
    if (it.n == 1) {
      out_at(r)[d] = __float2bfloat16_rn(ll > 0.f ? aa / ll : 0.f);
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

  // the last of the row group's chunks to finish merges them all, in order
  __threadfence();
  named_sync<CWARPS * 32>(MERGE_BAR);
  int* counter = a.counters + (static_cast<size_t>(it.b) * a.RG + it.rg) * a.KVH + it.kh;
  if (tid == 0) *last_flag = atomicAdd(counter, 1) == it.n - 1;
  named_sync<CWARPS * 32>(MERGE_BAR);
  if (!*last_flag) return;
  __threadfence();
  for (int i = tid; i < rows * D; i += CWARPS * 32) {
    const int r = i / D, d = i % D;
    float mm = -INFINITY;
    for (int c = 0; c < it.n; ++c) mm = fmaxf(mm, __ldcg(a.ws_ml + ((part + c) * ROWS + r) * 2));
    const float um = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, aa = 0.f;
    for (int c = 0; c < it.n; ++c) {
      const size_t row = (part + c) * ROWS + r;
      const float f = exp2_approx(__ldcg(a.ws_ml + row * 2) - um);
      ll += __ldcg(a.ws_ml + row * 2 + 1) * f;
      aa += __ldcg(a.ws_acc + row * D + d) * f;
    }
    out_at(r)[d] = __float2bfloat16_rn(ll > 0.f ? aa / ll : 0.f);
  }
  if (tid == 0) *counter = 0;
}

template <int D>
cudaError_t launch_split(const Args& a, int grid, cudaStream_t stream) {
  // the attribute belongs to the current device: set it on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      paged_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (e != cudaSuccess) return e;
  paged_split<D><<<grid, NTHREADS, Cfg<D>::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------ route wgmma

template <int D>
__global__ void __launch_bounds__(hopper::WG_THREADS, 1)
    paged_fwd_wgmma(const flash_fwd::Params p, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv) {
  flash_fwd::forward<D, flash_fwd::PAGED>(p, nullptr, &tk, &tv);
}

// The tensor map of a (L, KVH, NB, bs, D) pool: boxes of `rows` slots of
// one page by 64 columns into the 128-byte-swizzled layout
inline cudaError_t pool_map(CUtensorMap* map, const void* base, int D, int bs, int NB, int KVH,
                            int L, int rows) {
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(bs),
                              static_cast<cuuint64_t>(NB), static_cast<cuuint64_t>(KVH),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[4] = {row, row * bs, row * bs * NB, row * bs * NB * KVH};
  const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(rows), 1, 1, 1};
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 5, dims, strides, box);
}

template <int D>
cudaError_t launch_wgmma(const Args& a, int L, cudaStream_t stream) {
  using SM = flash_fwd::Layout<D, flash_fwd::PAGED>;
  flash_fwd::Params p = {};
  p.q = a.q;
  p.k = a.kpool;
  p.v = a.vpool;
  p.slopes = a.slopes;
  p.out = a.out;
  p.tables = a.tables;
  p.positions = a.pos;
  p.chunk_k = a.chunk_k;
  p.chunk_v = a.chunk_v;
  p.Sq = a.R;          // an item's rows run over the C * G rows of one kv head
  p.H = a.KVH;
  p.KVH = a.KVH;
  p.B = a.B;
  p.C = a.C;
  p.G = a.G;
  p.NB = a.NB;
  p.bs = a.bs;
  p.MB = a.MB;
  p.layer = a.layer;
  p.window = a.window;
  p.scale = a.scale;
  p.softcap = a.softcap;
  CUtensorMap tk, tv;
  const int rows = a.bs < SM::BK ? a.bs : SM::BK;
  cudaError_t e;
  if ((e = pool_map(&tk, a.kpool, D, a.bs, a.NB, a.KVH, L, rows)) != cudaSuccess ||
      (e = pool_map(&tv, a.vpool, D, a.bs, a.NB, a.KVH, L, rows)) != cudaSuccess)
    return e;
  return flash_fwd::launch_items<D, flash_fwd::PAGED>(paged_fwd_wgmma<D>, p, stream, tk, tv);
}

enum Route { SPLIT = 0, WGMMA = 1 };

}  // namespace

// route 0 (split): D in {64, 80, 96, 128, 256}; ws_acc (B, RG, KVH, maxc, 16,
// D), ws_ml (B, RG, KVH, maxc, 16, 2) f32 and counters (B, RG, KVH) int32,
// zero and left zero, with RG = ceil(C * H / KVH / 16); sms the SMs the plan
// spreads over, maxc >= the most chunks it gives a row group and grid >= its
// items (ops/paged_attention.py max_chunks, grid_size). route 1 (wgmma): D in
// {64, 128, 256}; the scratch is unused. bf16 q/pools/chunk/out, bs a power
// of two >= 16, 16-byte aligned tensors. Returns the cudaError_t of the
// launch.
extern "C" int ds_paged_attention(const void* q, const void* kpool, const void* vpool,
                                  const void* block_tables, const void* positions,
                                  const void* chunk_k, const void* chunk_v,
                                  const void* slopes, void* out, void* ws_acc, void* ws_ml,
                                  void* counters, int B, int C, int H, int KVH, int D, int L,
                                  int NB, int bs, int MB, int layer, int window, float scale,
                                  float softcap, int route, int sms, int maxc, int grid,
                                  void* stream) {
  if (B <= 0 || C <= 0 || KVH <= 0 || H % KVH != 0 || bs < 16 || (bs & (bs - 1)) || MB <= 0 ||
      L <= 0 || NB <= 0 || sms <= 0)
    return cudaErrorInvalidValue;
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.kpool = static_cast<const bf16*>(kpool);
  a.vpool = static_cast<const bf16*>(vpool);
  a.chunk_k = static_cast<const bf16*>(chunk_k);
  a.chunk_v = static_cast<const bf16*>(chunk_v);
  a.tables = static_cast<const int*>(block_tables);
  a.pos = static_cast<const int*>(positions);
  a.slopes = static_cast<const float*>(slopes);
  a.ws_acc = static_cast<float*>(ws_acc);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.counters = static_cast<int*>(counters);
  a.out = static_cast<bf16*>(out);
  a.B = B;
  a.C = C;
  a.H = H;
  a.KVH = KVH;
  a.G = H / KVH;
  a.R = C * a.G;
  a.RG = (a.R + ROWS - 1) / ROWS;
  a.NB = NB;
  a.bs = bs;
  a.lbs = __builtin_ctz(static_cast<unsigned>(bs));
  a.MB = MB;
  a.layer = layer;
  a.window = window;
  a.sms = sms;
  a.maxc = maxc;
  a.scale = scale;
  a.softcap = softcap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == WGMMA) {
    switch (D) {
      case 64: return launch_wgmma<64>(a, L, st);
      case 128: return launch_wgmma<128>(a, L, st);
      case 256: return launch_wgmma<256>(a, L, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route != SPLIT || maxc <= 0 || grid <= 0) return cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch_split<64>(a, grid, st);
    case 80: return launch_split<80>(a, grid, st);
    case 96: return launch_split<96>(a, grid, st);
    case 128: return launch_split<128>(a, grid, st);
    case 256: return launch_split<256>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

// info = {route's kernel present (1), dynamic shared memory a block, threads a
// block} of route 0 (split) or 1 (wgmma) at head dim D
extern "C" int ds_paged_attention_kernel_info(int route, int D, int* info) {
  info[0] = 1;
  if (route == SPLIT) {
    info[2] = NTHREADS;
    switch (D) {
      case 64: info[1] = Cfg<64>::SMEM; return 0;
      case 80: info[1] = Cfg<80>::SMEM; return 0;
      case 96: info[1] = Cfg<96>::SMEM; return 0;
      case 128: info[1] = Cfg<128>::SMEM; return 0;
      case 256: info[1] = Cfg<256>::SMEM; return 0;
      default: return cudaErrorInvalidValue;
    }
  }
  if (route != WGMMA) return cudaErrorInvalidValue;
  info[2] = hopper::WG_THREADS;
  switch (D) {
    case 64: info[1] = static_cast<int>(flash_fwd::Layout<64, flash_fwd::PAGED>::bytes); return 0;
    case 128: info[1] = static_cast<int>(flash_fwd::Layout<128, flash_fwd::PAGED>::bytes); return 0;
    case 256: info[1] = static_cast<int>(flash_fwd::Layout<256, flash_fwd::PAGED>::bytes); return 0;
    default: return cudaErrorInvalidValue;
  }
}
