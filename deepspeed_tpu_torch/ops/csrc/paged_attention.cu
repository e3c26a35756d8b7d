// Paged ragged attention for Hopper (sm_90a): decode (C == 1) and chunked
// prefill (C > 1) over in-place KV pages, in one kernel.
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
//   A row with no visible key (a pad row, pos == -1) outputs 0.
//
// What bounds it on this card: bytes. Every live K/V page of the sequence is
// read once per row tile, and decode does ~2 flops per byte read, far below
// the ~295 flops/byte where the H100's bf16 tensor cores become the limit.
// The design reads only live pages: the block walks logical slots
// [lo, min(cs, MB * bs)), where lo is the sliding-window floor of the
// chunk's earliest query, and never touches the dead tail of the block
// table. Pages are loaded with 16-byte vector loads. Scores and P.V run on
// the tensor cores (wmma, bf16 in, f32 accumulate) so prefill tiles
// (up to 64 query rows against 64 keys) are not compute-bound in SIMT code.
// Later work: cp.async/TMA double buffering of the page loads and a split
// over pages for long contexts at small batch (flash-decoding).
//
// Layout: q/out (B, C, H, D); kpool/vpool (L, KVH, NB, bs, D); block_tables
// (B, MB) int32; positions (B, C) int32; chunk_k/chunk_v (B, C, KVH, D) or
// null; slopes (H,) f32 or null. One thread block per (row tile, kv head,
// sequence); it reads its own block-table row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int TK = 64;          // keys per tile
constexpr int NTHREADS = 128;   // four warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int NO_POS = 1 << 30; // "no valid position" sentinel

struct Params {
  const void* q;
  const void* kpool;
  const void* vpool;
  const int* block_tables;
  const int* positions;
  const void* chunk_k;
  const void* chunk_v;
  const float* slopes;
  void* out;
  int B, C, H, KVH, NB, bs, MB, layer, window;
  float scale, softcap;
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory plan (element strides padded so wmma fragment pointers stay
// 32-byte aligned and rows do not fall on one bank).
template <typename T, int D, int TR>
struct Smem {
  static constexpr int LDT = D + 8;    // Q, K, V rows (T)
  static constexpr int LDS = TK + 4;   // score rows (float)
  static constexpr int LDP = TK + 8;   // probability rows (T)
  static constexpr int LDO = D + 4;    // output accumulator rows (float)
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(T) * TR * LDT;
  static constexpr size_t v = k + sizeof(T) * TK * LDT;
  static constexpr size_t s = v + sizeof(T) * TK * LDT;
  static constexpr size_t p = s + sizeof(float) * TR * LDS;
  static constexpr size_t o = p + sizeof(T) * TR * LDP;
  static constexpr size_t rows = o + sizeof(float) * TR * LDO;   // m, l, alpha, slope, pos
  static constexpr size_t kpos = rows + sizeof(float) * 5 * TR;
  static constexpr size_t red = kpos + sizeof(int) * TK;
  static constexpr size_t bytes = red + sizeof(int) * 2;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One key tile (TK keys already in Ks/Vs, their positions in kpos_s):
// S = Q K^T, online-softmax update of (m, l), O = O * alpha + P V.
template <typename T, int D, int TR>
__device__ __forceinline__ void attend_tile(const Params& p, unsigned char* smem) {
  using S = Smem<T, D, TR>;
  T* Qs = reinterpret_cast<T*>(smem + S::q);
  T* Ks = reinterpret_cast<T*>(smem + S::k);
  T* Vs = reinterpret_cast<T*>(smem + S::v);
  float* Ss = reinterpret_cast<float*>(smem + S::s);
  T* Ps = reinterpret_cast<T*>(smem + S::p);
  float* Os = reinterpret_cast<float*>(smem + S::o);
  float* row_m = reinterpret_cast<float*>(smem + S::rows);
  float* row_l = row_m + TR;
  float* row_alpha = row_l + TR;
  float* row_slope = row_alpha + TR;
  const int* row_pos = reinterpret_cast<const int*>(row_slope + TR);
  const int* kpos_s = reinterpret_cast<const int*>(smem + S::kpos);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int MT = TR / 16, NT = TK / 16, DT = D / 16;

  for (int tile = warp; tile < MT * NT; tile += NWARPS) {
    const int mi = tile / NT, ni = tile % NT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bk;
      wmma::load_matrix_sync(a, Qs + mi * 16 * S::LDT + k0, S::LDT);
      wmma::load_matrix_sync(bk, Ks + ni * 16 * S::LDT + k0, S::LDT);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(Ss + mi * 16 * S::LDS + ni * 16, acc, S::LDS, wmma::mem_row_major);
  }
  __syncthreads();

  // one warp per row, two keys per lane
  for (int i = warp; i < TR; i += NWARPS) {
    const int pos = row_pos[i];
    const float slope = row_slope[i];
    float sc[TK / 32];
    bool vis[TK / 32];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TK / 32; ++j) {
      const int kk = lane + 32 * j;
      const int kp = kpos_s[kk];
      float x = Ss[i * S::LDS + kk] * p.scale;
      if (p.slopes != nullptr) x += slope * static_cast<float>(kp - pos);
      if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
      const bool v = kp >= 0 && kp <= pos && (p.window <= 0 || kp > pos - p.window);
      sc[j] = x;
      vis[j] = v;
      if (v) tmax = fmaxf(tmax, x);
    }
    tmax = warp_max(tmax);
    const float m_old = row_m[i];
    const float m_new = fmaxf(m_old, tmax);
    // nothing visible yet: keep the (zero) state as it is
    const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < TK / 32; ++j) {
      const float pj = vis[j] ? expf(sc[j] - m_new) : 0.f;
      Ps[i * S::LDP + lane + 32 * j] = from_f32<T>(pj);
      lsum += pj;
    }
    lsum = warp_sum(lsum);
    if (lane == 0) {
      row_m[i] = m_new;
      row_l[i] = row_l[i] * alpha + lsum;
      row_alpha[i] = alpha;
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < TR * D; e += NTHREADS) {
    const int r = e / D;
    Os[r * S::LDO + e % D] *= row_alpha[r];
  }
  __syncthreads();

  for (int tile = warp; tile < MT * DT; tile += NWARPS) {
    const int mi = tile / DT, di = tile % DT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, Os + mi * 16 * S::LDO + di * 16, S::LDO, wmma::mem_row_major);
#pragma unroll
    for (int k0 = 0; k0 < TK; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bv;
      wmma::load_matrix_sync(a, Ps + mi * 16 * S::LDP + k0, S::LDP);
      wmma::load_matrix_sync(bv, Vs + k0 * S::LDT + di * 16, S::LDT);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(Os + mi * 16 * S::LDO + di * 16, acc, S::LDO, wmma::mem_row_major);
  }
  __syncthreads();
}

template <typename T, int D, int TR>
__global__ void __launch_bounds__(NTHREADS) paged_attention_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = Smem<T, D, TR>;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int DV = D / VEC;
  T* Qs = reinterpret_cast<T*>(smem + S::q);
  T* Ks = reinterpret_cast<T*>(smem + S::k);
  T* Vs = reinterpret_cast<T*>(smem + S::v);
  float* Os = reinterpret_cast<float*>(smem + S::o);
  float* row_m = reinterpret_cast<float*>(smem + S::rows);
  float* row_l = row_m + TR;
  float* row_slope = row_l + 2 * TR;
  int* row_pos = reinterpret_cast<int*>(row_slope + TR);
  int* kpos_s = reinterpret_cast<int*>(smem + S::kpos);
  int* red = reinterpret_cast<int*>(smem + S::red);

  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int rows = p.C * G;
  const int r0 = blockIdx.x * TR;
  const int tid = threadIdx.x;
  const int* pos_b = p.positions + static_cast<size_t>(b) * p.C;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  if (tid == 0) {
    red[0] = INT_MAX;
    red[1] = -1;
  }
  __syncthreads();
  int lmin = INT_MAX, lmax = -1;
  for (int c = tid; c < p.C; c += NTHREADS) {
    const int v = pos_b[c];
    if (v >= 0) {
      lmin = min(lmin, v);
      lmax = max(lmax, v);
    }
  }
  for (int o = 16; o; o >>= 1) {
    lmin = min(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
    lmax = max(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
  }
  if (tid % 32 == 0) {
    atomicMin(&red[0], lmin);
    atomicMax(&red[1], lmax);
  }
  for (int i = tid; i < TR; i += NTHREADS) {
    const int r = r0 + i;
    int pos = -1;
    float slope = 0.f;
    if (r < rows) {
      pos = pos_b[r / G];
      if (p.slopes != nullptr) slope = p.slopes[kh * G + r % G];
    }
    row_pos[i] = pos;
    row_slope[i] = slope;
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }
  for (int e = tid; e < TR * D; e += NTHREADS) Os[(e / D) * S::LDO + e % D] = 0.f;
  for (int e = tid; e < TR * DV; e += NTHREADS) {
    const int i = e / DV, d = (e % DV) * VEC, r = r0 + i;
    uint4 val = zero;
    if (r < rows) {
      const T* src = static_cast<const T*>(p.q) +
                     ((static_cast<size_t>(b) * p.C + r / G) * p.H + kh * G + r % G) * D + d;
      val = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(Qs + i * S::LDT + d) = val;
  }
  __syncthreads();

  const bool has_chunk = p.chunk_k != nullptr;
  const int minpos = red[0] == INT_MAX ? NO_POS : red[0];
  // first stale pool slot: the chunk's earliest position (its KV rides
  // beside the pool), or one past the last query when the pool holds all
  const int cs = has_chunk ? (minpos == NO_POS ? 0 : minpos) : red[1] + 1;
  const int lo = p.window > 0 ? max(minpos - p.window + 1, 0) : 0;
  const int hi = min(cs, p.MB * p.bs);   // never read past the block table

  const size_t head_off =
      ((static_cast<size_t>(p.layer) * p.KVH + kh) * p.NB) * p.bs * D;
  const T* kbase = static_cast<const T*>(p.kpool) + head_off;
  const T* vbase = static_cast<const T*>(p.vpool) + head_off;
  const int* bt = p.block_tables + static_cast<size_t>(b) * p.MB;

  for (int t0 = lo < hi ? (lo / TK) * TK : hi; t0 < hi; t0 += TK) {
    for (int e = tid; e < TK * DV; e += NTHREADS) {
      const int kk = e / DV, d = (e % DV) * VEC, slot = t0 + kk;
      uint4 kv = zero, vv = zero;
      if (slot >= lo && slot < hi) {
        const size_t off =
            (static_cast<size_t>(bt[slot / p.bs]) * p.bs + slot % p.bs) * D + d;
        kv = *reinterpret_cast<const uint4*>(kbase + off);
        vv = *reinterpret_cast<const uint4*>(vbase + off);
      }
      *reinterpret_cast<uint4*>(Ks + kk * S::LDT + d) = kv;
      *reinterpret_cast<uint4*>(Vs + kk * S::LDT + d) = vv;
    }
    for (int kk = tid; kk < TK; kk += NTHREADS) {
      const int slot = t0 + kk;
      kpos_s[kk] = (slot >= lo && slot < hi) ? slot : -1;
    }
    __syncthreads();
    attend_tile<T, D, TR>(p, smem);
  }

  if (has_chunk) {
    for (int t0 = 0; t0 < p.C; t0 += TK) {
      for (int e = tid; e < TK * DV; e += NTHREADS) {
        const int kk = e / DV, d = (e % DV) * VEC, c = t0 + kk;
        uint4 kv = zero, vv = zero;
        if (c < p.C && pos_b[c] >= 0) {
          const size_t off = ((static_cast<size_t>(b) * p.C + c) * p.KVH + kh) * D + d;
          kv = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.chunk_k) + off);
          vv = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.chunk_v) + off);
        }
        *reinterpret_cast<uint4*>(Ks + kk * S::LDT + d) = kv;
        *reinterpret_cast<uint4*>(Vs + kk * S::LDT + d) = vv;
      }
      for (int kk = tid; kk < TK; kk += NTHREADS) {
        const int c = t0 + kk;
        kpos_s[kk] = c < p.C ? pos_b[c] : -1;
      }
      __syncthreads();
      attend_tile<T, D, TR>(p, smem);
    }
  }

  T* out = static_cast<T*>(p.out);
  for (int e = tid; e < TR * D; e += NTHREADS) {
    const int i = e / D, d = e % D, r = r0 + i;
    if (r >= rows) continue;
    const float l = row_l[i];
    const float o = l > 0.f ? Os[i * S::LDO + d] / l : 0.f;
    out[((static_cast<size_t>(b) * p.C + r / G) * p.H + kh * G + r % G) * D + d] = from_f32<T>(o);
  }
}

template <typename T, int D, int TR>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D, TR>::bytes;
  // the attribute belongs to the current device: set it on every launch so a
  // second card gets it too (a host-side call, cheap next to the launch)
  const cudaError_t e = cudaFuncSetAttribute(
      paged_attention_kernel<T, D, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = p.C * (p.H / p.KVH);
  const dim3 grid((rows + TR - 1) / TR, p.KVH, p.B);
  paged_attention_kernel<T, D, TR><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  // decode rows (C * G <= 16) take a 16-row tile; prefill chunks 64-row tiles
  if (p.C * (p.H / p.KVH) <= 16) return launch<T, D, 16>(p, stream);
  return launch<T, D, 64>(p, stream);
}

template <typename T>
cudaError_t launch_dims(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_rows<T, 64>(p, stream);
    case 128: return launch_rows<T, 128>(p, stream);
    case 256: return launch_rows<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bfloat16 q/pools/chunk/out. Returns the cudaError_t of the launch.
extern "C" int ds_paged_attention(const void* q, const void* kpool, const void* vpool,
                                  const void* block_tables, const void* positions,
                                  const void* chunk_k, const void* chunk_v,
                                  const void* slopes, void* out, int B, int C, int H,
                                  int KVH, int D, int NB, int bs, int MB, int layer,
                                  int window, float scale, float softcap, void* stream) {
  if (B <= 0 || C <= 0 || KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kpool = kpool;
  p.vpool = vpool;
  p.block_tables = static_cast<const int*>(block_tables);
  p.positions = static_cast<const int*>(positions);
  p.chunk_k = chunk_k;
  p.chunk_v = chunk_v;
  p.slopes = static_cast<const float*>(slopes);
  p.out = out;
  p.B = B;
  p.C = C;
  p.H = H;
  p.KVH = KVH;
  p.NB = NB;
  p.bs = bs;
  p.MB = MB;
  p.layer = layer;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  return launch_dims<__nv_bfloat16>(p, D, static_cast<cudaStream_t>(stream));
}
