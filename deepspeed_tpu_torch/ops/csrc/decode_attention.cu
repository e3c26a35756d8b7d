// Fused single-token decode attention over a contiguous KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// (_decode_kernel, launched by fused_decode_attention). Semantics, for
// sequence b and query head h = kh * G + g (G = H / KVH heads per kv head):
//   s_j = (q . k_j) * scale        for cache slots j < cache_len[b]
//   p_j = exp(s_j - m),  l = sum_j p_j,  acc = sum_j bf16(p_j) * v_j
//   out = acc / l, and 0 for a sequence with cache_len == 0
// The scale multiplies the f32 dot (it is not folded into q), and p is
// rounded to the cache dtype before the P.V product while l sums the f32 p,
// as the TPU kernel does. Slots at or past cache_len are never read.
//
// What bounds it on this card: bytes. Each live K and V row is read once
// (2 * D bytes per slot and kv head in bf16) for ~4 flops per byte, far below
// the ~295 flops/byte where the tensor cores would matter; with G = 4 query
// rows per kv head there is too little work per row for wmma tiles. The
// design reads the cache where it lies, (B, S_max, KVH, D), one contiguous
// 2 * D-byte row per slot (the TPU wrapper copies the whole cache to
// (B, KVH, S_max, D) on every call). A batch of 4 sequences has only
// 4 * KVH = 32 (sequence, kv head) pairs for 132 SMs, so the cache axis is
// split into chunks of `chunk` slots (flash-decoding): pass 1 runs one block
// per (chunk, kv head, sequence), each of its four warps walks every fourth
// group of U slots with an online softmax in registers (lane i owns D / 32
// contiguous elements of every row), the warps merge in shared memory and
// the block writes its unnormalised (m, l, acc) per query row; pass 2 merges
// the live chunks of each (sequence, head) and divides by l. Chunks that
// start at or past cache_len exit at once and are never read by pass 2.
//
// Layout: q/out (B, H, D) bf16; k/v (B, S, KVH, D) bf16; lens (B,) int32;
// ws_acc (B, H, n_split, D) f32 and ws_ml (B, H, n_split, 2) f32 scratch from
// the caller, n_split = ceil(S / chunk). Query rows of one kv head are taken
// GMAX at a time (grid.y = KVH * ceil(G / GMAX)), so any G works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int GMAX = 8;   // query rows of one kv head per block

// DPL bf16 values from global memory into f32 registers, with the widest
// loads the lane's alignment allows (DPL * 2 bytes at a multiple of them).
template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* src, float (&dst)[DPL]) {
  if constexpr (DPL % 8 == 0) {
#pragma unroll
    for (int c = 0; c < DPL / 8; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        dst[c * 8 + 2 * i] = f.x;
        dst[c * 8 + 2 * i + 1] = f.y;
      }
    }
  } else if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int c = 0; c < DPL / 4; ++c) {
      const uint2 raw = reinterpret_cast<const uint2*>(src)[c];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        dst[c * 4 + 2 * i] = f.x;
        dst[c * 4 + 2 * i + 1] = f.y;
      }
    }
  } else {
    static_assert(DPL % 2 == 0, "head dim must be a multiple of 64");
#pragma unroll
    for (int c = 0; c < DPL / 2; ++c) {
      const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(src)[c]);
      dst[2 * c] = f.x;
      dst[2 * c + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* lens;
  float* ws_acc;
  float* ws_ml;
  __nv_bfloat16* out;
  int B, H, KVH, S, G, n_rg, chunk, n_split;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) decode_partial_kernel(Args a) {
  constexpr int DPL = D / 32;
  constexpr int U = D >= 192 ? 2 : 4;   // slots a warp loads per step
  const int split = blockIdx.x;
  const int kh = blockIdx.y / a.n_rg;
  const int g0 = (blockIdx.y % a.n_rg) * GMAX;
  const int b = blockIdx.z;
  const int len = min(max(a.lens[b], 0), a.S);
  const int start = split * a.chunk;
  if (start >= len) return;
  const int end = min(start + a.chunk, len);
  const int rows = min(GMAX, a.G - g0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float qv[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < rows) {
      const size_t h = static_cast<size_t>(kh) * a.G + g0 + g;
      load_row<DPL>(a.q + (static_cast<size_t>(b) * a.H + h) * D + lane * DPL, qv[g]);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) qv[g][i] = 0.f;
    }
  }
  float m[GMAX], l[GMAX], acc[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(a.KVH) * D;   // one slot
  const size_t base = (static_cast<size_t>(b) * a.S * a.KVH + kh) * D + lane * DPL;
  for (int s0 = start + warp * U; s0 < end; s0 += NWARPS * U) {
    float kr[U][DPL], vr[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < end) {
        const size_t off = base + static_cast<size_t>(s0 + u) * row_stride;
        load_row<DPL>(a.k + off, kr[u]);
        load_row<DPL>(a.v + off, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= rows) continue;
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part = fmaf(qv[g][i], kr[u][i], part);
        sc[u] = s0 + u < end ? warp_sum(part) * a.scale : -INFINITY;
      }
      float mx = sc[0];   // slot s0 < end is always live
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[u]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(sc[u] - m_new);
        psum += p;
        const float pb = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pb, vr[u][i], acc[g][i]);
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
    }
  }

  // merge the four warps' (m, l, acc) in shared memory
  __shared__ float sm_m[NWARPS][GMAX], sm_l[NWARPS][GMAX];
  __shared__ float sm_acc[NWARPS][GMAX][D];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][g][lane * DPL + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * D; idx += NTHREADS) {
    const int g = idx / D, d = idx % D;
    float mm = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(sm_m[w][g] - mm);   // 0 for a warp with no slot
      ll += sm_l[w][g] * f;
      aa += sm_acc[w][g][d] * f;
    }
    const size_t h = static_cast<size_t>(kh) * a.G + g0 + g;
    const size_t row = (static_cast<size_t>(b) * a.H + h) * a.n_split + split;
    a.ws_acc[row * D + d] = aa;
    if (d == 0) {
      a.ws_ml[row * 2] = mm;
      a.ws_ml[row * 2 + 1] = ll;
    }
  }
}

// Pass 2: one block of D threads per (head, sequence) merges the live chunks.
__global__ void decode_combine_kernel(Args a, int D) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(max(a.lens[b], 0), a.S);
  const int live = (len + a.chunk - 1) / a.chunk;
  const size_t row0 = (static_cast<size_t>(b) * a.H + h) * a.n_split;
  float mm = -INFINITY;
  for (int s = 0; s < live; ++s) mm = fmaxf(mm, a.ws_ml[(row0 + s) * 2]);
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < live; ++s) {
    const float f = expf(a.ws_ml[(row0 + s) * 2] - mm);
    ll += a.ws_ml[(row0 + s) * 2 + 1] * f;
    aa += a.ws_acc[(row0 + s) * D + d] * f;
  }
  const float l_safe = ll == 0.f ? 1.f : ll;
  a.out[(static_cast<size_t>(b) * a.H + h) * D + d] = __float2bfloat16_rn(aa / l_safe);
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid1(a.n_split, a.KVH * a.n_rg, a.B);
  decode_partial_kernel<D><<<grid1, NTHREADS, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<<<dim3(a.H, a.B), D, 0, stream>>>(a, D);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, D), k/v (B, S, KVH, D) bf16, lens (B,) int32, scratch ws_acc
// (B, H, n_split, D) and ws_ml (B, H, n_split, 2) f32 with
// n_split = ceil(S / chunk), out (B, H, D) bf16. D in {64, 128, 192, 256}.
// Returns the cudaError_t of the launches.
extern "C" int ds_decode_attention(const void* q, const void* k, const void* v, const void* lens,
                                   void* ws_acc, void* ws_ml, void* out, int B, int H, int KVH,
                                   int S, int D, int chunk, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.lens = static_cast<const int*>(lens);
  a.ws_acc = static_cast<float*>(ws_acc);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.G = H / KVH;
  a.n_rg = (a.G + GMAX - 1) / GMAX;
  a.chunk = chunk;
  a.n_split = (S + chunk - 1) / chunk;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(a, st);
    case 128: return launch<128>(a, st);
    case 192: return launch<192>(a, st);
    case 256: return launch<256>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
