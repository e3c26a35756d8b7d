// Per-group symmetric int8 / int4 quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/quantizer.py
// (_quant_kernel, launched by quantize_int8 with qmax 127 and by
// quantize_int4 with qmax 7), and the nibble packing XLA runs after the
// int4 call. For each group of `gs` consecutive elements:
//   scale = max(absmax, 1e-10) * fl32(1 / qmax)   (f32)
//   q     = clip(round_half_even(x / scale), -qmax, qmax)
// with x read as f32 and an IEEE f32 division x / scale (__fdiv_rn: no
// reciprocal multiply), so q and scale are byte-identical to the JAX
// function's. The scale is a product with the f32 reciprocal of qmax
// because XLA rewrites the kernel's division by the constant qmax so (the
// IEEE quotient differs in the last bit of some scales).
// int4 packs element 2i in the low nibble and 2i + 1 in the high nibble of
// byte i of its group; the packing is fused here, where JAX writes the int8
// codes and packs them in a second pass.
//
// What bounds it on this card: bytes. Each element is read once (2 bytes in
// bf16) and written once (1 byte, or half a byte for int4) for a handful of
// flops. The design gives each group to one warp: a first sweep takes the
// absmax with 16-byte loads (8 bf16 or 4 f32 a lane), a warp reduction
// gives the scale, and a second sweep (the group's lines are then in L1)
// writes the codes. Offsets are 64-bit: a stacked llama3-8b leaf holds 1.9e9
// elements. The last group may be short (n not a multiple of gs): its
// missing elements count as 0, as the zero padding of the JAX
// QuantizedParameter does, without a padded copy of the input.
//
// Layout: x (n,) of the input dtype; q (G * gs,) int8 or (G * gs / 2,) int8
// packed; scale (G,) f32; G = ceil(n / gs).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ int quant(float x, float scale, float qmax) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<int>(fminf(fmaxf(r, -qmax), qmax));
}

// VEC elements per 16-byte load
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T, int BITS>
__global__ void __launch_bounds__(WARPS * 32)
    quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                 long long n, int gs, long long groups, int vec_ok) {
  constexpr float QMAX = BITS == 8 ? 127.f : 7.f;
  constexpr int VN = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long long warps_total = static_cast<long long>(gridDim.x) * WARPS;
  for (long long gi = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       gi < groups; gi += warps_total) {
    const long long base = gi * gs;
    const long long avail = n - base;
    const int cnt = avail < gs ? static_cast<int>(avail) : gs;   // live elements
    const T* xg = x + base;
    const bool vec = vec_ok && cnt == gs;                       // full, aligned group
    float amax = 0.f;
    if (vec) {
      for (int c = lane; c < gs / VN; c += 32) {
        const uint4 raw = reinterpret_cast<const uint4*>(xg)[c];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < VN; ++i) amax = fmaxf(amax, fabsf(to_f32(e[i])));
      }
    } else {
      for (int i = lane; i < cnt; i += 32) amax = fmaxf(amax, fabsf(to_f32(xg[i])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = __fmul_rn(fmaxf(amax, 1e-10f), 1.f / QMAX);
    if (lane == 0) scale[gi] = s;

    if constexpr (BITS == 8) {
      int8_t* qg = q + base;
      if (vec) {
        for (int c = lane; c < gs / VN; c += 32) {
          const uint4 raw = reinterpret_cast<const uint4*>(xg)[c];
          const T* e = reinterpret_cast<const T*>(&raw);
          int8_t out[VN];
#pragma unroll
          for (int i = 0; i < VN; ++i) out[i] = static_cast<int8_t>(quant(to_f32(e[i]), s, QMAX));
          if constexpr (VN == 8) {
            reinterpret_cast<uint2*>(qg)[c] = *reinterpret_cast<const uint2*>(out);
          } else {
            reinterpret_cast<uint32_t*>(qg)[c] = *reinterpret_cast<const uint32_t*>(out);
          }
        }
      } else {
        for (int i = lane; i < gs; i += 32)
          qg[i] = static_cast<int8_t>(i < cnt ? quant(to_f32(xg[i]), s, QMAX) : 0);
      }
    } else {
      int8_t* qg = q + base / 2;
      if (vec) {
        for (int c = lane; c < gs / VN; c += 32) {
          const uint4 raw = reinterpret_cast<const uint4*>(xg)[c];
          const T* e = reinterpret_cast<const T*>(&raw);
          uint8_t out[VN / 2];
#pragma unroll
          for (int i = 0; i < VN / 2; ++i) {
            const int lo = quant(to_f32(e[2 * i]), s, QMAX) & 0xF;
            const int hi = quant(to_f32(e[2 * i + 1]), s, QMAX) & 0xF;
            out[i] = static_cast<uint8_t>(lo | (hi << 4));
          }
          if constexpr (VN == 8) {
            reinterpret_cast<uint32_t*>(qg)[c] = *reinterpret_cast<const uint32_t*>(out);
          } else {
            reinterpret_cast<uint16_t*>(qg)[c] = *reinterpret_cast<const uint16_t*>(out);
          }
        }
      } else {
        for (int i = lane; i < gs / 2; i += 32) {
          const int lo = 2 * i < cnt ? quant(to_f32(xg[2 * i]), s, QMAX) & 0xF : 0;
          const int hi = 2 * i + 1 < cnt ? quant(to_f32(xg[2 * i + 1]), s, QMAX) & 0xF : 0;
          qg[i] = static_cast<int8_t>(lo | (hi << 4));
        }
      }
    }
  }
}

template <typename T, int BITS>
cudaError_t launch(const void* x, void* q, void* scale, long long n, int gs, long long groups,
                   cudaStream_t stream) {
  const auto aligned = [](const void* p, int a) { return reinterpret_cast<uintptr_t>(p) % a == 0; };
  constexpr int VN = Vec<T>::N;
  // 16-byte input loads and VN (or VN/2) byte output stores stay aligned for
  // every group when the group holds whole vectors
  const int vec_ok = gs % VN == 0 && aligned(x, 16) && aligned(q, BITS == 8 ? VN : VN / 2);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long want = (groups + WARPS - 1) / WARPS;
  const int blocks = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  quant_kernel<T, BITS><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), n, gs,
      groups, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// x: n elements of dtype 0 = f32, 1 = bf16, 2 = f16; gs: group size (even
// for bits 4); q: int8 codes (G * gs bytes) for bits 8, packed nibbles
// (G * gs / 2 bytes) for bits 4; scale: G f32, G = ceil(n / gs).
// Returns the cudaError_t of the launch.
extern "C" int ds_quantize(const void* x, void* q, void* scale, long long n, int gs, int bits,
                           int dtype, void* stream) {
  if (n <= 0 || gs <= 0 || (bits != 8 && bits != 4) || (bits == 4 && gs % 2))
    return cudaErrorInvalidValue;
  const long long groups = (n + gs - 1) / gs;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (bits == 4)) {
    case 0: return launch<float, 8>(x, q, scale, n, gs, groups, st);
    case 1: return launch<float, 4>(x, q, scale, n, gs, groups, st);
    case 2: return launch<__nv_bfloat16, 8>(x, q, scale, n, gs, groups, st);
    case 3: return launch<__nv_bfloat16, 4>(x, q, scale, n, gs, groups, st);
    case 4: return launch<__half, 8>(x, q, scale, n, gs, groups, st);
    case 5: return launch<__half, 4>(x, q, scale, n, gs, groups, st);
    default: return cudaErrorInvalidValue;
  }
}
