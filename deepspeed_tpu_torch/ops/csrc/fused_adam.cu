// Fused Adam/AdamW step over one flat f32 buffer for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/fused_adam.py
// (_adam_kernel, launched by fused_adam_flat), and with it the one fused
// elementwise update XLA makes of FusedAdam._update_one
// (deepspeed_tpu/ops/optimizers.py) for AdamW with bias correction:
//   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
//   p = p - lr ((m / (1 - b1^step)) / (sqrt(v / (1 - b2^step)) + eps) + wd p)
// with every hyperparameter and the step in f32, as the TPU kernel reads
// them from its f32 hyper vector. p, m and v are updated in place.
//
// What bounds it on this card: bytes. Each element reads p, g, m, v and
// writes p, m, v (28 bytes) for ~15 flops. The design makes one pass: 16-byte
// vector loads and stores where the four buffers allow, a grid-stride loop
// sized to the card, the bias corrections computed once per thread.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

struct Hyper {
  float lr, b1, b2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, const Hyper& h) {
  m = h.b1 * m + (1.f - h.b1) * g;
  v = h.b2 * v + (1.f - h.b2) * g * g;
  const float update = (m / h.bc1) / (sqrtf(v / h.bc2) + h.eps) + h.wd * p;
  p = p - h.lr * update;
}

__global__ void adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                            float* __restrict__ m, float* __restrict__ v, size_t n, float lr,
                            float b1, float b2, float eps, float wd, float step, int vec4) {
  Hyper h{lr, b1, b2, eps, wd, 1.f - powf(b1, step), 1.f - powf(b2, step)};
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  size_t tail = 0;
  if (vec4) {
    const size_t n4 = n / 4;
    for (; i < n4; i += stride) {
      float4 pp = reinterpret_cast<float4*>(p)[i];
      const float4 gg = reinterpret_cast<const float4*>(g)[i];
      float4 mm = reinterpret_cast<float4*>(m)[i];
      float4 vv = reinterpret_cast<float4*>(v)[i];
      adam_one(pp.x, gg.x, mm.x, vv.x, h);
      adam_one(pp.y, gg.y, mm.y, vv.y, h);
      adam_one(pp.z, gg.z, mm.z, vv.z, h);
      adam_one(pp.w, gg.w, mm.w, vv.w, h);
      reinterpret_cast<float4*>(p)[i] = pp;
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
    }
    tail = n4 * 4;
    i = tail + static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  }
  for (; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(pp, g[i], mm, vv, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// f32 params/grads/exp_avg/exp_avg_sq of n elements, updated in place.
// Returns the cudaError_t of the launch.
extern "C" int ds_fused_adam(void* params, const void* grads, void* exp_avg, void* exp_avg_sq,
                             long long n, float lr, float b1, float b2, float eps, float wd,
                             float step, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const int vec4 = aligned(params) && aligned(grads) && aligned(exp_avg) && aligned(exp_avg_sq);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  constexpr int threads = 256;
  const long long work = vec4 ? (n + 3) / 4 : n;
  const long long want = (work + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  adam_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(params), static_cast<const float*>(grads),
      static_cast<float*>(exp_avg), static_cast<float*>(exp_avg_sq), static_cast<size_t>(n), lr,
      b1, b2, eps, wd, step, vec4);
  return cudaGetLastError();
}
