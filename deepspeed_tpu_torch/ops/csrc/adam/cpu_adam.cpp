// The port's copy of deepspeed_tpu/ops/csrc/adam/cpu_adam.cpp, built by g++ at
// first use with the JAX package's flags (ops/op_builder.py HOST_FLAGS;
// -fopenmp-simd for -fopenmp, enough for the simd pragmas): the same bits.
//
// Host-side vectorized Adam for ZeRO-Offload (DeepSpeedCPUAdam analog).
//
// Counterpart of the reference's csrc/adam/cpu_adam_impl.cpp + simd.h:
// AVX2/AVX512-vectorized AdamW update over contiguous fp32 buffers, run on
// host CPU while the accelerator computes the next step's forward/backward.
// Vectorization is delegated to the compiler (-O3 -march=native -ffast-math
// auto-vectorizes this loop to AVX512 where available), which matches the
// hand-rolled intrinsics of the reference within measurement noise on
// stream-bound updates.
//
// C ABI: ds_cpu_adam_step operates on raw fp32 pointers (params, grads,
// exp_avg, exp_avg_sq), matching the reference's flat-buffer contract.

#include <cmath>
#include <cstdint>

extern "C" {

void ds_cpu_adam_step(float* params,
                      const float* grads,
                      float* exp_avg,
                      float* exp_avg_sq,
                      int64_t n,
                      int64_t step,
                      float lr,
                      float beta1,
                      float beta2,
                      float eps,
                      float weight_decay,
                      int adamw_mode,
                      int bias_correction) {
    float bc1 = 1.0f, bc2 = 1.0f;
    if (bias_correction) {
        bc1 = 1.0f - std::pow(beta1, static_cast<float>(step));
        bc2 = 1.0f - std::pow(beta2, static_cast<float>(step));
    }
    const float inv_bc1 = 1.0f / bc1;
    const float inv_bc2 = 1.0f / bc2;
    const float one_minus_b1 = 1.0f - beta1;
    const float one_minus_b2 = 1.0f - beta2;

    if (adamw_mode) {
#pragma omp simd
        for (int64_t i = 0; i < n; ++i) {
            const float g = grads[i];
            const float m = beta1 * exp_avg[i] + one_minus_b1 * g;
            const float v = beta2 * exp_avg_sq[i] + one_minus_b2 * g * g;
            exp_avg[i] = m;
            exp_avg_sq[i] = v;
            const float mh = m * inv_bc1;
            const float vh = v * inv_bc2;
            const float update = mh / (std::sqrt(vh) + eps) + weight_decay * params[i];
            params[i] -= lr * update;
        }
    } else {
#pragma omp simd
        for (int64_t i = 0; i < n; ++i) {
            const float g = grads[i] + weight_decay * params[i];
            const float m = beta1 * exp_avg[i] + one_minus_b1 * g;
            const float v = beta2 * exp_avg_sq[i] + one_minus_b2 * g * g;
            exp_avg[i] = m;
            exp_avg_sq[i] = v;
            const float mh = m * inv_bc1;
            const float vh = v * inv_bc2;
            params[i] -= lr * (mh / (std::sqrt(vh) + eps));
        }
    }
}

void ds_cpu_adagrad_step(float* params,
                         const float* grads,
                         float* exp_avg_sq,
                         int64_t n,
                         float lr,
                         float eps,
                         float weight_decay) {
#pragma omp simd
    for (int64_t i = 0; i < n; ++i) {
        const float g = grads[i] + weight_decay * params[i];
        const float acc = exp_avg_sq[i] + g * g;
        exp_avg_sq[i] = acc;
        params[i] -= lr * g / (std::sqrt(acc) + eps);
    }
}

void ds_cpu_lion_step(float* params,
                      const float* grads,
                      float* exp_avg,
                      int64_t n,
                      float lr,
                      float beta1,
                      float beta2,
                      float weight_decay) {
#pragma omp simd
    for (int64_t i = 0; i < n; ++i) {
        const float g = grads[i];
        const float c = beta1 * exp_avg[i] + (1.0f - beta1) * g;
        const float sign = c > 0.0f ? 1.0f : (c < 0.0f ? -1.0f : 0.0f);
        params[i] -= lr * (sign + weight_decay * params[i]);
        exp_avg[i] = beta2 * exp_avg[i] + (1.0f - beta2) * g;
    }
}

}  // extern "C"
