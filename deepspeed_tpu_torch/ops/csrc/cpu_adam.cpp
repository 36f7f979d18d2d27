// Host-side SIMD Adam/AdamW/Adagrad — the ZeRO-Offload optimizer step.
//
// The host half of ZeRO-Offload (reference csrc/adam/cpu_adam.cpp +
// csrc/includes/simd.h, AVX512/AVX2 intrinsics, cpu_adam.cpp:286-291):
// when the optimizer state lives in host memory, the fp32 master update
// runs on the host CPU while the GPU works on other leaves. The kernel is
// vectorized (AVX2 via intrinsics, scalar tail) and parallelized over
// OpenMP threads; it also emits the bf16 copy-back buffer in the same
// pass. The arithmetic is the JAX package's csrc/cpu_adam.cpp, line for
// line, so equal inputs give equal bits.
//
// Blocks of 4096 elements: a caller that splits a leaf into chunks whose
// starts are multiples of 4096 gets the bits of one call over the leaf.
//
// C ABI (ctypes-friendly): state is caller-owned flat fp32 buffers.
#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Round-to-nearest-even fp32 -> bf16. NaN must stay NaN: the RNE carry
// can overflow a NaN mantissa into the Inf pattern, so NaN truncates.
static inline uint16_t f32_to_bf16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    if ((x & 0x7fffffffu) > 0x7f800000u)      // NaN
        return (uint16_t)((x >> 16) | 0x0040); // quieted, sign kept
    uint32_t lsb = (x >> 16) & 1;
    x += 0x7fff + lsb;
    return (uint16_t)(x >> 16);
}

// One fused AdamW step over a flat fp32 shard.
//   w, g, m, v: fp32 buffers of length n (caller-owned, updated in place)
//   bf16_out: optional bf16 copy-back buffer (nullptr to skip)
//   adamw: 1 = decoupled weight decay (AdamW), 0 = L2-into-grad (Adam)
// Bias correction uses `step` (1-based).
void dstpu_adam_update(float* w, float* g, float* m, float* v,
                       int64_t n, int64_t step, float lr, float beta1,
                       float beta2, float eps, float weight_decay,
                       int adamw, uint16_t* bf16_out) {
    const float bc1 = 1.0f - std::pow(beta1, (float)step);
    const float bc2 = 1.0f - std::pow(beta2, (float)step);
    const float step_size = lr / bc1;
    const float bc2_sqrt = std::sqrt(bc2);

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i0 = 0; i0 < n; i0 += 4096) {
        int64_t i1 = i0 + 4096 < n ? i0 + 4096 : n;
        int64_t i = i0;
#if defined(__AVX2__) && defined(__FMA__)
        const __m256 vb1 = _mm256_set1_ps(beta1);
        const __m256 vb1m = _mm256_set1_ps(1.0f - beta1);
        const __m256 vb2 = _mm256_set1_ps(beta2);
        const __m256 vb2m = _mm256_set1_ps(1.0f - beta2);
        const __m256 veps = _mm256_set1_ps(eps);
        const __m256 vstep = _mm256_set1_ps(step_size);
        const __m256 vbc2 = _mm256_set1_ps(bc2_sqrt);
        const __m256 vwd = _mm256_set1_ps(weight_decay);
        const __m256 vlrwd = _mm256_set1_ps(1.0f - lr * weight_decay);
        for (; i + 8 <= i1; i += 8) {
            __m256 wi = _mm256_loadu_ps(w + i);
            __m256 gi = _mm256_loadu_ps(g + i);
            if (!adamw && weight_decay > 0.0f)
                gi = _mm256_fmadd_ps(vwd, wi, gi);
            __m256 mi = _mm256_loadu_ps(m + i);
            __m256 vi = _mm256_loadu_ps(v + i);
            mi = _mm256_fmadd_ps(vb1, mi, _mm256_mul_ps(vb1m, gi));
            vi = _mm256_fmadd_ps(vb2, vi,
                                 _mm256_mul_ps(vb2m, _mm256_mul_ps(gi, gi)));
            _mm256_storeu_ps(m + i, mi);
            _mm256_storeu_ps(v + i, vi);
            __m256 denom = _mm256_add_ps(
                _mm256_div_ps(_mm256_sqrt_ps(vi), vbc2), veps);
            __m256 upd = _mm256_div_ps(mi, denom);
            if (adamw && weight_decay > 0.0f)
                wi = _mm256_mul_ps(wi, vlrwd);
            wi = _mm256_fnmadd_ps(vstep, upd, wi);
            _mm256_storeu_ps(w + i, wi);
        }
#endif
        for (; i < i1; ++i) {
            float gi = g[i];
            if (!adamw && weight_decay > 0.0f) gi += weight_decay * w[i];
            m[i] = beta1 * m[i] + (1.0f - beta1) * gi;
            v[i] = beta2 * v[i] + (1.0f - beta2) * gi * gi;
            float denom = std::sqrt(v[i]) / bc2_sqrt + eps;
            float wi = w[i];
            if (adamw && weight_decay > 0.0f) wi *= 1.0f - lr * weight_decay;
            w[i] = wi - step_size * (m[i] / denom);
        }
        if (bf16_out) {
            for (int64_t j = i0; j < i1; ++j) bf16_out[j] = f32_to_bf16(w[j]);
        }
    }
}

// Adagrad (csrc/adagrad/cpu_adagrad.cpp:221-226 analog).
void dstpu_adagrad_update(float* w, float* g, float* h, int64_t n,
                          float lr, float eps, float weight_decay,
                          uint16_t* bf16_out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i0 = 0; i0 < n; i0 += 4096) {
        int64_t i1 = i0 + 4096 < n ? i0 + 4096 : n;
        for (int64_t i = i0; i < i1; ++i) {
            float gi = g[i];
            if (weight_decay > 0.0f) gi += weight_decay * w[i];
            h[i] += gi * gi;
            w[i] -= lr * gi / (std::sqrt(h[i]) + eps);
        }
        if (bf16_out) {
            for (int64_t j = i0; j < i1; ++j) bf16_out[j] = f32_to_bf16(w[j]);
        }
    }
}

int dstpu_simd_width() {
#if defined(__AVX512F__)
    return 16;
#elif defined(__AVX2__)
    return 8;
#else
    return 1;
#endif
}

int dstpu_num_threads() {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
