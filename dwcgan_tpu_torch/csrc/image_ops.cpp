// Native host-side image preprocessing for the data pipeline.
//
// The reference's host pipeline is PIL + torchvision transforms
// (data_loader.py:12-24): CenterCrop -> Resize(bilinear) -> ToTensor ->
// Normalize, one Python object per stage per image.  This kernel fuses
// crop + horizontal flip + bilinear resize + [-1,1] normalization into one
// pass over the pixels, OpenMP-parallel across the batch, writing the NHWC
// float32 tensor the device consumes directly.
//
// Bilinear sampling uses half-pixel centers (align_corners=false), matching
// jax.image.resize / F.interpolate — NOT PIL's antialiased filter (PIL
// box-filters on downscale; outputs differ slightly by design).
//
// The port's own copy of the JAX package's host kernel, arithmetic
// unchanged: bit-equal to it when both are built with the same flags.
// Build: at first use by dwcgan_tpu_torch/native/__init__.py
//        (g++ -O3 -fPIC -fopenmp -Wall -shared, into build/host/)
// Bind:  ctypes via dwcgan_tpu_torch/native/__init__.py

#include <algorithm>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// Bilinear sample of channel c at (y, x) in a HxWx3 uint8 image.
inline float sample(const uint8_t* img, int h, int w, float y, float x, int c) {
    int y0 = static_cast<int>(y);
    int x0 = static_cast<int>(x);
    y0 = std::max(0, std::min(y0, h - 1));
    x0 = std::max(0, std::min(x0, w - 1));
    int y1 = std::min(y0 + 1, h - 1);
    int x1 = std::min(x0 + 1, w - 1);
    float fy = y - static_cast<float>(y0);
    float fx = x - static_cast<float>(x0);
    fy = std::max(0.0f, std::min(fy, 1.0f));
    fx = std::max(0.0f, std::min(fx, 1.0f));
    const float v00 = img[(y0 * w + x0) * 3 + c];
    const float v01 = img[(y0 * w + x1) * 3 + c];
    const float v10 = img[(y1 * w + x0) * 3 + c];
    const float v11 = img[(y1 * w + x1) * 3 + c];
    const float top = v00 + (v01 - v00) * fx;
    const float bot = v10 + (v11 - v10) * fx;
    return top + (bot - top) * fy;
}

// One image: center-crop `crop` pixels, optional hflip, bilinear resize to
// out_size, normalize to [-1, 1].  src: HxWx3 uint8; dst: out*out*3 f32.
void preprocess_one(const uint8_t* src, int h, int w, int crop, int out_size,
                    int hflip, float* dst) {
    const int top = (h - crop) / 2;
    const int left = (w - crop) / 2;
    const float scale = static_cast<float>(crop) / static_cast<float>(out_size);
    for (int oy = 0; oy < out_size; ++oy) {
        // half-pixel centers: src_y = (oy + 0.5) * scale - 0.5
        const float sy = (static_cast<float>(oy) + 0.5f) * scale - 0.5f
                         + static_cast<float>(top);
        for (int ox = 0; ox < out_size; ++ox) {
            const int ox_eff = hflip ? (out_size - 1 - ox) : ox;
            const float sx = (static_cast<float>(ox_eff) + 0.5f) * scale - 0.5f
                             + static_cast<float>(left);
            float* out = dst + (oy * out_size + ox) * 3;
            for (int c = 0; c < 3; ++c) {
                out[c] = sample(src, h, w, sy, sx, c) * (1.0f / 127.5f) - 1.0f;
            }
        }
    }
}

}  // namespace

extern "C" {

// Batched fused preprocessing.
//   src:     n contiguous HxWx3 uint8 images (all same size)
//   hflips:  n int32 flags (0/1), may be null (no flips)
//   dst:     n * out_size * out_size * 3 float32, NHWC
void dwc_preprocess_batch(const uint8_t* src, int n, int h, int w, int crop,
                          int out_size, const int32_t* hflips, float* dst) {
    const int64_t in_stride = static_cast<int64_t>(h) * w * 3;
    const int64_t out_stride = static_cast<int64_t>(out_size) * out_size * 3;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int i = 0; i < n; ++i) {
        preprocess_one(src + i * in_stride, h, w, crop, out_size,
                       hflips ? hflips[i] : 0, dst + i * out_stride);
    }
}

// Fused uint8 -> [-1, 1] float32 (no geometry), OpenMP over elements.
void dwc_normalize_u8(const uint8_t* src, int64_t count, float* dst) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < count; ++i) {
        dst[i] = static_cast<float>(src[i]) * (1.0f / 127.5f) - 1.0f;
    }
}

int dwc_omp_threads() {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
