// Native data-layer kernels for the host-side input pipeline.
//
// The reference's data layer leans on cv2 + torch DataLoader worker
// processes (reference core/datasets.py:236-237, num_workers=24); this
// framework's loader threads call these C++ kernels for the augmentation
// hot path instead (bilinear/nearest resize, photometric jitter, eraser,
// sparse-flow scatter), with numpy fallbacks when the shared library is
// unavailable. Semantics match cv2/torchvision so the two backends are
// interchangeable (asserted in tests/test_native_augment.py).
//
// All images are float32 HWC, C-contiguous. Build: see build.py (g++ -O3
// -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// cv2 INTER_LINEAR semantics: half-pixel centers, edge replication.
// inv_sx/inv_sy are the src/dst coordinate scales. cv2 derives them from
// the caller's fx/fy when given (NOT from the size ratio — the two differ
// at non-round scales); pass 0 to fall back to the size ratio.
void resize_bilinear_f32(const float* src, int h, int w, int c,
                         float* dst, int h2, int w2,
                         double inv_sx, double inv_sy) {
    const double sy = inv_sy > 0 ? inv_sy : (double)h / h2;
    const double sx = inv_sx > 0 ? inv_sx : (double)w / w2;
    for (int y = 0; y < h2; ++y) {
        double fy = (y + 0.5) * sy - 0.5;
        int y0 = (int)std::floor(fy);
        double v = fy - y0;
        if (y0 < 0) { y0 = 0; v = 0.0; }
        int y1 = y0 + 1;
        if (y1 >= h) { y1 = h - 1; if (y0 >= h - 1) { y0 = h - 1; v = 0.0; } }
        for (int x = 0; x < w2; ++x) {
            double fx = (x + 0.5) * sx - 0.5;
            int x0 = (int)std::floor(fx);
            double u = fx - x0;
            if (x0 < 0) { x0 = 0; u = 0.0; }
            int x1 = x0 + 1;
            if (x1 >= w) { x1 = w - 1; if (x0 >= w - 1) { x0 = w - 1; u = 0.0; } }
            const float* p00 = src + (y0 * w + x0) * c;
            const float* p01 = src + (y0 * w + x1) * c;
            const float* p10 = src + (y1 * w + x0) * c;
            const float* p11 = src + (y1 * w + x1) * c;
            float* out = dst + (y * w2 + x) * c;
            const double w00 = (1 - u) * (1 - v), w01 = u * (1 - v);
            const double w10 = (1 - u) * v,       w11 = u * v;
            for (int k = 0; k < c; ++k)
                out[k] = (float)(w00 * p00[k] + w01 * p01[k]
                                 + w10 * p10[k] + w11 * p11[k]);
        }
    }
}

// cv2 INTER_NEAREST semantics: src index = floor(dst * scale).
void resize_nearest_f32(const float* src, int h, int w, int c,
                        float* dst, int h2, int w2,
                        double inv_sx, double inv_sy) {
    const double sy = inv_sy > 0 ? inv_sy : (double)h / h2;
    const double sx = inv_sx > 0 ? inv_sx : (double)w / w2;
    for (int y = 0; y < h2; ++y) {
        int ys = std::min((int)std::floor(y * sy), h - 1);
        for (int x = 0; x < w2; ++x) {
            int xs = std::min((int)std::floor(x * sx), w - 1);
            std::memcpy(dst + (y * w2 + x) * c,
                        src + (ys * w + xs) * c, sizeof(float) * c);
        }
    }
}

// In-place photometric ops (torchvision factor semantics, RGB float in
// [0, 255]). Exposed per-op so ColorJitter's random op ordering can be
// honored; each clips to [0, 255] like the numpy implementations.
static inline float clip255(float v) {
    return v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
}

void adjust_brightness_f32(float* img, int n_pixels, float f) {
    for (int i = 0; i < n_pixels * 3; ++i) img[i] = clip255(img[i] * f);
}

// blends toward the scalar mean of the grayscale image
void adjust_contrast_f32(float* img, int n_pixels, float f) {
    double mean = 0.0;
    for (int i = 0; i < n_pixels; ++i)
        mean += 0.299 * img[i * 3] + 0.587 * img[i * 3 + 1]
                + 0.114 * img[i * 3 + 2];
    const float g = (float)(mean / n_pixels) * (1.0f - f);
    for (int i = 0; i < n_pixels * 3; ++i)
        img[i] = clip255(img[i] * f + g);
}

// blends toward per-pixel gray
void adjust_saturation_f32(float* img, int n_pixels, float f) {
    for (int i = 0; i < n_pixels; ++i) {
        float* p = img + i * 3;
        const float g = (0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2])
                        * (1.0f - f);
        for (int k = 0; k < 3; ++k) p[k] = clip255(p[k] * f + g);
    }
}

// Fill a rectangle with the supplied per-channel values (eraser aug;
// reference core/utils/augmentor.py:52-65 fills with the image mean).
void erase_rect_f32(float* img, int h, int w, int c,
                    int y0, int x0, int dy, int dx, const float* fill) {
    const int y1 = std::min(y0 + dy, h), x1 = std::min(x0 + dx, w);
    for (int y = std::max(y0, 0); y < y1; ++y)
        for (int x = std::max(x0, 0); x < x1; ++x)
            for (int k = 0; k < c; ++k)
                img[(y * w + x) * c + k] = fill[k];
}

// Sparse flow-map resize: scatter valid flow vectors onto the scaled grid
// (reference core/utils/augmentor.py:161-193). flow (h, w, 2) float,
// valid (h, w) float/0-1; outputs must be zero-initialized by the caller.
void resize_sparse_flow_f32(const float* flow, const float* valid,
                            int h, int w, double fx, double fy,
                            float* flow_out, float* valid_out,
                            int h2, int w2) {
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            if (valid[y * w + x] < 0.5f) continue;
            // match numpy np.round (banker's rounding, float64 product)
            const double cx = (double)x * fx, cy = (double)y * fy;
            int xx = (int)std::nearbyint(cx);
            int yy = (int)std::nearbyint(cy);
            if (xx <= 0 || xx >= w2 || yy <= 0 || yy >= h2) continue;
            flow_out[(yy * w2 + xx) * 2] =
                (float)(flow[(y * w + x) * 2] * fx);
            flow_out[(yy * w2 + xx) * 2 + 1] =
                (float)(flow[(y * w + x) * 2 + 1] * fy);
            valid_out[yy * w2 + xx] = 1.0f;
        }
    }
}

}  // extern "C"
