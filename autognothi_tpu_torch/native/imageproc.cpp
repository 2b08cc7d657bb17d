// Native image pre-processing core of the port (its copy of
// autognothi_tpu/native/imageproc.cpp): bilinear resize and per-channel
// normalization of <C, H, W> float32 arrays on the host, so that the
// Python loader is not what feeds the card.  The resize samples the
// align-corners grid of data/loader.py:_resize_chw_numpy; it computes
// in fp32 where numpy computes in float64, so the two agree to ~1e-6.
//
// C ABI (ctypes): every function returns 0 on success, nonzero on error.

#include <cstdint>
#include <cmath>
#include <vector>

extern "C" {

// Bilinear resize: src <C, H, W> -> dst <C, OH, OW>, float32.
// Grid: y_i = i * (H-1)/(OH-1) (align-corners; 0 when OH == 1).
int ip_resize_bilinear(const float* src, int64_t c, int64_t h, int64_t w,
                       float* dst, int64_t oh, int64_t ow) {
    if (c <= 0 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0) return 1;
    if (h == oh && w == ow) {
        const int64_t n = c * h * w;
        for (int64_t i = 0; i < n; ++i) dst[i] = src[i];
        return 0;
    }
    std::vector<int64_t> y0(oh), y1(oh), x0(ow), x1(ow);
    std::vector<float> wy(oh), wx(ow);
    const double sy = oh > 1 ? double(h - 1) / double(oh - 1) : 0.0;
    const double sx = ow > 1 ? double(w - 1) / double(ow - 1) : 0.0;
    for (int64_t i = 0; i < oh; ++i) {
        const double y = sy * double(i);
        y0[i] = int64_t(std::floor(y));
        y1[i] = y0[i] + 1 < h ? y0[i] + 1 : h - 1;
        wy[i] = float(y - double(y0[i]));
    }
    for (int64_t j = 0; j < ow; ++j) {
        const double x = sx * double(j);
        x0[j] = int64_t(std::floor(x));
        x1[j] = x0[j] + 1 < w ? x0[j] + 1 : w - 1;
        wx[j] = float(x - double(x0[j]));
    }
    for (int64_t ch = 0; ch < c; ++ch) {
        const float* plane = src + ch * h * w;
        float* out = dst + ch * oh * ow;
        for (int64_t i = 0; i < oh; ++i) {
            const float* rt = plane + y0[i] * w;
            const float* rb = plane + y1[i] * w;
            const float fy = wy[i];
            float* orow = out + i * ow;
            for (int64_t j = 0; j < ow; ++j) {
                const float fx = wx[j];
                const float top = rt[x0[j]] * (1.0f - fx) + rt[x1[j]] * fx;
                const float bot = rb[x0[j]] * (1.0f - fx) + rb[x1[j]] * fx;
                orow[j] = top * (1.0f - fy) + bot * fy;
            }
        }
    }
    return 0;
}

// In-place per-channel normalize of a batch <N, C, H*W>:
// img[n, c, :] = (img[n, c, :] - mean[c]) / std[c]
int ip_normalize(float* img, int64_t n, int64_t c, int64_t hw,
                 const float* mean, const float* stdev) {
    if (n < 0 || c <= 0 || hw <= 0) return 1;
    for (int64_t k = 0; k < c; ++k)
        if (stdev[k] == 0.0f) return 2;
    for (int64_t b = 0; b < n; ++b) {
        for (int64_t k = 0; k < c; ++k) {
            float* plane = img + (b * c + k) * hw;
            const float m = mean[k], inv = 1.0f / stdev[k];
            for (int64_t i = 0; i < hw; ++i) plane[i] = (plane[i] - m) * inv;
        }
    }
    return 0;
}

}  // extern "C"
