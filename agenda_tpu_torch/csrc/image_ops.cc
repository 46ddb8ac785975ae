// The host image passes of the detector data path: a PIL-compatible
// triangle-filter bilinear resize, the fused HSV jitter and the uint8
// median. The dependency-free entries of native/image_ops.cc, copied
// unchanged (ctypes-bound from agenda_tpu_torch/data/native_image.py); its
// decode-and-resize entry is left out, since the port resizes on the device.
//
// All functions return 0 on success, negative on failure.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PIL-compatible triangle-filter resize (Image.BILINEAR)
// ---------------------------------------------------------------------------
//
// PIL's bilinear is a separable triangle filter whose support scales with
// the downscale factor (area-average-like when shrinking), NOT 4-neighbor
// sampling. Coefficients here mirror PIL's float path; output matches PIL
// within 1 LSB (PIL quantizes coefficients to fixed point).

struct FilterTable {
  std::vector<float> weights;  // ksize per output position
  std::vector<int32_t> starts;
  int32_t ksize;
};

static FilterTable build_triangle(int32_t in_size, int32_t out_size) {
  FilterTable t;
  double scale = static_cast<double>(in_size) / out_size;
  double support = scale < 1.0 ? 1.0 : scale;  // filter support * scale
  t.ksize = static_cast<int32_t>(std::ceil(support)) * 2 + 1;
  t.weights.assign(static_cast<size_t>(out_size) * t.ksize, 0.0f);
  t.starts.assign(out_size, 0);
  double filterscale = std::max(scale, 1.0);
  for (int32_t i = 0; i < out_size; i++) {
    double center = (i + 0.5) * scale;
    int32_t xmin = static_cast<int32_t>(std::max(0.0, center - support + 0.5));
    int32_t xmax = std::min<int32_t>(in_size,
                                     static_cast<int32_t>(center + support + 0.5));
    t.starts[i] = xmin;
    double sum = 0.0;
    std::vector<double> ww(xmax - xmin);
    for (int32_t x = xmin; x < xmax; x++) {
      double arg = (x - center + 0.5) / filterscale;
      double wgt = std::max(0.0, 1.0 - std::abs(arg));  // triangle
      ww[x - xmin] = wgt;
      sum += wgt;
    }
    for (int32_t x = 0; x < xmax - xmin; x++) {
      t.weights[static_cast<size_t>(i) * t.ksize + x] =
          static_cast<float>(sum > 0 ? ww[x] / sum : 0.0);
    }
  }
  return t;
}

// src: (sh, sw, 3) u8 -> dst: (dh, dw, 3) u8
int resize_bilinear_rgb8(const uint8_t* src, int32_t sh, int32_t sw,
                         uint8_t* dst, int32_t dh, int32_t dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0) return -9;
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<int64_t>(sh) * sw * 3);
    return 0;
  }
  FilterTable fx = build_triangle(sw, dw);
  FilterTable fy = build_triangle(sh, dh);

  // horizontal pass: (sh, sw, 3) -> (sh, dw, 3) float
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int32_t y = 0; y < sh; y++) {
    const uint8_t* row = src + static_cast<int64_t>(y) * sw * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int32_t x = 0; x < dw; x++) {
      const float* w = &fx.weights[static_cast<size_t>(x) * fx.ksize];
      int32_t x0 = fx.starts[x];
      int32_t kmax = std::min<int32_t>(fx.ksize, sw - x0);
      float r = 0, g = 0, b = 0;
      for (int32_t k = 0; k < kmax; k++) {
        const uint8_t* px = row + static_cast<int64_t>(x0 + k) * 3;
        r += w[k] * px[0];
        g += w[k] * px[1];
        b += w[k] * px[2];
      }
      trow[x * 3 + 0] = r;
      trow[x * 3 + 1] = g;
      trow[x * 3 + 2] = b;
    }
  }
  // vertical pass: (sh, dw, 3) -> (dh, dw, 3) u8
  for (int32_t y = 0; y < dh; y++) {
    const float* w = &fy.weights[static_cast<size_t>(y) * fy.ksize];
    int32_t y0 = fy.starts[y];
    int32_t kmax = std::min<int32_t>(fy.ksize, sh - y0);
    uint8_t* drow = dst + static_cast<int64_t>(y) * dw * 3;
    for (int32_t x = 0; x < dw * 3; x++) {
      float acc = 0;
      for (int32_t k = 0; k < kmax; k++) {
        acc += w[k] * tmp[static_cast<size_t>(y0 + k) * dw * 3 + x];
      }
      int32_t v = static_cast<int32_t>(acc + 0.5f);
      drow[x] = static_cast<uint8_t>(std::clamp(v, 0, 255));
    }
  }
  return 0;
}

// One-shot hot path: decode + resize + (optional) float normalize to 0..1.
// ---------------------------------------------------------------------------
// fused HSV jitter (YOLOXHSVRandomAug)
// ---------------------------------------------------------------------------
//
// The pure-numpy implementation (agenda_tpu/detect/augment.py:hsv_jitter)
// materializes ~10 full-image float temporaries for the RGB->HSV->RGB round
// trip (np.where/np.select chains) and measured 5.7 ms per 128x128 tile on
// this host — the single largest term of the Real_Source aug recipe. This
// single pass keeps each pixel in registers; formulas mirror the numpy path
// exactly (OpenCV HSV convention: h in [0,180), s/v in [0,255]).

static inline float pymod(float a, float m) {
  float r = std::fmod(a, m);
  return r < 0 ? r + m : r;
}

// img: (n, 3) float32 RGB in 0..255, modified in place.
int hsv_jitter_f32(float* img, int64_t n, float hue_gain, float sat_gain,
                   float val_gain) {
  if (n < 0) return -10;
  for (int64_t p = 0; p < n; p++) {
    float* px = img + p * 3;
    float r = px[0], g = px[1], b = px[2];
    float mx = std::max(r, std::max(g, b));
    float mn = std::min(r, std::min(g, b));
    float diff = mx - mn;
    float safe = diff > 0 ? diff : 1.0f;
    // np.where overwrite order: r branch, then g, then b (last match wins).
    float h = 0.0f;
    if (mx == r) h = pymod((g - b) / safe, 6.0f);
    if (mx == g) h = (b - r) / safe + 2.0f;
    if (mx == b) h = (r - g) / safe + 4.0f;
    h = pymod(h * 30.0f, 180.0f);
    float s = mx > 0 ? diff / std::max(mx, 1e-9f) * 255.0f : 0.0f;
    float v = mx;

    h = pymod(h + hue_gain, 180.0f);
    s = std::clamp(s + sat_gain, 0.0f, 255.0f);
    v = std::clamp(v + val_gain, 0.0f, 255.0f);

    float h6 = pymod(h / 30.0f, 6.0f);
    float s1 = s / 255.0f;
    float c = v * s1;
    float x = c * (1.0f - std::abs(pymod(h6, 2.0f) - 1.0f));
    float m = v - c;
    int i = static_cast<int>(h6);
    float rr, gg, bb;
    switch (i) {
      case 0: rr = c; gg = x; bb = 0; break;
      case 1: rr = x; gg = c; bb = 0; break;
      case 2: rr = 0; gg = c; bb = x; break;
      case 3: rr = 0; gg = x; bb = c; break;
      case 4: rr = x; gg = 0; bb = c; break;
      default: rr = c; gg = 0; bb = x; break;  // np.select defaults (i == 5)
    }
    px[0] = std::clamp(rr + m, 0.0f, 255.0f);
    px[1] = std::clamp(gg + m, 0.0f, 255.0f);
    px[2] = std::clamp(bb + m, 0.0f, 255.0f);
  }
  return 0;
}

// Median filter on a uint8 image — Huang sliding-histogram algorithm
// (the same family cv2::medianBlur uses), reflect-without-edge borders
// (numpy pad mode="reflect" == cv2 BORDER_REFLECT_101). The reference's
// Albu MedianBlur runs cv2 on the uint8 image, so uint8-median IS the
// reference semantics; a per-pixel float nth_element measured ~70-130 ms
// per 128px tile on the single-core build host vs ~2 ms here, and it
// dominated the device-aug passthrough slab (STATUS round-3 notes).
// img, out: (h, w, 3) uint8, distinct buffers. k odd, k <= 63.
int median_blur_u8(const uint8_t* img, int h, int w, int k, uint8_t* out) {
  if (k < 1 || (k & 1) == 0 || k > 63 || h < 1 || w < 1) return -1;
  const int p = k / 2;
  const int kk = k * k;
  const int target = kk / 2 + 1;  // smallest v with cum count >= target
  std::vector<int> ry(h + 2 * p), rx(w + 2 * p);
  auto reflect = [](int i, int n) {
    if (n == 1) return 0;
    while (i < 0 || i >= n) {
      if (i < 0) i = -i;
      if (i >= n) i = 2 * n - 2 - i;
    }
    return i;
  };
  for (int y = 0; y < h + 2 * p; ++y) ry[y] = reflect(y - p, h);
  for (int x = 0; x < w + 2 * p; ++x) rx[x] = reflect(x - p, w);
  for (int c = 0; c < 3; ++c) {
    for (int y = 0; y < h; ++y) {
      int hist[256] = {0};
      // window for x = 0
      for (int dy = 0; dy < k; ++dy) {
        const uint8_t* row = img + static_cast<size_t>(ry[y + dy]) * w * 3;
        for (int dx = 0; dx < k; ++dx) ++hist[row[rx[dx] * 3 + c]];
      }
      int med = 0, lt = 0;  // lt = count of window pixels < med
      while (lt + hist[med] < target) lt += hist[med++];
      out[(static_cast<size_t>(y) * w) * 3 + c] = static_cast<uint8_t>(med);
      for (int x = 1; x < w; ++x) {
        const int xo = rx[x - 1], xi = rx[x + k - 1];
        for (int dy = 0; dy < k; ++dy) {
          const uint8_t* row = img + static_cast<size_t>(ry[y + dy]) * w * 3;
          const uint8_t vo = row[xo * 3 + c], vi = row[xi * 3 + c];
          --hist[vo];
          if (vo < med) --lt;
          ++hist[vi];
          if (vi < med) ++lt;
        }
        while (lt >= target) lt -= hist[--med];
        while (lt + hist[med] < target) lt += hist[med++];
        out[(static_cast<size_t>(y) * w + x) * 3 + c] =
            static_cast<uint8_t>(med);
      }
    }
  }
  return 0;
}

}  // extern "C"
