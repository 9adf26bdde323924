// Native image transform engine of the port's data path (the same
// algorithm as gcc_tpu/native/image_ops.cpp, so the two give the same bits).
//
// The reference does its image preprocessing in Python (PIL + torchvision,
// data/base_dataset.py:81-112). Here the per-sample chain resize -> crop ->
// flip -> normalize to [-1, 1] float32 runs in C++ on a std::thread pool, so
// the host keeps up with the card: decoding stays in Python, everything
// after it runs here.
//
// The resampler is PIL's convolution resize: separable bicubic (Keys,
// a = -0.5) with the support widened by the downsampling factor, per-axis
// coefficient tables, a clipped uint8 intermediate after the horizontal
// pass. It accumulates in float, so it matches PIL BICUBIC within one uint8
// level (data/resample.py is the bit-exact numpy version).
//
// Build (gcc_tpu_torch/native/__init__.py does it at first use):
//   g++ -O3 -march=native -funroll-loops -shared -fPIC -std=c++17 -pthread
//       image_ops.cpp -o libgcc_image.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline double bicubic_kernel(double x) {
  // Keys cubic, a = -0.5 (PIL BICUBIC)
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Coeffs {
  std::vector<int> bounds;     // (xmin, size) per output pixel
  std::vector<double> values;  // ksize weights per output pixel
  int ksize = 0;
};

Coeffs precompute(int in_size, int out_size) {
  Coeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;  // bicubic support = 2
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.resize(out_size * 2);
  c.values.assign(static_cast<size_t>(out_size) * c.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &c.values[static_cast<size_t>(xx) * c.ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double w = bicubic_kernel((x + xmin - center + 0.5) / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    c.bounds[xx * 2] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

inline uint8_t clip8(float v) {
  if (v <= 0.0f) return 0;
  if (v >= 255.0f) return 255;
  return static_cast<uint8_t>(v + 0.5f);
}

// separable resize: uint8 HWC -> uint8 HWC (3 channels)
void resize_bicubic_u8(const uint8_t* src, int in_h, int in_w, uint8_t* dst,
                       int out_h, int out_w) {
  Coeffs ch = precompute(in_w, out_w);
  Coeffs cv = precompute(in_h, out_h);
  // PIL 8bpc semantics: horizontal pass produces a clipped uint8
  // intermediate (ImagingResampleHorizontal_8bpc), then the vertical pass
  // resamples that. float coefficients; SIMD-friendly inner loops.
  std::vector<float> kh(ch.values.begin(), ch.values.end());
  std::vector<float> kv(cv.values.begin(), cv.values.end());
  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * 3;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const int xmin = ch.bounds[x * 2], xsz = ch.bounds[x * 2 + 1];
      const float* k = &kh[static_cast<size_t>(x) * ch.ksize];
      float a0 = 0, a1 = 0, a2 = 0;
      const uint8_t* p = row + static_cast<size_t>(xmin) * 3;
      for (int i = 0; i < xsz; ++i, p += 3) {
        a0 += k[i] * p[0];
        a1 += k[i] * p[1];
        a2 += k[i] * p[2];
      }
      trow[x * 3] = clip8(a0);
      trow[x * 3 + 1] = clip8(a1);
      trow[x * 3 + 2] = clip8(a2);
    }
  }
  for (int y = 0; y < out_h; ++y) {
    const int ymin = cv.bounds[y * 2], ysz = cv.bounds[y * 2 + 1];
    const float* k = &kv[static_cast<size_t>(y) * cv.ksize];
    uint8_t* drow = dst + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      float acc = 0;
      const uint8_t* t = tmp.data() + static_cast<size_t>(ymin) * out_w * 3 + x;
      for (int i = 0; i < ysz; ++i, t += static_cast<size_t>(out_w) * 3)
        acc += k[i] * *t;
      drow[x] = clip8(acc);
    }
  }
}

// one sample: resize -> crop -> flip -> [-1,1] float32
void transform_one(const uint8_t* src, int in_h, int in_w, float* dst,
                   int load_size, int crop_size, int crop_x, int crop_y,
                   int flip) {
  std::vector<uint8_t> resized(static_cast<size_t>(load_size) * load_size * 3);
  const uint8_t* base = src;
  int h = in_h, w = in_w;
  if (in_h != load_size || in_w != load_size) {
    resize_bicubic_u8(src, in_h, in_w, resized.data(), load_size, load_size);
    base = resized.data();
    h = w = load_size;
  }
  if (crop_x + crop_size > w) crop_x = w - crop_size;
  if (crop_y + crop_size > h) crop_y = h - crop_size;
  if (crop_x < 0) crop_x = 0;
  if (crop_y < 0) crop_y = 0;
  const float scale = 2.0f / 255.0f;
  for (int y = 0; y < crop_size; ++y) {
    const uint8_t* row =
        base + (static_cast<size_t>(crop_y + y) * w + crop_x) * 3;
    float* out_row = dst + static_cast<size_t>(y) * crop_size * 3;
    for (int x = 0; x < crop_size; ++x) {
      int sx = flip ? (crop_size - 1 - x) : x;
      const uint8_t* p = row + static_cast<size_t>(sx) * 3;
      float* o = out_row + static_cast<size_t>(x) * 3;
      o[0] = p[0] * scale - 1.0f;
      o[1] = p[1] * scale - 1.0f;
      o[2] = p[2] * scale - 1.0f;
    }
  }
}

}  // namespace

extern "C" {

// Resize a single uint8 HWC image (3ch) with PIL-compatible bicubic.
void gcc_resize_bicubic_u8(const uint8_t* src, int in_h, int in_w,
                           uint8_t* dst, int out_h, int out_w) {
  resize_bicubic_u8(src, in_h, in_w, dst, out_h, out_w);
}

// Batch transform with a thread pool: n images (each uint8 HWC, possibly
// different sizes given via hs/ws) -> float32 NHWC [-1,1] batch.
void gcc_transform_batch(const uint8_t** srcs, const int* hs, const int* ws,
                         int n, float* dst, int load_size, int crop_size,
                         const int* crop_xs, const int* crop_ys,
                         const int* flips, int num_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      transform_one(srcs[i], hs[i], ws[i],
                    dst + static_cast<size_t>(i) * crop_size * crop_size * 3,
                    load_size, crop_size, crop_xs[i], crop_ys[i], flips[i]);
    }
  };
  int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
