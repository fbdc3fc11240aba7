// fvt_native: native (C++) image decode and resample for the input
// pipeline: a copy of fastervit_tpu/data/native/fvt_native.cpp.
//
// The reference's data path (fastervit/train.py:624-669 -> timm
// create_loader -> torchvision PIL transforms) decodes and resamples on the
// host in Python worker processes, and the Python/PIL path holds the GIL
// between per-image transform steps; this library does the whole batch
// natively: libjpeg decode -> Pillow-exact bicubic resample ->
// crop/normalize, parallelized with an internal thread pool, writing
// straight into the caller-provided NHWC batch buffer. It runs on the host
// only; nothing of it touches a device.
//
// Resampling is a faithful re-implementation of Pillow's 8-bit fixed-point
// resampling (two-pass separable convolution, 22-bit coefficient precision)
// so outputs are bit-identical to the PIL path the accuracy tables are
// measured through (tests/test_torch_data.py holds the two to the bit).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this environment).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg) with error-trap -> bool status
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode to RGB8. Returns false on any libjpeg error or unsupported color
// space (caller falls back to PIL).
bool decode_jpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                 int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    // PIL applies an inverted-CMYK convention here; defer to it.
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data() + static_cast<size_t>(cinfo.output_scanline) *
                                     *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool jpeg_dims(const uint8_t* buf, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  bool ok = jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK;
  if (ok) {
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    ok = !(cinfo.jpeg_color_space == JCS_CMYK ||
           cinfo.jpeg_color_space == JCS_YCCK);
  }
  jpeg_destroy_decompress(&cinfo);
  return ok;
}

// ---------------------------------------------------------------------------
// Pillow-exact bicubic resampling (libImaging/Resample.c, 8bpc path)
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow PRECISION_BITS

inline double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}
constexpr double kBicubicSupport = 2.0;

inline uint8_t clip8(int in) {
  int v = in >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Pillow precompute_coeffs + normalize_coeffs_8bpc fused: double coeffs
// normalized to sum 1, then fixed-point with round-half-away-from-zero.
int precompute_coeffs(int in_size, double in0, double in1, int out_size,
                      std::vector<int>* bounds, std::vector<int32_t>* kk) {
  double scale = (in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = kBicubicSupport * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> kd(ksize);
  bounds->resize(out_size * 2);
  kk->assign(static_cast<size_t>(out_size) * ksize, 0);
  double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; x++) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      kd[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) kd[x] /= ww;
    }
    int32_t* k = kk->data() + static_cast<size_t>(xx) * ksize;
    for (int x = 0; x < xmax; x++) {
      k[x] = static_cast<int32_t>(
          kd[x] < 0 ? -0.5 + kd[x] * (1 << kPrecisionBits)
                    : 0.5 + kd[x] * (1 << kPrecisionBits));
    }
    (*bounds)[xx * 2 + 0] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  return ksize;
}

// Horizontal pass over rows [row0, row0 + out_h) of src, RGB8.
void resample_horizontal(const uint8_t* src, int src_w, int row0, int out_w,
                         int out_h, int ksize, const std::vector<int>& bounds,
                         const std::vector<int32_t>& kk, uint8_t* dst) {
  for (int yy = 0; yy < out_h; yy++) {
    const uint8_t* in_row =
        src + static_cast<size_t>(yy + row0) * src_w * 3;
    uint8_t* out_row = dst + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; xx++) {
      int xmin = bounds[xx * 2 + 0];
      int xmax = bounds[xx * 2 + 1];
      const int32_t* k = kk.data() + static_cast<size_t>(xx) * ksize;
      int ss0 = 1 << (kPrecisionBits - 1);
      int ss1 = ss0, ss2 = ss0;
      const uint8_t* p = in_row + static_cast<size_t>(xmin) * 3;
      for (int x = 0; x < xmax; x++, p += 3) {
        ss0 += p[0] * k[x];
        ss1 += p[1] * k[x];
        ss2 += p[2] * k[x];
      }
      out_row[xx * 3 + 0] = clip8(ss0);
      out_row[xx * 3 + 1] = clip8(ss1);
      out_row[xx * 3 + 2] = clip8(ss2);
    }
  }
}

// Vertical pass, RGB8. Row-streaming accumulation: each source row is read
// once, contiguously, into an int32 accumulator row (auto-vectorizes), rather
// than walking columns per output pixel.
void resample_vertical(const uint8_t* src, int src_w, int out_h, int ksize,
                       const std::vector<int>& bounds,
                       const std::vector<int32_t>& kk, uint8_t* dst) {
  const int row_len = src_w * 3;
  std::vector<int32_t> acc(row_len);
  for (int yy = 0; yy < out_h; yy++) {
    int ymin = bounds[yy * 2 + 0];
    int ymax = bounds[yy * 2 + 1];
    const int32_t* k = kk.data() + static_cast<size_t>(yy) * ksize;
    std::fill(acc.begin(), acc.end(), 1 << (kPrecisionBits - 1));
    for (int y = 0; y < ymax; y++) {
      const uint8_t* srow = src + static_cast<size_t>(y + ymin) * row_len;
      const int32_t kv = k[y];
      for (int xx = 0; xx < row_len; xx++) acc[xx] += srow[xx] * kv;
    }
    uint8_t* out_row = dst + static_cast<size_t>(yy) * row_len;
    for (int xx = 0; xx < row_len; xx++) out_row[xx] = clip8(acc[xx]);
  }
}

// Pillow ImagingResampleInner for RGB8: box = (x0, y0, x1, y1) floats.
void resample_bicubic(const uint8_t* src, int src_h, int src_w, double bx0,
                      double by0, double bx1, double by1, int out_h, int out_w,
                      std::vector<uint8_t>* out) {
  bool need_h = out_w != src_w || bx0 != 0.0 || bx1 != out_w;
  bool need_v = out_h != src_h || by0 != 0.0 || by1 != out_h;
  std::vector<int> hb, vb;
  std::vector<int32_t> hk, vk;
  int hks = 0, vks = 0;
  int ybox_first = 0, ybox_last = src_h;
  if (need_v) {
    vks = precompute_coeffs(src_h, by0, by1, out_h, &vb, &vk);
    ybox_first = vb[0];
    ybox_last = 0;
    for (int i = 0; i < out_h; i++) {
      ybox_last = std::max(ybox_last, vb[i * 2] + vb[i * 2 + 1]);
    }
  }
  const uint8_t* cur = src;
  int cur_w = src_w;
  std::vector<uint8_t> tmp;
  int row0 = 0;
  if (need_h) {
    if (need_v) {
      for (int i = 0; i < out_h; i++) vb[i * 2] -= ybox_first;
    }
    hks = precompute_coeffs(src_w, bx0, bx1, out_w, &hb, &hk);
    int tmp_h = ybox_last - ybox_first;
    tmp.resize(static_cast<size_t>(out_w) * tmp_h * 3);
    resample_horizontal(src, src_w, ybox_first, out_w, tmp_h, hks, hb, hk,
                        tmp.data());
    cur = tmp.data();
    cur_w = out_w;
    row0 = 0;
  } else if (need_v) {
    // vertical reads the original rows directly; bounds stay absolute
    row0 = 0;
  }
  if (need_v) {
    out->resize(static_cast<size_t>(out_w) * out_h * 3);
    resample_vertical(cur, cur_w, out_h, vks, vb, vk, out->data());
  } else if (need_h) {
    out->assign(cur, cur + static_cast<size_t>(out_w) * out_h * 3);
  } else {
    // int-aligned identity box: plain copy of the region
    out->resize(static_cast<size_t>(out_w) * out_h * 3);
    for (int y = 0; y < out_h; y++) {
      std::memcpy(out->data() + static_cast<size_t>(y) * out_w * 3,
                  src + ((static_cast<size_t>(y) + static_cast<int>(by0)) *
                             src_w +
                         static_cast<int>(bx0)) *
                            3,
                  static_cast<size_t>(out_w) * 3);
    }
  }
  (void)row0;
}

// PIL crop semantics: out-of-bounds region is zero-filled.
void crop_rgb(const std::vector<uint8_t>& src, int src_h, int src_w, int left,
              int top, int out_h, int out_w, std::vector<uint8_t>* out) {
  out->assign(static_cast<size_t>(out_w) * out_h * 3, 0);
  int y0 = std::max(0, -top), y1 = std::min(out_h, src_h - top);
  int x0 = std::max(0, -left), x1 = std::min(out_w, src_w - left);
  for (int y = y0; y < y1; y++) {
    std::memcpy(out->data() + (static_cast<size_t>(y) * out_w + x0) * 3,
                src.data() +
                    ((static_cast<size_t>(y + top)) * src_w + (x0 + left)) * 3,
                static_cast<size_t>(x1 - x0) * 3);
  }
}

// Python round() semantics: round-half-to-even (C lround rounds half away
// from zero — a one-pixel crop-offset difference on odd margins).
inline double py_round(double x) { return std::nearbyint(x); }

// timm eval geometry (data/preprocess.py resize_crop): returns scale target.
void eval_scale_size(int w, int h, int th, int tw, double crop_pct,
                     bool squash, int* sw, int* sh) {
  if (squash) {
    *sh = static_cast<int>(std::floor(th / crop_pct));
    *sw = static_cast<int>(std::floor(tw / crop_pct));
  } else if (th == tw) {
    int scale = static_cast<int>(std::floor(th / crop_pct));
    if (w <= h) {
      *sw = scale;
      *sh = static_cast<int>(py_round(scale * static_cast<double>(h) / w));
    } else {
      *sh = scale;
      *sw = static_cast<int>(py_round(scale * static_cast<double>(w) / h));
    }
  } else {
    int scale_h = static_cast<int>(std::floor(th / crop_pct));
    int scale_w = static_cast<int>(std::floor(tw / crop_pct));
    double r = std::max(static_cast<double>(scale_h) / h,
                        static_cast<double>(scale_w) / w);
    *sw = static_cast<int>(py_round(w * r));
    *sh = static_cast<int>(py_round(h * r));
  }
}

void run_pool(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; i++) fn(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  int nt = std::min(n_threads, n);
  threads.reserve(nt);
  for (int t = 0; t < nt; t++) {
    threads.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Header-only dims probe. Returns 1 on success.
int fvt_jpeg_dims(const uint8_t* buf, int64_t len, int* w, int* h) {
  return jpeg_dims(buf, static_cast<size_t>(len), w, h) ? 1 : 0;
}

// Standalone Pillow-exact bicubic resample of a raw RGB8 array (tests /
// generic use). box in float pixel coords of src.
int fvt_resize_bicubic(const uint8_t* src, int src_h, int src_w, double bx0,
                       double by0, double bx1, double by1, int out_h,
                       int out_w, uint8_t* dst) {
  if (src_h <= 0 || src_w <= 0 || out_h <= 0 || out_w <= 0) return 0;
  std::vector<uint8_t> out;
  resample_bicubic(src, src_h, src_w, bx0, by0, bx1, by1, out_h, out_w, &out);
  std::memcpy(dst, out.data(), out.size());
  return 1;
}

// Eval batch: decode + timm center/squash resize + center crop + normalize.
// bufs/lens: n encoded JPEGs. out: (n, out_h, out_w, 3) float32. ok[i]=0
// marks images the caller must redo via the PIL fallback.
int fvt_eval_batch(const uint8_t* const* bufs, const int64_t* lens, int n,
                   int out_h, int out_w, double crop_pct, int squash,
                   const float* mean, const float* std_, float* out,
                   int n_threads, uint8_t* ok) {
  // per-channel 256-entry normalize LUT: (v/255 - mean) / std
  float lut[3][256];
  for (int c = 0; c < 3; c++) {
    for (int v = 0; v < 256; v++) {
      lut[c][v] = (v * (1.0f / 255.0f) - mean[c]) / std_[c];
    }
  }
  run_pool(n, n_threads, [&](int i) {
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    if (!decode_jpeg(bufs[i], static_cast<size_t>(lens[i]), &rgb, &w, &h)) {
      ok[i] = 0;
      return;
    }
    int sw = 0, sh = 0;
    eval_scale_size(w, h, out_h, out_w, crop_pct, squash != 0, &sw, &sh);
    std::vector<uint8_t> resized;
    resample_bicubic(rgb.data(), h, w, 0.0, 0.0, w, h, sh, sw, &resized);
    int left = static_cast<int>(py_round((sw - out_w) / 2.0));
    int top = static_cast<int>(py_round((sh - out_h) / 2.0));
    std::vector<uint8_t> cropped;
    crop_rgb(resized, sh, sw, left, top, out_h, out_w, &cropped);
    float* dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
    const size_t npix = static_cast<size_t>(out_h) * out_w;
    for (size_t p = 0; p < npix; p++) {
      dst[p * 3 + 0] = lut[0][cropped[p * 3 + 0]];
      dst[p * 3 + 1] = lut[1][cropped[p * 3 + 1]];
      dst[p * 3 + 2] = lut[2][cropped[p * 3 + 2]];
    }
    ok[i] = 1;
  });
  return 1;
}

// Train batch: decode + random-resized-crop (caller-chosen float boxes in
// original pixel coords) + optional hflip. Output uint8 HWC (RandAugment and
// normalization stay with the caller).
int fvt_rrc_batch(const uint8_t* const* bufs, const int64_t* lens, int n,
                  int out_h, int out_w, const double* boxes,
                  const uint8_t* hflip, uint8_t* out, int n_threads,
                  uint8_t* ok) {
  run_pool(n, n_threads, [&](int i) {
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    if (!decode_jpeg(bufs[i], static_cast<size_t>(lens[i]), &rgb, &w, &h)) {
      ok[i] = 0;
      return;
    }
    std::vector<uint8_t> resized;
    const double* b = boxes + i * 4;
    resample_bicubic(rgb.data(), h, w, b[0], b[1], b[2], b[3], out_h, out_w,
                     &resized);
    uint8_t* dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
    if (hflip[i]) {
      for (int y = 0; y < out_h; y++) {
        const uint8_t* srow =
            resized.data() + static_cast<size_t>(y) * out_w * 3;
        uint8_t* drow = dst + static_cast<size_t>(y) * out_w * 3;
        for (int x = 0; x < out_w; x++) {
          std::memcpy(drow + static_cast<size_t>(x) * 3,
                      srow + static_cast<size_t>(out_w - 1 - x) * 3, 3);
        }
      }
    } else {
      std::memcpy(dst, resized.data(), resized.size());
    }
    ok[i] = 1;
  });
  return 1;
}

// Decode one JPEG to RGB8 (max_bytes-capacity dst). Returns 1 and sets w/h.
int fvt_decode_jpeg(const uint8_t* buf, int64_t len, uint8_t* dst,
                    int64_t max_bytes, int* w, int* h) {
  std::vector<uint8_t> rgb;
  if (!decode_jpeg(buf, static_cast<size_t>(len), &rgb, w, h)) return 0;
  if (static_cast<int64_t>(rgb.size()) > max_bytes) return 0;
  std::memcpy(dst, rgb.data(), rgb.size());
  return 1;
}

}  // extern "C"
