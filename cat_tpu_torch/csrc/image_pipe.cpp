// Native image input pipeline: decode + resize + augment + normalise.
//
// The reference framework leans on torch's C++ DataLoader workers for its
// input pipeline (reference data/__init__.py:68-98, num_threads workers);
// this is the TPU-native equivalent: a GIL-free C++ batch fetcher driven
// from Python via ctypes (cat_tpu/native/__init__.py).  One call decodes,
// resizes, crops, flips and normalises a whole batch across a std::thread
// pool, writing float32 [-1, 1] NHWC directly into a caller-owned buffer
// (zero Python-side per-sample work, zero intermediate copies).
//
// Randomness (crop position, flip) stays in Python: the caller draws the
// per-sample parameters with the same RNG stream as the pure-Python path,
// so sample semantics are loader-mode independent.
//
// Decode: libjpeg (baseline + progressive JPEG) and libpng (any colour
// type, via png transforms to 8-bit RGB).  Resize: separable antialiased
// convolution with support scaled by the downsampling factor — triangle
// (Image.BILINEAR) or Catmull-Rom a=-0.5 (Image.BICUBIC), the same filter
// family PIL uses; outputs agree with PIL to within a couple of 8-bit
// levels (asserted in tests/test_native_pipe.py) but are not
// bit-identical.

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// decode a JPEG file into an RGB8 buffer; returns false on failure
bool decode_jpeg(FILE* f, std::vector<uint8_t>& rgb, int& w, int& h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = static_cast<int>(cinfo.output_width);
  h = static_cast<int>(cinfo.output_height);
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, std::vector<uint8_t>& rgb, int& w, int& h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  // normalise every colour type to 8-bit RGB
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  w = static_cast<int>(png_get_image_width(png, info));
  h = static_cast<int>(png_get_image_height(png, info));
  rgb.resize(static_cast<size_t>(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y)
    rows[y] = rgb.data() + static_cast<size_t>(y) * w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, std::vector<uint8_t>& rgb, int& w, int& h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, rgb, w, h);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, rgb, w, h);
  }
  fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// resize: separable antialiased triangle (bilinear) filter, PIL-style
// ---------------------------------------------------------------------------

// filter ids (ABI): 0 = bilinear (triangle), 1 = bicubic (Catmull-Rom)
constexpr int kBilinear = 0;
constexpr int kBicubic = 1;

double filter_weight(int filter, double x) {
  x = std::fabs(x);
  if (filter == kBicubic) {
    const double a = -0.5;  // PIL's bicubic coefficient
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
  }
  return x < 1.0 ? 1.0 - x : 0.0;  // triangle
}

double filter_support(int filter) { return filter == kBicubic ? 2.0 : 1.0; }

struct FilterTaps {
  std::vector<int> first;      // first source index per output pixel
  std::vector<int> count;      // tap count per output pixel
  std::vector<double> weight;  // taps, row-major [out][tap]
  int max_taps = 0;
};

FilterTaps build_taps(int src, int dst, int filter) {
  FilterTaps t;
  double scale = static_cast<double>(src) / dst;
  double fscale = (scale > 1.0 ? scale : 1.0);  // widen when downsampling
  double support = filter_support(filter) * fscale;
  int max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.first.resize(dst);
  t.count.resize(dst);
  t.weight.assign(static_cast<size_t>(dst) * max_taps, 0.0);
  t.max_taps = max_taps;
  for (int o = 0; o < dst; ++o) {
    double center = (o + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support));
    int hi = static_cast<int>(std::ceil(center + support));
    if (lo < 0) lo = 0;
    if (hi > src) hi = src;
    double sum = 0.0;
    int n = 0;
    for (int s = lo; s < hi; ++s) {
      double wgt = filter_weight(filter, (s + 0.5 - center) / fscale);
      if (wgt != 0.0 || n > 0) {  // keep contiguous run
        t.weight[static_cast<size_t>(o) * max_taps + n] = wgt;
        ++n;
      } else {
        ++lo;
      }
      sum += wgt;
    }
    while (n > 0 && t.weight[static_cast<size_t>(o) * max_taps + n - 1] == 0.0)
      --n;
    if (sum <= 0.0) {  // degenerate: nearest
      lo = static_cast<int>(center);
      if (lo >= src) lo = src - 1;
      t.weight[static_cast<size_t>(o) * max_taps] = 1.0;
      n = 1;
      sum = 1.0;
    }
    for (int k = 0; k < n; ++k)
      t.weight[static_cast<size_t>(o) * max_taps + k] /= sum;
    t.first[o] = lo;
    t.count[o] = n;
  }
  return t;
}

// resize RGB8 (h, w) -> RGB8 (out_h, out_w), separable two-pass in double
void resize_filtered(const uint8_t* src, int w, int h, uint8_t* dst,
                     int out_w, int out_h, int filter) {
  FilterTaps tx = build_taps(w, out_w, filter);
  FilterTaps ty = build_taps(h, out_h, filter);
  // horizontal pass into an intermediate (h, out_w) uint8 buffer —
  // rounded and clamped per pass exactly as PIL's 8bpc resampler is,
  // which matters for bicubic overshoot parity
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * out_w * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int o = 0; o < out_w; ++o) {
      const double* wts = tx.weight.data() + static_cast<size_t>(o) * tx.max_taps;
      int s0 = tx.first[o], cnt = tx.count[o];
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < cnt; ++k) {
        const uint8_t* p = row + static_cast<size_t>(s0 + k) * 3;
        acc[0] += wts[k] * p[0];
        acc[1] += wts[k] * p[1];
        acc[2] += wts[k] * p[2];
      }
      for (int c = 0; c < 3; ++c) {
        int v = static_cast<int>(std::lround(acc[c]));
        trow[o * 3 + c] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
  // vertical pass
  for (int o = 0; o < out_h; ++o) {
    const double* wts = ty.weight.data() + static_cast<size_t>(o) * ty.max_taps;
    int s0 = ty.first[o], cnt = ty.count[o];
    uint8_t* drow = dst + static_cast<size_t>(o) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      double acc = 0;
      for (int k = 0; k < cnt; ++k)
        acc += wts[k] * tmp[static_cast<size_t>(s0 + k) * out_w * 3 + x];
      int v = static_cast<int>(std::lround(acc));
      drow[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// decode + resize one file to (load, load) RGB8
bool load_resized(const char* path, int load, int filter,
                  std::vector<uint8_t>& out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_file(path, rgb, w, h)) return false;
  out.resize(static_cast<size_t>(load) * load * 3);
  resize_filtered(rgb.data(), w, h, out.data(), load, load, filter);
  return true;
}

// crop/flip/normalise an RGB8 (load, load) image into f32 [-1, 1] NHWC
void finish_into(const uint8_t* img, int load, int crop, int cx, int cy,
                 bool flip, float* out) {
  const float k = 2.0f / 255.0f;
  for (int y = 0; y < crop; ++y) {
    const uint8_t* srow = img + (static_cast<size_t>(cy + y) * load + cx) * 3;
    float* drow = out + static_cast<size_t>(y) * crop * 3;
    if (!flip) {
      for (int i = 0; i < crop * 3; ++i) drow[i] = srow[i] * k - 1.0f;
    } else {
      for (int x = 0; x < crop; ++x) {
        const uint8_t* p = srow + static_cast<size_t>(crop - 1 - x) * 3;
        drow[x * 3 + 0] = p[0] * k - 1.0f;
        drow[x * 3 + 1] = p[1] * k - 1.0f;
        drow[x * 3 + 2] = p[2] * k - 1.0f;
      }
    }
  }
}

// run fn(i) for i in [0, n) across a thread pool
template <typename F>
void parallel_for(int n, int nthreads, F fn) {
  if (nthreads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  int workers = nthreads < n ? nthreads : n;
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Decode one image and resize to (load, load) RGB8.  out must hold
// load*load*3 bytes.  Returns 0 on success, 1 on decode failure.
int cat_decode_resize(const char* path, int load, int filter,
                      unsigned char* out) {
  std::vector<uint8_t> img;
  if (!load_resized(path, load, filter, img)) return 1;
  std::memcpy(out, img.data(), img.size());
  return 0;
}

// Fetch a whole batch: for each sample i, decode paths[i], resize to
// (load, load), crop crop x crop at (crop_x[i], crop_y[i]), horizontally
// flip if flip[i], normalise to [-1, 1] f32 and write NHWC into
// out + i*crop*crop*3.  Runs across `nthreads` C++ threads (GIL-free).
// Returns 0 on success or (index of first failed sample) + 1.
int cat_fetch_batch(const char** paths, int n, int load, int crop,
                    int filter, const int* crop_x, const int* crop_y,
                    const unsigned char* flip, float* out, int nthreads) {
  std::atomic<int> failed(0);  // 0 = ok, else index+1
  parallel_for(n, nthreads, [&](int i) {
    if (failed.load(std::memory_order_relaxed)) return;
    std::vector<uint8_t> img;
    if (!load_resized(paths[i], load, filter, img)) {
      int expected = 0;
      failed.compare_exchange_strong(expected, i + 1);
      return;
    }
    finish_into(img.data(), load, crop, crop_x[i], crop_y[i], flip[i] != 0,
                out + static_cast<size_t>(i) * crop * crop * 3);
  });
  return failed.load();
}

// Fill a bank: decode + resize n images to (load, load) RGB8 stacked at
// out (n*load*load*3 bytes), across nthreads.  Used to build the
// device-resident HBM image bank (cat_tpu/data/device_data.py).
// Returns 0 or (index of first failure) + 1.
int cat_fill_bank(const char** paths, int n, int load, int filter,
                  unsigned char* out, int nthreads) {
  std::atomic<int> failed(0);
  parallel_for(n, nthreads, [&](int i) {
    if (failed.load(std::memory_order_relaxed)) return;
    std::vector<uint8_t> img;
    if (!load_resized(paths[i], load, filter, img)) {
      int expected = 0;
      failed.compare_exchange_strong(expected, i + 1);
      return;
    }
    std::memcpy(out + static_cast<size_t>(i) * load * load * 3, img.data(),
                img.size());
  });
  return failed.load();
}

}  // extern "C"
