// imgdec — native batched JPEG decode + resize/center-crop for the data
// plane.  The reference's host bottleneck at production batch sizes is
// python-side image decode (PIL) inside webdataset; this library decodes a
// batch of JPEG buffers in a thread pool, bilinear-resizes the short side
// to `resolution`, center-crops, and writes normalized [-1, 1] float32
// NHWC directly into the caller's arena (zero python-side copies).
//
// C ABI for ctypes (showo_tpu/data/native_image.py).  Requires libjpeg
// (present in this image); non-JPEG payloads report failure so the caller
// can fall back to PIL.

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  auto *err = reinterpret_cast<JpegErr *>(cinfo->err);
  longjmp(err->jump, 1);
}

// decode a JPEG buffer to RGB8; returns false on failure
bool decode_jpeg(const uint8_t *buf, int64_t len, std::vector<uint8_t> &rgb,
                 int &w, int &h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = on_error;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t *>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = static_cast<int>(cinfo.output_width);
  h = static_cast<int>(cinfo.output_height);
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t *row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// bilinear sample at (fx, fy) from RGB8
inline void sample_bilinear(const uint8_t *rgb, int w, int h, float fx,
                            float fy, float out[3]) {
  int x0 = static_cast<int>(fx);
  int y0 = static_cast<int>(fy);
  if (x0 < 0) x0 = 0;
  if (y0 < 0) y0 = 0;
  int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
  int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
  float ax = fx - x0, ay = fy - y0;
  const uint8_t *p00 = rgb + (static_cast<size_t>(y0) * w + x0) * 3;
  const uint8_t *p01 = rgb + (static_cast<size_t>(y0) * w + x1) * 3;
  const uint8_t *p10 = rgb + (static_cast<size_t>(y1) * w + x0) * 3;
  const uint8_t *p11 = rgb + (static_cast<size_t>(y1) * w + x1) * 3;
  for (int c = 0; c < 3; ++c) {
    float top = p00[c] * (1 - ax) + p01[c] * ax;
    float bot = p10[c] * (1 - ax) + p11[c] * ax;
    out[c] = top * (1 - ay) + bot * ay;
  }
}

// decode + short-side resize + center crop + normalize into out
bool process_one(const uint8_t *buf, int64_t len, int res, float *out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(buf, len, rgb, w, h)) return false;

  float scale = static_cast<float>(res) / (w < h ? w : h);
  float nw = w * scale, nh = h * scale;
  float left = (nw - res) / 2.0f;
  float top = (nh - res) / 2.0f;

  for (int y = 0; y < res; ++y) {
    for (int x = 0; x < res; ++x) {
      float sx = (left + x + 0.5f) / scale - 0.5f;
      float sy = (top + y + 0.5f) / scale - 0.5f;
      float px[3];
      sample_bilinear(rgb.data(), w, h, sx, sy, px);
      float *dst = out + (static_cast<size_t>(y) * res + x) * 3;
      for (int c = 0; c < 3; ++c)
        dst[c] = px[c] / 127.5f - 1.0f;
    }
  }
  return true;
}

} // namespace

extern "C" {

// Decode n JPEG buffers into out [n, res, res, 3] float32 (NHWC, [-1,1]).
// ok[i] = 1 on success, 0 on failure (caller falls back for those).
// Returns the number of successes.
int64_t imgdec_batch(const uint8_t **bufs, const int64_t *lens, int64_t n,
                     int res, float *out, uint8_t *ok, int num_threads) {
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> good{0};
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      bool r = process_one(bufs[i], lens[i], res,
                           out + i * static_cast<int64_t>(res) * res * 3);
      ok[i] = r ? 1 : 0;
      if (r) good.fetch_add(1);
    }
  };
  int nt = num_threads > 0 ? num_threads : 4;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto &t : threads) t.join();
  return good.load();
}

} // extern "C"
