// Native batch image loader for the device input pipeline.
//
// The reference decodes one image at a time through PIL on the GUI thread
// (img2sgf.py:651). For batched throughput the host must keep the device
// fed: this loader decodes JPEGs with libjpeg across a pthread pool and
// writes RGB (optionally bilinearly resized) directly into a caller-owned
// [B, H, W, 3] uint8 buffer, so Python never touches per-pixel data.
//
// C API (ctypes-friendly):
//   i2s_decode_batch(paths, n, out, H, W, n_threads) -> number decoded
//     paths: array of NUL-terminated strings
//     out:   uint8 buffer of n*H*W*3 bytes (resized, aspect-ignoring like
//            a fixed-size scanner feed)
//   i2s_decode_single(path, out_buf, cap, &w, &h) -> 0 ok / -1 error
//     decodes at native size into out_buf (capacity cap bytes)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG at native size into rgb (resizable vector). Returns ok.
bool decode_native(const char* path, std::vector<uint8_t>& rgb, int* w, int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb.resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return true;
}

// Separable scaled-triangle resample (PIL BILINEAR semantics: on downscale
// the filter support grows with the scale factor, giving area-weighted
// results instead of aliased 2x2 sampling).
struct Contrib {
  int lo;
  int n;
  std::vector<float> w;  // n weights
};

void build_contribs(int src_n, int dst_n, std::vector<Contrib>& out) {
  const float scale = static_cast<float>(src_n) / dst_n;
  const float fscale = scale < 1.0f ? 1.0f : scale;
  const float support = 1.0f * fscale;  // triangle filter support = 1
  out.resize(dst_n);
  for (int i = 0; i < dst_n; ++i) {
    float centre = (i + 0.5f) * scale;
    int lo = static_cast<int>(centre - support + 0.5f);
    int hi = static_cast<int>(centre + support + 0.5f);
    if (lo < 0) lo = 0;
    if (hi > src_n) hi = src_n;
    Contrib& c = out[i];
    c.lo = lo;
    c.n = hi - lo;
    c.w.resize(c.n);
    float total = 0.0f;
    for (int k = 0; k < c.n; ++k) {
      float d = (lo + k - centre + 0.5f) / fscale;
      float wv = d < 0 ? 1.0f + d : 1.0f - d;
      if (wv < 0) wv = 0;
      c.w[k] = wv;
      total += wv;
    }
    if (total > 0)
      for (int k = 0; k < c.n; ++k) c.w[k] /= total;
  }
}

void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
                     int dh) {
  std::vector<Contrib> cx, cy;
  build_contribs(sw, dw, cx);
  build_contribs(sh, dh, cy);
  // horizontal pass into float intermediate [sh, dw, 3]
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const Contrib& c = cx[x];
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < c.n; ++k) {
        const uint8_t* px = row + (static_cast<size_t>(c.lo) + k) * 3;
        acc[0] += c.w[k] * px[0];
        acc[1] += c.w[k] * px[1];
        acc[2] += c.w[k] * px[2];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass
  for (int y = 0; y < dh; ++y) {
    const Contrib& c = cy[y];
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw * 3; ++x) {
      float acc = 0;
      for (int k = 0; k < c.n; ++k)
        acc += c.w[k] * tmp[(static_cast<size_t>(c.lo) + k) * dw * 3 + x];
      float v = acc + 0.5f;
      drow[x] = v <= 0 ? 0 : (v >= 255.0f ? 255 : static_cast<uint8_t>(v));
    }
  }
}

}  // namespace

extern "C" {

int i2s_decode_batch(const char** paths, int n, uint8_t* out, int H, int W,
                     int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  std::atomic<int> next(0), ok_count(0);
  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (!decode_native(paths[i], rgb, &w, &h)) continue;
      uint8_t* dst = out + static_cast<size_t>(i) * H * W * 3;
      resize_bilinear(rgb.data(), w, h, dst, W, H);
      ok_count.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  int nt = n_threads < n ? n_threads : n;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok_count.load();
}

int i2s_decode_single(const char* path, uint8_t* out, int64_t cap, int* w,
                      int* h) {
  std::vector<uint8_t> rgb;
  if (!decode_native(path, rgb, w, h)) return -1;
  if (static_cast<int64_t>(rgb.size()) > cap) return -2;
  std::memcpy(out, rgb.data(), rgb.size());
  return 0;
}

}  // extern "C"
