// Native data-loader core of the PyTorch port: threaded grayscale image
// decode + batch canvas packing for the BreaDM host pipeline, and the
// banded PIL-parity resize of the eval transform. The port's own copy of
// native/decoder.cpp (the JAX package's), byte-for-byte the same
// functions, so both packages decode and resize to the same bytes.
//
// The reference leans on cv2/PIL decode inside DataLoader worker processes
// (ref:my_dataset.py:151-153, ref:train.py:198-205). Here a C++
// decode/pack stage bound via ctypes (stf_unet_tpu_torch/data/
// native_loader.py) fills a fixed uint8 canvas [N, H, W] (top-left
// anchored, constant fill — the cat_list contract,
// ref:my_dataset.py:247-257) with a pthread worker pool, so the Python host
// loop never touches per-pixel work.
//
// Grayscale conversion uses ITU-R 601-2 luma (0.299/0.587/0.114), matching
// PIL convert('L') and libjpeg's own YCbCr downmix.
//
// Built at first use by native_loader.py:
//   g++ -O3 -fPIC -shared -std=c++17 decoder.cpp -ljpeg -lpng -lpthread

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to grayscale. Returns 0 on success.
int decode_jpeg_gray(FILE* fp, uint8_t* out, int max_h, int max_w,
                     int* height, int* width, long stride) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;  // libjpeg 601 luma downmix
  jpeg_start_decompress(&cinfo);
  const int h = static_cast<int>(cinfo.output_height);
  const int w = static_cast<int>(cinfo.output_width);
  if (h > max_h || w > max_w) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  *height = h;
  *width = w;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<long>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode a PNG file to grayscale (8-bit). Returns 0 on success.
int decode_png_gray(FILE* fp, uint8_t* out, int max_h, int max_w,
                    int* height, int* width, long stride) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  const int h = static_cast<int>(png_get_image_height(png, info));
  const int w = static_cast<int>(png_get_image_width(png, info));
  if (h > max_h || w > max_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  const png_byte color = png_get_color_type(png, info);
  const png_byte depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  // PIL 'L' luma: 299/587/114 per mille (fixed-point arg form).
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE) {
    png_set_rgb_to_gray_fixed(png, 1 /* silent */, 29900, 58700);
  }
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) {
    rows[y] = out + static_cast<long>(y) * stride;
  }
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  *height = h;
  *width = w;
  return 0;
}

bool has_suffix(const char* s, const char* suf) {
  const size_t ls = strlen(s), lf = strlen(suf);
  if (lf > ls) return false;
  for (size_t i = 0; i < lf; ++i) {
    char a = s[ls - lf + i], b = suf[i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != b) return false;
  }
  return true;
}

// Decode one file into a canvas slot (top-left anchored).
int decode_one(const char* path, uint8_t* slot, int canvas_h, int canvas_w,
               int* height, int* width) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  int rc;
  if (has_suffix(path, ".png")) {
    rc = decode_png_gray(fp, slot, canvas_h, canvas_w, height, width, canvas_w);
  } else {
    rc = decode_jpeg_gray(fp, slot, canvas_h, canvas_w, height, width, canvas_w);
    if (rc == -2) {  // extension lied; retry as PNG
      rewind(fp);
      rc = decode_png_gray(fp, slot, canvas_h, canvas_w, height, width, canvas_w);
    }
  }
  fclose(fp);
  return rc;
}

}  // namespace

extern "C" {

// Probe one image's (height, width) without decoding pixels.
int stf_image_size(const char* path, int* height, int* width) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  unsigned char sig[8] = {0};
  if (fread(sig, 1, 8, fp) != 8) { fclose(fp); return -2; }
  rewind(fp);
  int rc = -2;
  if (!png_sig_cmp(sig, 0, 8)) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (png && info && !setjmp(png_jmpbuf(png))) {
      png_init_io(png, fp);
      png_read_info(png, info);
      *height = static_cast<int>(png_get_image_height(png, info));
      *width = static_cast<int>(png_get_image_width(png, info));
      rc = 0;
    }
    png_destroy_read_struct(&png, &info, nullptr);
  } else {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (!setjmp(jerr.setjmp_buffer)) {
      jpeg_create_decompress(&cinfo);
      jpeg_stdio_src(&cinfo, fp);
      jpeg_read_header(&cinfo, TRUE);
      *height = static_cast<int>(cinfo.image_height);
      *width = static_cast<int>(cinfo.image_width);
      rc = 0;
    }
    jpeg_destroy_decompress(&cinfo);
  }
  fclose(fp);
  return rc;
}

// Decode `n` images into canvas [n, canvas_h, canvas_w] (pre-filled by the
// caller or filled here with `fill`), top-left anchored, with `n_threads`
// workers. sizes[2*i], sizes[2*i+1] receive each image's (h, w).
// Returns the number of successfully decoded images.
int stf_decode_batch(const char** paths, int n, uint8_t* canvas,
                     int canvas_h, int canvas_w, int* sizes,
                     uint8_t fill, int n_threads) {
  const long slot_bytes = static_cast<long>(canvas_h) * canvas_w;
  memset(canvas, fill, slot_bytes * n);
  std::atomic<int> next(0), ok(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int h = 0, w = 0;
      if (decode_one(paths[i], canvas + slot_bytes * i, canvas_h, canvas_w,
                     &h, &w) == 0) {
        sizes[2 * i] = h;
        sizes[2 * i + 1] = w;
        ok.fetch_add(1);
      } else {
        sizes[2 * i] = 0;
        sizes[2 * i + 1] = 0;
      }
    }
  };
  if (n_threads <= 1 || n <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    const int k = n_threads < n ? n_threads : n;
    pool.reserve(k);
    for (int t = 0; t < k; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return ok.load();
}

// Banded separable PIL-parity resize of `n` uint8 planes.
//
// The eval pipeline's short-edge resize must reproduce PIL's filter exactly
// (it feeds the metrics); the Python side precomputes the banded tap tables
// (idx_h/wgt_h [out_h, kh], idx_w/wgt_w [out_w, kw] — see
// stf_unet_tpu_torch/data/transforms._banded_resize_taps) and this kernel applies
// them: vertical pass into an f64 row buffer, horizontal gather pass, then
// round-half-even + clip to uint8. Accumulation is ascending-k sequential —
// the SAME floating-point order as the numpy fallback, so the two paths are
// bit-identical (pinned by tests/test_torch_native_loader.py).
//
// src [n, in_h, in_w] u8  ->  dst [n, out_h, out_w] u8.
int stf_banded_resize(const uint8_t* src, int n, int in_h, int in_w,
                      uint8_t* dst, int out_h, int out_w,
                      const int64_t* idx_h, const double* wgt_h, int kh,
                      const int64_t* idx_w, const double* wgt_w, int kw,
                      int n_threads) {
  if (n <= 0) return 0;
  const long in_plane = static_cast<long>(in_h) * in_w;
  const long out_plane = static_cast<long>(out_h) * out_w;
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<double> tmp(static_cast<size_t>(out_h) * in_w);
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      const uint8_t* plane = src + in_plane * i;
      // Vertical: tmp[o, :] = sum_k wgt_h[o,k] * src[idx_h[o,k], :]
      for (int o = 0; o < out_h; ++o) {
        double* trow = tmp.data() + static_cast<size_t>(o) * in_w;
        for (int x = 0; x < in_w; ++x) trow[x] = 0.0;
        for (int k = 0; k < kh; ++k) {
          const double w = wgt_h[static_cast<long>(o) * kh + k];
          const uint8_t* srow =
              plane + idx_h[static_cast<long>(o) * kh + k] * in_w;
          for (int x = 0; x < in_w; ++x) trow[x] += w * srow[x];
        }
      }
      // Horizontal + round-half-even (std::nearbyint under the default
      // FE_TONEAREST mode == np.round) + clip.
      uint8_t* dplane = dst + out_plane * i;
      for (int o = 0; o < out_h; ++o) {
        const double* trow = tmp.data() + static_cast<size_t>(o) * in_w;
        uint8_t* drow = dplane + static_cast<long>(o) * out_w;
        for (int p = 0; p < out_w; ++p) {
          const int64_t* ip = idx_w + static_cast<long>(p) * kw;
          const double* wp = wgt_w + static_cast<long>(p) * kw;
          double acc = 0.0;
          for (int k = 0; k < kw; ++k) acc += wp[k] * trow[ip[k]];
          const double r = std::nearbyint(acc);
          drow[p] = r < 0.0 ? 0 : (r > 255.0 ? 255 : static_cast<uint8_t>(r));
        }
      }
    }
  };
  if (n_threads <= 1 || n <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    const int k = n_threads < n ? n_threads : n;
    pool.reserve(k);
    for (int t = 0; t < k; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"
