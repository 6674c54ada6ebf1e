// Native image IO of fal_net_torch: libpng/libjpeg decode and 16-bit PNG
// encode, host C++ (no device code).
//
// The port's own copy of the JAX package's native decoder (same C ABI and
// behaviour), so that fal_net_torch needs nothing of that package.  It
// replaces the host-side decode of the reference's data pipeline (torch
// DataLoader workers calling PIL, Train_Stage1_K.py:156-160) with a
// GIL-free C++ core: python hands raw file bytes in, full numpy arrays come
// out, and the batch entry fans decodes across a std::thread pool so that
// one python thread can keep every host core busy.
//
// It also keeps full bit depth for every PNG colour type: PIL downcasts
// 16-bit RGB PNGs (the KITTI optical-flow ground-truth encoding) to uint8.
//
// Plain C ABI, bound from python with ctypes (fal_net_torch/native/io.py).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// Error codes (fn_error maps them to strings).
enum {
  FN_OK = 0,
  FN_E_FORMAT = -1,     // not a PNG or JPEG
  FN_E_DECODE = -2,     // decoder reported corrupt data
  FN_E_ARG = -3,        // bad argument (null, size mismatch)
  FN_E_ENCODE = -4,     // encoder failure
  FN_E_NOMEM = -5,
};

// ---------------------------------------------------------------------------
// libjpeg plumbing: error handler that longjmps instead of exit()ing.
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// ---------------------------------------------------------------------------
// PNG memory reader.
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* buf;
  size_t len;
  size_t pos;
};

static void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "read past end of buffer");
  }
  memcpy(out, st->buf + st->pos, n);
  st->pos += n;
}

struct PngWriteState {
  std::vector<uint8_t>* out;
};

static void png_mem_write(png_structp png, png_bytep data, png_size_t n) {
  PngWriteState* st = static_cast<PngWriteState*>(png_get_io_ptr(png));
  st->out->insert(st->out->end(), data, data + n);
}

static void png_mem_flush(png_structp) {}

static bool is_png(const uint8_t* buf, size_t len) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  return len >= 8 && memcmp(buf, sig, 8) == 0;
}

static bool is_jpeg(const uint8_t* buf, size_t len) {
  return len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF;
}

// Shared PNG header setup: applies the same transform set for probe and
// decode so the probe's (h, w, channels, bitdepth) is exactly the decoded
// layout.  Transforms: palette->RGB, gray 1/2/4->8, tRNS->alpha, and
// big-endian->host for 16-bit (PNG stores network order).
static bool png_setup(png_structp png, png_infop info, PngReadState* st,
                      int* h, int* w, int* channels, int* bitdepth) {
  png_set_read_fn(png, st, png_mem_read);
  png_read_info(png, info);

  png_uint_32 width = 0, height = 0;
  int depth = 0, color = 0;
  png_get_IHDR(png, info, &width, &height, &depth, &color, nullptr, nullptr,
               nullptr);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  if (depth == 16) png_set_swap(png);
#endif
  (void)png_set_interlace_handling(png);
  png_read_update_info(png, info);

  *h = static_cast<int>(height);
  *w = static_cast<int>(width);
  *channels = png_get_channels(png, info);
  *bitdepth = png_get_bit_depth(png, info);
  return true;
}

// ---------------------------------------------------------------------------
// Public API
// ---------------------------------------------------------------------------

// Probe the encoded image: fills (h, w, channels, bitdepth) describing
// exactly what fn_decode will write.  JPEG always decodes to 8-bit, 1 or 3
// channels; PNG keeps its native depth (8 or 16) and channel count after
// palette/tRNS expansion.
int fn_probe(const uint8_t* buf, size_t len, int* h, int* w, int* channels,
             int* bitdepth) {
  if (!buf || !h || !w || !channels || !bitdepth) return FN_E_ARG;

  if (is_png(buf, len)) {
    png_structp png =
        png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return FN_E_NOMEM;
    png_infop info = png_create_info_struct(png);
    if (!info) {
      png_destroy_read_struct(&png, nullptr, nullptr);
      return FN_E_NOMEM;
    }
    if (setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      return FN_E_DECODE;
    }
    PngReadState st{buf, len, 0};
    png_setup(png, info, &st, h, w, channels, bitdepth);
    png_destroy_read_struct(&png, &info, nullptr);
    return FN_OK;
  }

  if (is_jpeg(buf, len)) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
      jpeg_destroy_decompress(&cinfo);
      return FN_E_DECODE;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
                 static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    *channels = (cinfo.num_components == 1) ? 1 : 3;  // CMYK etc. -> RGB
    *bitdepth = 8;
    jpeg_destroy_decompress(&cinfo);
    return FN_OK;
  }

  return FN_E_FORMAT;
}

// Decode into caller-allocated `out` of h*w*channels*(bitdepth/8) bytes
// (row-major, interleaved channels, 16-bit values host-endian).
int fn_decode(const uint8_t* buf, size_t len, void* out) {
  if (!buf || !out) return FN_E_ARG;

  if (is_png(buf, len)) {
    png_structp png =
        png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return FN_E_NOMEM;
    png_infop info = png_create_info_struct(png);
    if (!info) {
      png_destroy_read_struct(&png, nullptr, nullptr);
      return FN_E_NOMEM;
    }
    std::vector<png_bytep> rows;
    if (setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      return FN_E_DECODE;
    }
    PngReadState st{buf, len, 0};
    int h = 0, w = 0, c = 0, depth = 0;
    png_setup(png, info, &st, &h, &w, &c, &depth);
    const size_t stride =
        static_cast<size_t>(w) * c * (depth == 16 ? 2 : 1);
    uint8_t* dst = static_cast<uint8_t*>(out);
    rows.resize(h);
    for (int y = 0; y < h; ++y) rows[y] = dst + y * stride;
    png_read_image(png, rows.data());
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    return FN_OK;
  }

  if (is_jpeg(buf, len)) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
      jpeg_destroy_decompress(&cinfo);
      return FN_E_DECODE;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
                 static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space =
        (cinfo.num_components == 1) ? JCS_GRAYSCALE : JCS_RGB;
    jpeg_start_decompress(&cinfo);
    const size_t stride =
        static_cast<size_t>(cinfo.output_width) * cinfo.output_components;
    uint8_t* dst = static_cast<uint8_t*>(out);
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = dst + cinfo.output_scanline * stride;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return FN_OK;
  }

  return FN_E_FORMAT;
}

// Parallel batch decode: n encoded buffers -> n caller-allocated outputs
// (each sized per fn_probe).  `status[i]` receives the per-item code.
// Runs on an internal thread pool; safe to call with the GIL released.
int fn_decode_batch(int n, const uint8_t** bufs, const size_t* lens,
                    void** outs, int* status, int nthreads) {
  if (n < 0 || !bufs || !lens || !outs || !status) return FN_E_ARG;
  if (n == 0) return FN_OK;
  unsigned hw = std::thread::hardware_concurrency();
  if (nthreads <= 0) nthreads = hw ? static_cast<int>(hw) : 4;
  if (nthreads > n) nthreads = n;

  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([=]() {
      for (int i = t; i < n; i += nthreads) {
        status[i] = fn_decode(bufs[i], lens[i], outs[i]);
      }
    });
  }
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i)
    if (status[i] != FN_OK) return status[i];
  return FN_OK;
}

// Encode host-endian uint16 data (channels 1 or 3) as a 16-bit PNG — the
// KITTI ground-truth container format (disparity*256 grayscale, flow RGB).
// *out receives a malloc'd buffer to release with fn_free.
int fn_encode_png16(const uint16_t* data, int h, int w, int channels,
                    uint8_t** out, size_t* outlen) {
  if (!data || !out || !outlen || h <= 0 || w <= 0 ||
      (channels != 1 && channels != 3))
    return FN_E_ARG;

  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return FN_E_NOMEM;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    return FN_E_NOMEM;
  }
  std::vector<uint8_t> encoded;
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    return FN_E_ENCODE;
  }
  PngWriteState ws{&encoded};
  png_set_write_fn(png, &ws, png_mem_write, png_mem_flush);
  png_set_IHDR(png, info, w, h, 16,
               channels == 1 ? PNG_COLOR_TYPE_GRAY : PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  png_set_swap(png);  // host little-endian -> PNG network order
#endif
  const size_t stride = static_cast<size_t>(w) * channels * 2;
  rows.resize(h);
  for (int y = 0; y < h; ++y) {
    rows[y] = const_cast<png_bytep>(
        reinterpret_cast<const uint8_t*>(data) + y * stride);
  }
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);

  uint8_t* heap = static_cast<uint8_t*>(malloc(encoded.size()));
  if (!heap) return FN_E_NOMEM;
  memcpy(heap, encoded.data(), encoded.size());
  *out = heap;
  *outlen = encoded.size();
  return FN_OK;
}

void fn_free(void* p) { free(p); }

const char* fn_error(int code) {
  switch (code) {
    case FN_OK: return "ok";
    case FN_E_FORMAT: return "not a PNG or JPEG";
    case FN_E_DECODE: return "corrupt image data";
    case FN_E_ARG: return "bad argument";
    case FN_E_ENCODE: return "PNG encode failed";
    case FN_E_NOMEM: return "out of memory";
    default: return "unknown error";
  }
}

int fn_abi_version(void) { return 1; }

}  // extern "C"
