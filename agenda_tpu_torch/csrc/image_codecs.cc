// PNG and JPEG decode through libpng and libjpeg: the header and decode
// entries of native/image_ops.cc, copied unchanged (ctypes-bound from
// agenda_tpu_torch/data/native_image.py). The dependency-free passes of
// that file are in image_ops.cc, so they build on a machine without these
// libraries' headers.
//
// All functions return 0 on success, negative on failure. Buffers are
// caller-allocated RGB8 (H*W*3).

#include <cstdio>  // jpeglib.h needs FILE declared first

#include <jpeglib.h>
#include <png.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// headers
// ---------------------------------------------------------------------------

static bool is_png(const uint8_t* b, int64_t n) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  return n >= 8 && std::memcmp(b, sig, 8) == 0;
}

static bool is_jpeg(const uint8_t* b, int64_t n) {
  return n >= 3 && b[0] == 0xFF && b[1] == 0xD8 && b[2] == 0xFF;
}

struct PngReadCtx {
  const uint8_t* data;
  int64_t size;
  int64_t pos;
};

static void png_mem_read(png_structp png, png_bytep out, png_size_t len) {
  PngReadCtx* c = static_cast<PngReadCtx*>(png_get_io_ptr(png));
  if (c->pos + static_cast<int64_t>(len) > c->size) {
    png_error(png, "read past end");
  }
  std::memcpy(out, c->data + c->pos, len);
  c->pos += len;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Parse width/height without a full decode.
int read_image_header(const uint8_t* bytes, int64_t n, int32_t* w, int32_t* h) {
  if (is_png(bytes, n)) {
    if (n < 24) return -1;
    // IHDR is always the first chunk: bytes 16..23 are width/height (BE).
    *w = (bytes[16] << 24) | (bytes[17] << 16) | (bytes[18] << 8) | bytes[19];
    *h = (bytes[20] << 24) | (bytes[21] << 16) | (bytes[22] << 8) | bytes[23];
    return 0;
  }
  if (is_jpeg(bytes, n)) {
    jpeg_decompress_struct cinfo;
    JpegErr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = jpeg_err_exit;
    if (setjmp(err.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return -2;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, bytes, n);
    jpeg_read_header(&cinfo, TRUE);
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  return -3;
}

// ---------------------------------------------------------------------------
// decode to RGB8
// ---------------------------------------------------------------------------

static int decode_png_rgb8(const uint8_t* bytes, int64_t n, uint8_t* out,
                           int32_t w, int32_t h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return -4;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -4;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -5;
  }
  PngReadCtx ctx{bytes, n, 0};
  png_set_read_fn(png, &ctx, png_mem_read);
  png_read_info(png, info);

  // normalize every layout to 8-bit RGB
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  if (static_cast<int32_t>(png_get_image_width(png, info)) != w ||
      static_cast<int32_t>(png_get_image_height(png, info)) != h ||
      png_get_channels(png, info) != 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -6;
  }
  std::vector<png_bytep> rows(h);
  for (int32_t y = 0; y < h; y++) rows[y] = out + static_cast<int64_t>(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

static int decode_jpeg_rgb8(const uint8_t* bytes, int64_t n, uint8_t* out,
                            int32_t w, int32_t h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -7;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, bytes, n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int32_t>(cinfo.output_width) != w ||
      static_cast<int32_t>(cinfo.output_height) != h ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -8;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<int64_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_rgb8(const uint8_t* bytes, int64_t n, uint8_t* out, int32_t w,
                int32_t h) {
  if (is_png(bytes, n)) return decode_png_rgb8(bytes, n, out, w, h);
  if (is_jpeg(bytes, n)) return decode_jpeg_rgb8(bytes, n, out, w, h);
  return -3;
}

}  // extern "C"
