// Host-side image decode for the serving entry points: JPEG (libjpeg) and
// PNG (libpng, optional) bytes straight to tightly packed RGB uint8, in
// one pass and without cv2's BGR-to-RGB copy.
//
// A copy of the decode half of the JAX package's native/ipe_loader.cpp
// (its fused decode + warp for the training loader is not needed by the
// port yet).  Plain C ABI, bound by ctypes in binding.py; built with g++
// at first use.
//
// Status codes of every entry point: 0 ok, 1 corrupt/undecodable,
// 3 unsupported components, 4 image too large, 5 internal error
// (allocation), 6 PNG support not compiled in.

#include <cstddef>
#include <cstdio>  // jpeglib.h needs FILE/size_t declared first

#include <jpeglib.h>
#ifdef IPE_HAVE_PNG
#include <png.h>
#endif

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void err_emit(j_common_ptr, int) {}  // swallow warnings

constexpr uint64_t kMaxPixels = 1ull << 30;  // match cv2's decode guard

bool is_png(const unsigned char* buf, long len) {
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G',
                                       0x0d, 0x0a, 0x1a, 0x0a};
  return len >= 8 && std::memcmp(buf, sig, 8) == 0;
}

#ifdef IPE_HAVE_PNG
// Decode a PNG to tightly-packed RGB u8 written into `out` (sized
// w*h*3 by the caller via strip_into, or grown when out is a vector).
// Alpha is STRIPPED, not composited — matching cv2.imdecode's
// IMREAD_COLOR behavior so the native and fallback paths agree on RGBA
// inputs.  Returns a status code.
int decode_png_dims(const unsigned char* buf, long len, int* w, int* h) {
  png_image im;
  std::memset(&im, 0, sizeof(im));
  im.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&im, buf,
                                        static_cast<size_t>(len)))
    return 1;
  *w = static_cast<int>(im.width);
  *h = static_cast<int>(im.height);
  png_image_free(&im);
  return (static_cast<uint64_t>(im.width) * im.height > kMaxPixels) ? 4
                                                                    : 0;
}

int decode_png_rgb_into(const unsigned char* buf, long len, int* w,
                        int* h, unsigned char* out) {
  png_image im;
  std::memset(&im, 0, sizeof(im));
  im.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&im, buf,
                                        static_cast<size_t>(len)))
    return 1;
  if (static_cast<uint64_t>(im.width) * im.height > kMaxPixels) {
    png_image_free(&im);
    return 4;
  }
  *w = static_cast<int>(im.width);
  *h = static_cast<int>(im.height);
  const size_t n = static_cast<size_t>(*w) * *h;
  im.format = PNG_FORMAT_RGBA;
  std::vector<uint8_t> rgba(n * 4);
  if (!png_image_finish_read(&im, nullptr, rgba.data(), 0, nullptr))
    return 1;  // finish_read frees im on error
  for (size_t i = 0; i < n; ++i) {  // strip alpha (cv2 IMREAD_COLOR)
    out[i * 3 + 0] = rgba[i * 4 + 0];
    out[i * 3 + 1] = rgba[i * 4 + 1];
    out[i * 3 + 2] = rgba[i * 4 + 2];
  }
  return 0;
}
#endif  // IPE_HAVE_PNG

// Decode one JPEG/PNG and warp it into `out` (out_h x out_w x 3, RGB
// u8).  Returns 0 on success.  `fast` enables DCT-domain downscaled
// decode (JPEG only; numerically different low-pass resampling;

}  // namespace

extern "C" {

int ipe_version() { return 2; }

// Whether PNG support was compiled in (libpng present at build time).
int ipe_has_png() {
#ifdef IPE_HAVE_PNG
  return 1;
#else
  return 0;
#endif
}

// Header-only dimension read (JPEG or PNG).  Returns a status code.
int ipe_image_dims(const unsigned char* buf, long len, int* w, int* h) {
  if (is_png(buf, len)) {
#ifdef IPE_HAVE_PNG
    return decode_png_dims(buf, len, w, h);
#else
    return 6;
#endif
  }
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = err_emit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return (static_cast<uint64_t>(*w) * *h > kMaxPixels) ? 4 : 0;
}

// Full decode (JPEG or PNG) to tightly-packed RGB u8 (caller sizes
// `out` from ipe_image_dims).  Returns a status code.
int ipe_decode_rgb(const unsigned char* buf, long len, unsigned char* out) {
  if (is_png(buf, len)) {
#ifdef IPE_HAVE_PNG
    int w = 0, h = 0;
    try {
      return decode_png_rgb_into(buf, len, &w, &h, out);
    } catch (...) {  // bad_alloc must not cross the FFI boundary
      return 5;
    }
#else
    return 6;
#endif
  }
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = err_emit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  const size_t stride = static_cast<size_t>(cinfo.output_width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW rowp = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
}  // extern "C"
