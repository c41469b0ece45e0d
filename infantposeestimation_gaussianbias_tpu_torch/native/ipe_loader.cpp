// Host-side image decode for the port's input pipeline and serving entry
// points, a copy of the JAX package's native/ipe_loader.cpp.
//
// The training loader's fused decode + warp, one C call per sample:
//
//   JPEG bytes --libjpeg--> RGB rows (only the row band the crop needs;
//   decode stops at the last needed scanline) --bilinear warp--> crop
//
// with no full-image buffer and no BGR-to-RGB pass, and, in `fast` mode
// (training augmentation only), the IDCT at 1/2, 1/4 or 1/8 scale where
// the crop downsamples anyway.  ipe_decode_warp_batch runs a batch on its
// own std::thread pool.  ipe_decode_rgb decodes a whole JPEG or PNG to
// RGB (the serving entry points).  Plain C ABI, bound by ctypes in
// binding.py (every call releases the GIL); built with g++ at first use.
//
// Warp semantics: `mat` is the FORWARD 2x3 affine (source image -> crop),
// the convention of data/transforms.py::affine_matrix_np; it is inverted
// and the crop sampled bilinearly with a constant-0 border, which is
// cv2.warpAffine(INTER_LINEAR) up to cv2's 5-bit fixed-point weights.

#include <cstddef>
#include <cstdio>  // jpeglib.h needs FILE/size_t declared first

#include <jpeglib.h>
#ifdef IPE_HAVE_PNG
#include <png.h>
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
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

struct Inv23 {
  float ia, ib, ic, id, ie, if_;
  bool ok;
};

Inv23 invert(const float* m) {
  // m = [a b c; d e f], maps (x,y) -> (a x + b y + c, d x + e y + f).
  Inv23 r{};
  const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5];
  const float det = a * e - b * d;
  if (std::fabs(det) < 1e-12f) {
    r.ok = false;
    return r;
  }
  const float inv = 1.0f / det;
  r.ia = e * inv;
  r.ib = -b * inv;
  r.id = -d * inv;
  r.ie = a * inv;
  r.ic = -(r.ia * c + r.ib * f);
  r.if_ = -(r.id * c + r.ie * f);
  r.ok = true;
  return r;
}

// Source-row band [y0, y1] (inclusive, unclamped) touched by the crop:
// map the 4 crop corners through the inverse matrix, pad by 2 px for
// the bilinear footprint + float slack.
void src_row_range(const Inv23& v, int out_w, int out_h, float* y0,
                   float* y1) {
  float lo = 1e30f, hi = -1e30f;
  const float xs[2] = {0.0f, static_cast<float>(out_w - 1)};
  const float ys[2] = {0.0f, static_cast<float>(out_h - 1)};
  for (float cx : xs)
    for (float cy : ys) {
      const float sy = v.id * cx + v.ie * cy + v.if_;
      lo = std::min(lo, sy);
      hi = std::max(hi, sy);
    }
  *y0 = lo - 2.0f;
  *y1 = hi + 2.0f;
}

// Bilinear sample (constant-0 border) from an RGB row band.
// `rows` points at row `row0` of the (virtual) full image.
inline void sample(const uint8_t* rows, int row0, int rows_n, int w,
                   float sx, float sy, uint8_t* out) {
  const int x0 = static_cast<int>(std::floor(sx));
  const int y0 = static_cast<int>(std::floor(sy));
  const float fx = sx - x0, fy = sy - y0;
  const float w00 = (1 - fx) * (1 - fy), w01 = fx * (1 - fy);
  const float w10 = (1 - fx) * fy, w11 = fx * fy;
  float acc[3] = {0, 0, 0};
  for (int dy = 0; dy < 2; ++dy) {
    const int y = y0 + dy;
    const int r = y - row0;
    if (r < 0 || r >= rows_n) continue;
    const uint8_t* row = rows + static_cast<size_t>(r) * w * 3;
    for (int dx = 0; dx < 2; ++dx) {
      const int x = x0 + dx;
      if (x < 0 || x >= w) continue;
      const float wt = (dy ? (dx ? w11 : w10) : (dx ? w01 : w00));
      const uint8_t* p = row + static_cast<size_t>(x) * 3;
      acc[0] += wt * p[0];
      acc[1] += wt * p[1];
      acc[2] += wt * p[2];
    }
  }
  out[0] = static_cast<uint8_t>(std::min(255.0f, acc[0] + 0.5f));
  out[1] = static_cast<uint8_t>(std::min(255.0f, acc[1] + 0.5f));
  out[2] = static_cast<uint8_t>(std::min(255.0f, acc[2] + 0.5f));
}

// Inverse-mapped bilinear warp of an RGB row band (rows [row0,
// row0+rows_n) of a w-wide source) into `out` (out_h x out_w x 3).
// Row-wise with an interior/border split: inside the interior ox range
// every 2x2 bilinear footprint is fully in-bounds, so the hot loop is
// branchless; border columns fall back to the checked sampler.
void warp_band(const uint8_t* band0, int row0, int rows_n, int w,
               const Inv23& v, int out_w, int out_h, uint8_t* out) {
  for (int oy = 0; oy < out_h; ++oy) {
    const float bx = v.ib * oy + v.ic;
    const float by = v.ie * oy + v.if_;
    uint8_t* orow = out + static_cast<size_t>(oy) * out_w * 3;

    // Solve for the ox range where the 2x2 footprint is fully in
    // bounds: sx in [eps, w-1-eps), sy in [row0+eps, row0+rows_n-1-eps).
    // Double math + a generous eps margin so rounding can never put an
    // "interior" pixel one texel out of bounds (border pixels just take
    // the checked sampler).
    double lo = 0.0, hi = static_cast<double>(out_w);
    const double eps = 1e-2;
    auto clip = [&](double slope, double icpt, double lo_v, double hi_v) {
      // lo_v + eps <= slope*ox + icpt < hi_v - eps
      if (std::fabs(slope) < 1e-12) {
        if (icpt < lo_v + eps || icpt >= hi_v - eps) lo = 1.0, hi = 0.0;
        return;
      }
      double a = (lo_v + eps - icpt) / slope;
      double b = (hi_v - eps - icpt) / slope;
      if (slope < 0) std::swap(a, b);
      lo = std::max(lo, a);
      hi = std::min(hi, b);
    };
    clip(v.ia, bx, 0.0, static_cast<double>(w - 1));
    clip(v.id, by, static_cast<double>(row0),
         static_cast<double>(row0 + rows_n - 1));
    int ilo = 0, ihi = 0;
    if (hi >= lo) {  // non-empty interior; empty -> whole row is border
      // Clamp BEFORE the int casts: lo/hi can be huge (near-zero
      // slope), and float->int casts outside int range are UB.
      lo = std::min(std::max(lo, 0.0), static_cast<double>(out_w));
      hi = std::min(std::max(hi, 0.0), static_cast<double>(out_w - 1));
      ilo = std::min(out_w, std::max(0, static_cast<int>(std::ceil(lo))));
      ihi = std::min(out_w, static_cast<int>(std::floor(hi)) + 1);
      if (ihi < ilo) ihi = ilo;
    }

    for (int ox = 0; ox < ilo; ++ox)
      sample(band0, row0, rows_n, w, v.ia * ox + bx, v.id * ox + by,
             orow + static_cast<size_t>(ox) * 3);
    // Interior: incremental 32.32 fixed-point stepping (exact, no
    // per-pixel float->int conversion) with 15-bit blend weights —
    // intermediate quantization error < 1 intensity level.
    {
      const double S = 4294967296.0;  // 2^32
      int64_t X = llround((static_cast<double>(v.ia) * ilo + bx) * S);
      int64_t Y = llround((static_cast<double>(v.id) * ilo + by) * S);
      const int64_t dX = llround(static_cast<double>(v.ia) * S);
      const int64_t dY = llround(static_cast<double>(v.id) * S);
      const int64_t R0 = static_cast<int64_t>(row0) << 32;
      for (int ox = ilo; ox < ihi; ++ox) {
        const int x0 = static_cast<int>(X >> 32);
        const int yb = static_cast<int>((Y - R0) >> 32);  // band row
        const uint32_t fx = static_cast<uint32_t>(X >> 17) & 0x7fff;
        const uint32_t fy = static_cast<uint32_t>(Y >> 17) & 0x7fff;
        const uint32_t gx = 0x8000 - fx, gy = 0x8000 - fy;
        const uint8_t* p0 =
            band0 + (static_cast<size_t>(yb) * w + x0) * 3;
        const uint8_t* p1 = p0 + static_cast<size_t>(w) * 3;
        uint8_t* o = orow + static_cast<size_t>(ox) * 3;
        for (int c = 0; c < 3; ++c) {
          // horizontal blends at 8.15, reduced to 8.7 (15-bit) so the
          // vertical 15-bit blend fits in uint32
          const uint32_t top = (p0[c] * gx + p0[c + 3] * fx) >> 8;
          const uint32_t bot = (p1[c] * gx + p1[c + 3] * fx) >> 8;
          const uint32_t val = (top * gy + bot * fy + (1u << 21)) >> 22;
          o[c] = static_cast<uint8_t>(val > 255u ? 255u : val);
        }
        X += dX;
        Y += dY;
      }
    }
    for (int ox = ihi; ox < out_w; ++ox)
      sample(band0, row0, rows_n, w, v.ia * ox + bx, v.id * ox + by,
             orow + static_cast<size_t>(ox) * 3);
  }
}

// Status codes shared by every entry point:
//   0 ok, 1 corrupt/undecodable, 2 singular matrix, 3 unsupported
//   components, 4 image too large, 5 internal error (allocation),
//   6 PNG support not compiled in.
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
// training-aug only).
int decode_warp_one(const unsigned char* buf, long len, const float* mat,
                    int out_w, int out_h, unsigned char* out, int fast) {
  Inv23 v = invert(mat);
  if (!v.ok) return 2;  // singular matrix

  if (is_png(buf, len)) {
#ifdef IPE_HAVE_PNG
    int w = 0, h = 0;
    if (int rc = decode_png_dims(buf, len, &w, &h)) return rc;
    std::vector<uint8_t> img(static_cast<size_t>(w) * h * 3);
    if (int rc = decode_png_rgb_into(buf, len, &w, &h, img.data()))
      return rc;
    warp_band(img.data(), 0, h, w, v, out_w, out_h, out);
    return 0;
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
    return 1;  // corrupt / not a JPEG
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  if (fast) {
    // Largest 1/k (k in 2,4,8) IDCT downscale that still samples the
    // source at >= ~1 decoded px per crop px in both axes.
    const float step = std::min(std::hypot(v.ia, v.id),
                                std::hypot(v.ib, v.ie));
    int k = 1;
    while (k < 8 && step >= 2.0f * k) k *= 2;
    if (k > 1) {
      cinfo.scale_num = 8 / k;
      cinfo.scale_denom = 8;
      // Compose src->scaled (pixel-center model: xs = (x+0.5)*s - 0.5)
      // into the inverse map so the warp reads scaled coordinates.
      const float s = 1.0f / k, off = 0.5f * s - 0.5f;
      v.ia *= s; v.ib *= s; v.ic = v.ic * s + off;
      v.id *= s; v.ie *= s; v.if_ = v.if_ * s + off;
    }
  }

  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  if (static_cast<uint64_t>(w) * h > kMaxPixels) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 4;
  }
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }

  float fy0, fy1;
  src_row_range(v, out_w, out_h, &fy0, &fy1);
  const int row0 = std::max(0, static_cast<int>(std::floor(fy0)));
  const int row1 = std::min(h - 1, static_cast<int>(std::ceil(fy1)));
  if (row1 < row0) {
    // Crop entirely outside the image: constant border.
    std::memset(out, 0, static_cast<size_t>(out_w) * out_h * 3);
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }

  const int rows_n = row1 - row0 + 1;
  std::vector<uint8_t> band(static_cast<size_t>(rows_n) * w * 3);
  std::vector<uint8_t> scratch(static_cast<size_t>(w) * 3);
  while (cinfo.output_scanline <= static_cast<JDIMENSION>(row1)) {
    const int y = static_cast<int>(cinfo.output_scanline);
    uint8_t* dst = (y >= row0)
                       ? band.data() + static_cast<size_t>(y - row0) * w * 3
                       : scratch.data();
    JSAMPROW rowp = dst;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  // Early stop: skip the remaining scanlines' huffman+IDCT work.
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  warp_band(band.data(), row0, rows_n, w, v, out_w, out_h, out);
  return 0;
}

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

// Fused decode+warp over a batch.  bufs/lens: n JPEG/PNG buffers; mats: n*6
// forward src->crop affines; out: n*out_h*out_w*3 u8; statuses: n ints
// (0 = ok).  nthreads <= 0 -> hardware concurrency.  Returns the number
// of failed samples.
int ipe_decode_warp_batch(const unsigned char** bufs, const long* lens,
                          const float* mats, int n, int out_w, int out_h,
                          unsigned char* out, int* statuses, int nthreads,
                          int fast) {
  if (n <= 0) return 0;
  int t = nthreads > 0 ? nthreads
                       : static_cast<int>(std::thread::hardware_concurrency());
  t = std::max(1, std::min(t, n));
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  const size_t crop_sz = static_cast<size_t>(out_w) * out_h * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int rc;
      try {
        rc = decode_warp_one(bufs[i], lens[i], mats + 6 * i, out_w,
                             out_h, out + crop_sz * i, fast);
      } catch (...) {  // bad_alloc must not cross the FFI boundary
        rc = 5;
      }
      statuses[i] = rc;
      if (rc) failed.fetch_add(1);
    }
  };

  if (t == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(t);
    for (int i = 0; i < t; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

}  // extern "C"
