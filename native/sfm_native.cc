// Native host-side runtime for sfm_mvs_tpu.
//
// The reference delegates all host-side heavy lifting to OpenCV's C++
// (cv2.imread at sfm.py:301, cv2.pyrDown at sfm.py:40) and writes its
// point cloud through numpy's slow text path (sfm.py:197 np.savetxt).
// This library provides the equivalent native layer for this build:
//   - JPEG/PNG decode straight to float32 grayscale / BGR planes
//     (libjpeg + libpng, no intermediate uint8 copies in Python),
//   - Gaussian-pyramid downscale (5-tap binomial + 2x decimate, matching
//     cv2.pyrDown semantics) with OpenMP across rows,
//   - PLY export with the reference's cleaning semantics (x scale,
//     centroid-distance outlier cut, blue/green/red uchar order,
//     sfm.py:169-201), ASCII or binary_little_endian.
//
// Exposed as a plain C ABI consumed via ctypes (sfm_mvs_tpu/native.py);
// every call releases the GIL, so the Python-side prefetcher overlaps
// decode with device compute.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool has_suffix(const char* path, const char* suf) {
  size_t lp = strlen(path), ls = strlen(suf);
  if (ls > lp) return false;
  for (size_t i = 0; i < ls; i++) {
    char a = path[lp - ls + i], b = suf[i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != b) return false;
  }
  return true;
}

// Decode into interleaved RGB uint8. Returns true on success.
bool decode_rgb8(const char* path, std::vector<uint8_t>* out, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  if (fread(magic, 1, 8, f) != 8) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool is_png = png_sig_cmp(magic, 0, 8) == 0;
  bool is_jpg = magic[0] == 0xFF && magic[1] == 0xD8;

  if (is_jpg || (!is_png && (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg")))) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
      jpeg_destroy_decompress(&cinfo);
      fclose(f);
      return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    *w = cinfo.output_width;
    *h = cinfo.output_height;
    out->resize(size_t(*w) * *h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* row = out->data() + size_t(cinfo.output_scanline) * *w * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return true;
  }

  if (is_png) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) {
      fclose(f);
      return false;
    }
    png_infop info = png_create_info_struct(png);
    if (!info || setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      fclose(f);
      return false;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    png_uint_32 width = png_get_image_width(png, info);
    png_uint_32 height = png_get_image_height(png, info);
    int color = png_get_color_type(png, info);
    int depth = png_get_bit_depth(png, info);
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
    png_read_update_info(png, info);
    *w = int(width);
    *h = int(height);
    out->resize(size_t(width) * height * 3);
    std::vector<png_bytep> rows(height);
    for (png_uint_32 y = 0; y < height; y++)
      rows[y] = out->data() + size_t(y) * width * 3;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return true;
  }

  fclose(f);
  return false;
}

}  // namespace

// Read just the dimensions. Returns 0 on success.
int sn_image_size(const char* path, int* h, int* w) {
  std::vector<uint8_t> buf;  // cheap enough; header-only probing adds
  return decode_rgb8(path, &buf, h, w) ? 0 : -1;  // complexity for no win here
}

// Decode to float32 grayscale in [0,1] (BT.601, matching cv2 BGR2GRAY at
// sfm.py:243). `out` must hold h*w floats (from sn_image_size). Returns 0.
int sn_decode_gray_f32(const char* path, float* out, int cap) {
  std::vector<uint8_t> rgb;
  int h, w;
  if (!decode_rgb8(path, &rgb, &h, &w)) return -1;
  if (cap < h * w) return -2;
#pragma omp parallel for
  for (int i = 0; i < h * w; i++) {
    const uint8_t* p = &rgb[size_t(i) * 3];
    out[i] = (0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2]) / 255.0f;
  }
  return 0;
}

// Decode to float32 BGR in [0,255] (the reference's color order). `out`
// must hold h*w*3 floats. Returns 0 on success.
int sn_decode_bgr_f32(const char* path, float* out, int cap) {
  std::vector<uint8_t> rgb;
  int h, w;
  if (!decode_rgb8(path, &rgb, &h, &w)) return -1;
  if (cap < h * w * 3) return -2;
#pragma omp parallel for
  for (int i = 0; i < h * w; i++) {
    const uint8_t* p = &rgb[size_t(i) * 3];
    out[i * 3 + 0] = float(p[2]);
    out[i * 3 + 1] = float(p[1]);
    out[i * 3 + 2] = float(p[0]);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Pyramid downscale (cv2.pyrDown semantics: 5-tap binomial, ceil(n/2))
// ---------------------------------------------------------------------------

void sn_pyr_down_f32(const float* in, int h, int w, float* out) {
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  const float k[5] = {1.f / 16, 4.f / 16, 6.f / 16, 4.f / 16, 1.f / 16};
  std::vector<float> tmp(size_t(h) * ow);
  // horizontal pass at even output columns
#pragma omp parallel for
  for (int y = 0; y < h; y++) {
    const float* row = in + size_t(y) * w;
    for (int x = 0; x < ow; x++) {
      float acc = 0.f;
      int cx = 2 * x;
      for (int t = -2; t <= 2; t++) {
        int xx = cx + t;
        xx = xx < 0 ? 0 : (xx >= w ? w - 1 : xx);
        acc += k[t + 2] * row[xx];
      }
      tmp[size_t(y) * ow + x] = acc;
    }
  }
  // vertical pass at even output rows
#pragma omp parallel for
  for (int y = 0; y < oh; y++) {
    for (int x = 0; x < ow; x++) {
      float acc = 0.f;
      int cy = 2 * y;
      for (int t = -2; t <= 2; t++) {
        int yy = cy + t;
        yy = yy < 0 ? 0 : (yy >= h ? h - 1 : yy);
        acc += k[t + 2] * tmp[size_t(yy) * ow + x];
      }
      out[size_t(y) * ow + x] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// PLY export (reference cleaning semantics, sfm.py:169-201)
// ---------------------------------------------------------------------------

// pts: n x 3 float; colors_bgr: n x 3 float in [0,255]. Scales by `scale`,
// drops points with centroid distance > mean + outlier_offset, writes
// blue/green/red uchar properties. Returns #vertices or <0 on error.
int sn_write_ply(const char* path, const float* pts, const float* colors_bgr,
                 int n, float scale, float outlier_offset, int binary) {
  std::vector<float> s(size_t(n) * 3);
  double mean[3] = {0, 0, 0};
  for (int i = 0; i < n * 3; i++) s[i] = pts[i] * scale;
  for (int i = 0; i < n; i++)
    for (int d = 0; d < 3; d++) mean[d] += s[size_t(i) * 3 + d];
  for (int d = 0; d < 3; d++) mean[d] /= n > 0 ? n : 1;
  std::vector<float> dist(n);
  double mean_dist = 0;
#pragma omp parallel for reduction(+ : mean_dist)
  for (int i = 0; i < n; i++) {
    double dx = s[size_t(i) * 3 + 0] - mean[0];
    double dy = s[size_t(i) * 3 + 1] - mean[1];
    double dz = s[size_t(i) * 3 + 2] - mean[2];
    dist[i] = float(std::sqrt(dx * dx + dy * dy + dz * dz));
    mean_dist += dist[i];
  }
  mean_dist /= n > 0 ? n : 1;
  const float cutoff = float(mean_dist) + outlier_offset;

  std::vector<int> keep;
  keep.reserve(n);
  for (int i = 0; i < n; i++)
    if (dist[i] < cutoff) keep.push_back(i);

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f,
          "ply\nformat %s 1.0\nelement vertex %zu\n"
          "property float x\nproperty float y\nproperty float z\n"
          "property uchar blue\nproperty uchar green\nproperty uchar red\n"
          "end_header\n",
          binary ? "binary_little_endian" : "ascii", keep.size());
  if (binary) {
    std::vector<uint8_t> rec(15);
    for (int i : keep) {
      memcpy(rec.data(), &s[size_t(i) * 3], 12);
      for (int d = 0; d < 3; d++) {
        float c = colors_bgr[size_t(i) * 3 + d];
        rec[12 + d] = uint8_t(c < 0 ? 0 : (c > 255 ? 255 : c));
      }
      fwrite(rec.data(), 1, 15, f);
    }
  } else {
    std::string buf;
    buf.reserve(keep.size() * 48);
    char line[128];
    for (int i : keep) {
      snprintf(line, sizeof(line), "%f %f %f %d %d %d\n", s[size_t(i) * 3],
               s[size_t(i) * 3 + 1], s[size_t(i) * 3 + 2],
               int(colors_bgr[size_t(i) * 3]), int(colors_bgr[size_t(i) * 3 + 1]),
               int(colors_bgr[size_t(i) * 3 + 2]));
      buf += line;
    }
    fwrite(buf.data(), 1, buf.size(), f);
  }
  fclose(f);
  return int(keep.size());
}

}  // extern "C"
