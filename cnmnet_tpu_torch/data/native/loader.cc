// Native data-loading runtime for cnmnet_tpu_torch: a copy of
// cnmnet_tpu/data/native/loader.cc, the same code and the same C ABI.
//
// The reference's input pipeline is torch DataLoader workers doing cv2
// decode in Python processes (`train.py:51-54`); here the decode/resize/
// normalize path is C++ (libjpeg/libpng/zlib) running in native threads with
// the GIL released — the host must keep the accelerator fed, not fork workers.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment):
//   decode_jpeg_rgb      file bytes -> RGB u8
//   decode_png16         file bytes -> u16 (depth maps, mm)
//   load_rgb_normalized  path -> resized, ImageNet-normalized f32 CHW-free
//                        (HWC) buffer — decode+resize+normalize in one pass
//   load_depth_meters    path -> resized f32 depth in meters with the
//                        train-side clamp-to-zero outside [min, max]
//                        (`scannet/dataloader_batch.py:112-124`)
//   load_frames          batched: a thread pool over (rgb, depth) frames
//
// Built by data/native/__init__.py at first use:
//   g++ -O3 -march=native -shared -fPIC loader.cc -o cnmloader-<hash>.so
//       -ljpeg -lpng -lz -lpthread

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// JPEG decode (RGB, 8-bit)
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Returns 0 on success. Caller provides out sized w*h*3 after a probe call
// (out == nullptr: only fill *w / *h).
int decode_jpeg_rgb(const uint8_t* buf, long len, uint8_t* out, int* w,
                    int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  if (!out) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_start_decompress(&cinfo);
  int stride = cinfo.output_width * cinfo.output_components;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + (long)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG decode (16-bit grayscale depth)
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  long len;
  long pos;
};

static void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = reinterpret_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + (long)n > s->len) {
    png_error(png, "eof");
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

int decode_png16(const uint8_t* buf, long len, uint16_t* out, int* w,
                 int* h) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }
  PngReadState state{buf, len, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);
  if (!out) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
  }
  if (color != PNG_COLOR_TYPE_GRAY || bit_depth != 16) {
    // tolerate 8-bit gray by widening
    if (color == PNG_COLOR_TYPE_GRAY && bit_depth == 8) {
      png_set_expand_gray_1_2_4_to_8(png);
    } else {
      png_destroy_read_struct(&png, &info, nullptr);
      return 3;
    }
  }
  png_set_swap(png);  // PNG is big-endian; we want host little-endian u16
  png_read_update_info(png, info);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; y++) {
    rows[y] = reinterpret_cast<png_bytep>(out + (long)y * (*w));
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// ---------------------------------------------------------------------------
// Fused resize + normalize
// ---------------------------------------------------------------------------

// Bilinear RGB u8 -> f32 HWC with (x/255 - mean)/std, half-pixel centers
// (cv2.INTER_LINEAR parity).
void resize_normalize_rgb(const uint8_t* src, int sw, int sh, float* dst,
                          int dw, int dh, const float* mean,
                          const float* stdv) {
  const float sx = (float)sw / dw, sy = (float)sh / dh;
  const float inv255 = 1.0f / 255.0f;
  float inv_std[3] = {1.0f / stdv[0], 1.0f / stdv[1], 1.0f / stdv[2]};
  for (int y = 0; y < dh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= sh ? sh - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= sh ? sh - 1 : y0 + 1);
    const uint8_t* r0 = src + (long)y0c * sw * 3;
    const uint8_t* r1 = src + (long)y1c * sw * 3;
    float* drow = dst + (long)y * dw * 3;
    for (int x = 0; x < dw; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)floorf(fx);
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= sw ? sw - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= sw ? sw - 1 : x0 + 1);
      for (int c = 0; c < 3; c++) {
        float v00 = r0[x0c * 3 + c], v01 = r0[x1c * 3 + c];
        float v10 = r1[x0c * 3 + c], v11 = r1[x1c * 3 + c];
        float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                  wy * ((1 - wx) * v10 + wx * v11);
        drow[x * 3 + c] = (v * inv255 - mean[c]) * inv_std[c];
      }
    }
  }
}

// Bilinear RGB u8 -> u8 (uint8 wire format: the ImageNet affine runs
// in-graph on device — see ops/images.prepare_images). Same half-pixel
// sampling as resize_normalize_rgb, rounded to nearest.
void resize_rgb_u8(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
                   int dh) {
  const float sx = (float)sw / dw, sy = (float)sh / dh;
  for (int y = 0; y < dh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= sh ? sh - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= sh ? sh - 1 : y0 + 1);
    const uint8_t* r0 = src + (long)y0c * sw * 3;
    const uint8_t* r1 = src + (long)y1c * sw * 3;
    uint8_t* drow = dst + (long)y * dw * 3;
    for (int x = 0; x < dw; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)floorf(fx);
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= sw ? sw - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= sw ? sw - 1 : x0 + 1);
      for (int c = 0; c < 3; c++) {
        float v00 = r0[x0c * 3 + c], v01 = r0[x1c * 3 + c];
        float v10 = r1[x0c * 3 + c], v11 = r1[x1c * 3 + c];
        float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                  wy * ((1 - wx) * v10 + wx * v11);
        drow[x * 3 + c] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

// Nearest u16(mm) -> f32 meters with clamp-to-zero outside [dmin, dmax]
// (torch nearest parity: src[floor(y*sh/dh)]).
void resize_depth_meters(const uint16_t* src, int sw, int sh, float* dst,
                         int dw, int dh, float dmin, float dmax) {
  for (int y = 0; y < dh; y++) {
    int sy = (int)((long)y * sh / dh);
    const uint16_t* srow = src + (long)sy * sw;
    float* drow = dst + (long)y * dw;
    for (int x = 0; x < dw; x++) {
      int sx = (int)((long)x * sw / dw);
      float d = srow[sx] * 0.001f;
      drow[x] = (d < dmin || d > dmax) ? 0.0f : d;
    }
  }
}

// ---------------------------------------------------------------------------
// Whole-frame loaders
// ---------------------------------------------------------------------------

static int read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t got = fread(out->data(), 1, n, f);
  fclose(f);
  return got == (size_t)n ? 0 : 2;
}

int load_rgb_normalized(const char* path, float* dst, int dw, int dh,
                        const float* mean, const float* stdv) {
  std::vector<uint8_t> bytes;
  if (read_file(path, &bytes)) return 1;
  int w = 0, h = 0;
  if (decode_jpeg_rgb(bytes.data(), bytes.size(), nullptr, &w, &h)) return 2;
  std::vector<uint8_t> rgb((size_t)w * h * 3);
  if (decode_jpeg_rgb(bytes.data(), bytes.size(), rgb.data(), &w, &h))
    return 2;
  resize_normalize_rgb(rgb.data(), w, h, dst, dw, dh, mean, stdv);
  return 0;
}

int load_rgb_u8(const char* path, uint8_t* dst, int dw, int dh) {
  std::vector<uint8_t> bytes;
  if (read_file(path, &bytes)) return 1;
  int w = 0, h = 0;
  if (decode_jpeg_rgb(bytes.data(), bytes.size(), nullptr, &w, &h)) return 2;
  std::vector<uint8_t> rgb((size_t)w * h * 3);
  if (decode_jpeg_rgb(bytes.data(), bytes.size(), rgb.data(), &w, &h))
    return 2;
  resize_rgb_u8(rgb.data(), w, h, dst, dw, dh);
  return 0;
}

int load_depth_meters(const char* path, float* dst, int dw, int dh,
                      float dmin, float dmax) {
  std::vector<uint8_t> bytes;
  if (read_file(path, &bytes)) return 1;
  int w = 0, h = 0;
  if (decode_png16(bytes.data(), bytes.size(), nullptr, &w, &h)) return 2;
  std::vector<uint16_t> depth((size_t)w * h);
  if (decode_png16(bytes.data(), bytes.size(), depth.data(), &w, &h)) return 2;
  resize_depth_meters(depth.data(), w, h, dst, dw, dh, dmin, dmax);
  return 0;
}

// Batched frame loading over an internal thread pool. paths are
// NUL-separated; kind[i]: 0 = rgb jpeg, 1 = depth png. Outputs are
// preallocated contiguous slabs. Returns count of failed frames.
int load_frames(const char** paths, const int* kinds, int n, float* rgb_out,
                float* depth_out, int dw, int dh, const float* mean,
                const float* stdv, float dmin, float dmax, int num_threads) {
  std::vector<int> errs(n, 0);
  std::vector<std::thread> threads;
  int nt = num_threads > 0 ? num_threads : 4;
  std::vector<long> rgb_off(n, 0), dep_off(n, 0);
  long ro = 0, dp = 0;
  for (int i = 0; i < n; i++) {
    if (kinds[i] == 0) {
      rgb_off[i] = ro;
      ro += (long)dw * dh * 3;
    } else {
      dep_off[i] = dp;
      dp += (long)dw * dh;
    }
  }
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += nt) {
      if (kinds[i] == 0) {
        errs[i] =
            load_rgb_normalized(paths[i], rgb_out + rgb_off[i], dw, dh, mean,
                                stdv);
      } else {
        errs[i] = load_depth_meters(paths[i], depth_out + dep_off[i], dw, dh,
                                    dmin, dmax);
      }
    }
  };
  for (int t = 0; t < nt; t++) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  int bad = 0;
  for (int e : errs) bad += (e != 0);
  return bad;
}

}  // extern "C"
