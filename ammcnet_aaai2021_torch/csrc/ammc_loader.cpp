// Host data loader: threaded JPEG decode + resize + .flo parsing.
//
// The PyTorch port's copy of ammcnet_aaai2021_tpu/native/ammc_loader.cpp,
// with the same C ABI and semantics: RGB output, the half-pixel bilinear
// resize (cv2 INTER_LINEAR's map, float weights), the reference's flow
// channel overwrite behind bug_mode, a std::thread pool per call, and a
// nonzero code on a missing (2) or corrupt (3: JPEG; 4: bad .flo magic;
// 5: short .flo) file.
//
// C ABI (ctypes-friendly, no C++ types across the boundary):
//   ammc_version()                         -> int
//   ammc_decode_jpeg_file(path, h, w, out) -> 0 | errcode   (RGB uint8)
//   ammc_decode_video(paths, n, h, w, threads, out)         (T,h,w,3) u8
//   ammc_read_flo_header(path, &h, &w)     -> 0 | errcode
//   ammc_load_flow_video(paths, n, h, w, bug_mode, threads, out) (T,h,w,2) f32
//
// The JPEG half needs libjpeg and is compiled only with -DAMMC_WITH_LIBJPEG:
//   g++ -O3 -march=native -ffp-contract=off -shared -fPIC -DAMMC_WITH_LIBJPEG
//       ammc_loader.cpp -o libammc_loader.so -ljpeg -lpthread
// (-ffp-contract=off: the resize's products and sums each rounded, as the
// GPU route's kernel computes them, on any CPU)
// Without it the library holds the .flo half alone (version, header, flow
// video), which needs no codec; a machine without libjpeg decodes JPEG on
// the GPU instead (jpeg_decode.cu).  ammcnet_aaai2021_torch/data/native.py
// builds both forms at first use.
//
// bug_mode=1 reproduces the reference flow-channel overwrite
// (two_stream_dataset.py:94-95: ch0 = u/h, ch1 = ch0/w); bug_mode=0 uses the
// corrected (u/w, v/h).

#include <cstddef>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#ifdef AMMC_WITH_LIBJPEG
#include <jpeglib.h>
#include <csetjmp>
#endif

namespace {

constexpr float kFloMagic = 202021.25f;

#ifdef AMMC_WITH_LIBJPEG
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}
#endif  // AMMC_WITH_LIBJPEG

// Bilinear resize, HWC, half-pixel centers (cv2 INTER_LINEAR convention so
// outputs match the python loader bit-for-bit in the common no-resize case
// and within rounding otherwise).  Column coordinates/weights precomputed
// once per image; channel count is a template constant so the inner loop
// fully unrolls and autovectorizes.
struct AxisMap {
  std::vector<int> i0, i1;
  std::vector<float> w;
  AxisMap(int src_n, int dst_n) : i0(dst_n), i1(dst_n), w(dst_n) {
    const float scale = static_cast<float>(src_n) / dst_n;
    for (int x = 0; x < dst_n; ++x) {
      float fx = (x + 0.5f) * scale - 0.5f;
      int x0 = static_cast<int>(fx >= 0 ? fx : fx - 1);
      w[x] = fx - x0;
      i0[x] = x0 < 0 ? 0 : (x0 >= src_n ? src_n - 1 : x0);
      int x1 = x0 + 1;
      i1[x] = x1 < 0 ? 0 : (x1 >= src_n ? src_n - 1 : x1);
    }
  }
};

template <typename T, int C, bool Round>
void resize_bilinear(const T* src, int sh, int sw, T* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * C * sizeof(T));
    return;
  }
  AxisMap xm(sw, dw), ym(sh, dh);
  // Two-pass: horizontal resample of the two needed source rows, then
  // vertical lerp — O(dw*C) per output row instead of 4 gathers per pixel.
  std::vector<float> row0(static_cast<size_t>(dw) * C);
  std::vector<float> row1(static_cast<size_t>(dw) * C);
  int cached0 = -1, cached1 = -1;
  auto hresample = [&](int sy, float* out_row) {
    const T* r = src + static_cast<size_t>(sy) * sw * C;
    for (int x = 0; x < dw; ++x) {
      const float wx = xm.w[x];
      const T* p0 = r + xm.i0[x] * C;
      const T* p1 = r + xm.i1[x] * C;
      for (int c = 0; c < C; ++c)
        out_row[x * C + c] = (1 - wx) * p0[c] + wx * p1[c];
    }
  };
  for (int y = 0; y < dh; ++y) {
    const int y0 = ym.i0[y], y1 = ym.i1[y];
    const float wy = ym.w[y];
    if (cached0 != y0) { hresample(y0, row0.data()); cached0 = y0; }
    if (cached1 != y1) {
      if (y1 == y0) { std::memcpy(row1.data(), row0.data(), row0.size() * 4); }
      else hresample(y1, row1.data());
      cached1 = y1;
    }
    T* d = dst + static_cast<size_t>(y) * dw * C;
    for (int i = 0; i < dw * C; ++i) {
      float v = (1 - wy) * row0[i] + wy * row1[i];
      d[i] = Round ? static_cast<T>(v + 0.5f) : static_cast<T>(v);
    }
  }
}

#ifdef AMMC_WITH_LIBJPEG
inline void resize_bilinear_u8(const uint8_t* src, int sh, int sw,
                               int /*channels==3*/, uint8_t* dst, int dh,
                               int dw) {
  resize_bilinear<uint8_t, 3, true>(src, sh, sw, dst, dh, dw);
}

#endif  // AMMC_WITH_LIBJPEG

inline void resize_bilinear_f32(const float* src, int sh, int sw,
                                int /*channels==2*/, float* dst, int dh,
                                int dw) {
  resize_bilinear<float, 2, false>(src, sh, sw, dst, dh, dw);
}

#ifdef AMMC_WITH_LIBJPEG
int decode_jpeg_impl(const char* path, int out_h, int out_w, uint8_t* out) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return 2;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fh);
    return 3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fh);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width;
  const int sh = cinfo.output_height;
  std::vector<uint8_t> buf(static_cast<size_t>(sw) * sh * 3);
  JSAMPROW row;
  while (cinfo.output_scanline < cinfo.output_height) {
    row = buf.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fh);
  resize_bilinear_u8(buf.data(), sh, sw, 3, out, out_h, out_w);
  return 0;
}
#endif  // AMMC_WITH_LIBJPEG

int read_flo_impl(const char* path, std::vector<float>& data, int* h, int* w) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return 2;
  float magic;
  int32_t iw, ih;
  if (std::fread(&magic, 4, 1, fh) != 1 || magic != kFloMagic) {
    std::fclose(fh);
    return 4;
  }
  if (std::fread(&iw, 4, 1, fh) != 1 || std::fread(&ih, 4, 1, fh) != 1) {
    std::fclose(fh);
    return 5;
  }
  data.resize(static_cast<size_t>(iw) * ih * 2);
  size_t want = data.size();
  if (std::fread(data.data(), 4, want, fh) != want) {
    std::fclose(fh);
    return 5;
  }
  std::fclose(fh);
  *h = ih;
  *w = iw;
  return 0;
}

// Parallel-for over items with a transient thread pool.
template <typename Fn>
int parallel_for(int n, int n_threads, Fn&& fn) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), err(0);
  auto worker = [&] {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      int rc = fn(i);
      if (rc != 0) err.store(rc);
    }
  };
  std::vector<std::thread> threads;
  int spawn = n_threads < n ? n_threads : n;
  for (int t = 1; t < spawn; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return err.load();
}

}  // namespace

extern "C" {

int ammc_version() { return 1; }

#ifdef AMMC_WITH_LIBJPEG
int ammc_decode_jpeg_file(const char* path, int out_h, int out_w,
                          uint8_t* out) {
  return decode_jpeg_impl(path, out_h, out_w, out);
}

int ammc_decode_video(const char** paths, int n, int out_h, int out_w,
                      int n_threads, uint8_t* out) {
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  return parallel_for(n, n_threads, [&](int i) {
    return decode_jpeg_impl(paths[i], out_h, out_w, out + stride * i);
  });
}
#endif  // AMMC_WITH_LIBJPEG

int ammc_read_flo_header(const char* path, int* h, int* w) {
  std::vector<float> data;
  return read_flo_impl(path, data, h, w);
}

int ammc_load_flow_video(const char** paths, int n, int out_h, int out_w,
                         int bug_mode, int n_threads, float* out) {
  const size_t stride = static_cast<size_t>(out_h) * out_w * 2;
  return parallel_for(n, n_threads, [&](int i) {
    std::vector<float> raw;
    int sh, sw;
    int rc = read_flo_impl(paths[i], raw, &sh, &sw);
    if (rc != 0) return rc;
    float* dst = out + stride * i;
    resize_bilinear_f32(raw.data(), sh, sw, 2, dst, out_h, out_w);
    const float inv_h = 1.0f / out_h, inv_w = 1.0f / out_w;
    const size_t pixels = static_cast<size_t>(out_h) * out_w;
    if (bug_mode) {
      for (size_t p = 0; p < pixels; ++p) {
        float u = dst[p * 2] * inv_h;       // ch0 = u / h
        dst[p * 2] = u;
        dst[p * 2 + 1] = u * inv_w;          // ch1 = ch0 / w
      }
    } else {
      for (size_t p = 0; p < pixels; ++p) {
        dst[p * 2] *= inv_w;                 // u / w
        dst[p * 2 + 1] *= inv_h;             // v / h
      }
    }
    return 0;
  });
}

}  // extern "C"
