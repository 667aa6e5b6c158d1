// JPEG frames decoded on the GPU (nvJPEG) and resized by a CUDA kernel, for
// scoring raw video on a machine whose host has no libjpeg.
//
// It replaces the JPEG half of the host loader (ammc_loader.cpp, the port's
// copy of ammcnet_aaai2021_tpu/native/ammc_loader.cpp:54-119,130-163,
// 216-227): a video's frames are read from disk, decoded by nvJPEG on the
// card (a grayscale JPEG to its Y plane, a colour one to its Y, Cb and Cr
// planes), a colour frame converted to RGB by `ycc_to_rgb_kernel`, and
// resized on the card to (dh, dw) by `resize_bilinear_kernel` straight into
// the caller's device buffer, (T, dh, dw, C) u8: C = 1 when every frame is
// grayscale (cv2's decode of a grayscale JPEG is that value on all three
// channels, so the scorer broadcasts it on the card), else 3, RGB, a
// grayscale frame of a mixed video written to all three.
//
// The colour conversion is libjpeg's, which cv2 runs: "fancy" (triangle)
// upsampling of 4:2:0 or 4:2:2 chroma (jdsample.c h2v2_fancy_upsample,
// h2v1_fancy_upsample, edges replicated) and the fixed-point YCbCr -> RGB
// tables of jdcolor.c (16 fraction bits).  nvJPEG's own RGB output
// upsamples chroma otherwise, up to 31 LSB off cv2 at sharp chroma edges;
// on libjpeg's planes this kernel is bitwise libjpeg's RGB, so what remains
// is nvJPEG's IDCT rounding.  Other subsamplings are refused (code 9).
//
// The resize is the host loader's: cv2 INTER_LINEAR's half-pixel map
// (fx = (x + 0.5) * src/dst - 0.5, x0 = floor(fx), w = fx - x0, both taps
// clamped to the edge) and its float arithmetic, a horizontal lerp of the
// two source rows then a vertical lerp, rounded by +0.5 and truncation.
// Every product and sum is an IEEE-rounded __fmul_rn / __fadd_rn (no fused
// multiply-add), so the kernel is bitwise its plain PyTorch version
// (ammcnet_aaai2021_torch/data/native.py:resize_bilinear_u8_ref).
//
// What bounds both kernels on this card: bytes.  The resize reads 4 source
// pixels (cached) for each output pixel and writes a byte a channel; a
// grayscale 240x360 -> 256x256 frame moves about 0.15 MB, microseconds at
// 3.35 TB/s.  The colour kernel reads 1.5 bytes and writes 3 a pixel
// (4:2:0).  The decode (nvJPEG: Huffman on the host, the IDCT on the card)
// and the file reads take
// the time; the design is simple: one thread per output pixel, one launch
// per chunk of up to kChunkFrames frames of one source size, and one stream
// per decoder, ordered after the caller's stream by an event and before it
// by another, so the frames never leave the card.
//
// Plain C interface, built with nvcc (-lnvjpeg) into a shared library and
// bound with ctypes (ammcnet_aaai2021_torch/data/native.py).  Error codes
// are the host loader's where they mean the same: 2 a file that does not
// open, 3 a file nvJPEG cannot decode; also 6 a CUDA error, 7 an nvJPEG
// error outside a file's decode, 8 a JPEG with other than 1 or 3
// components, 9 a colour JPEG subsampled other than 4:4:4, 4:2:2 or 4:2:0.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstdio>
#include <mutex>
#include <vector>

namespace {

constexpr int kChunkFrames = 32;  // frames of one source size per resize launch

enum : int {
  kOk = 0,
  kNoFile = 2,
  kCorrupt = 3,
  kCuda = 6,
  kNvjpeg = 7,
  kComponents = 8,
  kSubsampling = 9,
};

// One axis of the half-pixel map: the two clamped source taps and the
// weight of the second, as AxisMap in ammc_loader.cpp computes them.
__device__ __forceinline__ void axis_map(int x, int src_n, int dst_n, int* i0,
                                         int* i1, float* w) {
  const float scale = __fdiv_rn(static_cast<float>(src_n),
                                static_cast<float>(dst_n));
  const float fx =
      __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), scale), 0.5f);
  const int x0 = static_cast<int>(fx >= 0.f ? fx : __fsub_rn(fx, 1.f));
  *w = __fsub_rn(fx, static_cast<float>(x0));
  *i0 = min(max(x0, 0), src_n - 1);
  *i1 = min(max(x0 + 1, 0), src_n - 1);
}

__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, w), a), __fmul_rn(w, b));
}

// (n, sh, sw, sc) u8 -> (n, dh, dw, dc) u8, dc = sc or (sc, dc) = (1, 3), a
// gray source on all three; thread (x, y) of frame blockIdx.z writes one
// output pixel's dc channels.
__global__ void resize_bilinear_kernel(const uint8_t* __restrict__ src, int sh,
                                       int sw, int sc,
                                       uint8_t* __restrict__ dst, int dh,
                                       int dw, int dc) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= dw || y >= dh) return;
  int x0, x1, y0, y1;
  float wx, wy;
  axis_map(x, sw, dw, &x0, &x1, &wx);
  axis_map(y, sh, dh, &y0, &y1, &wy);
  const int64_t frame = blockIdx.z;
  const uint8_t* s = src + frame * sh * sw * sc;
  const uint8_t* r0 = s + static_cast<int64_t>(y0) * sw * sc;
  const uint8_t* r1 = s + static_cast<int64_t>(y1) * sw * sc;
  uint8_t* d = dst + ((frame * dh + y) * dw + x) * dc;
  for (int c = 0; c < dc; ++c) {
    const int cc = sc == 1 ? 0 : c;
    const float h0 = lerp(r0[x0 * sc + cc], r0[x1 * sc + cc], wx);
    const float h1 = lerp(r1[x0 * sc + cc], r1[x1 * sc + cc], wx);
    d[c] = static_cast<uint8_t>(__float2uint_rz(__fadd_rn(lerp(h0, h1, wy),
                                                          0.5f)));
  }
}

// One chroma plane (ch, cw) at full-resolution pixel (y, x), upsampled as
// libjpeg does: (hs, vs) = (2, 2) h2v2 fancy, (2, 1) h2v1 fancy, (1, 1) as
// it is.  Out-of-range neighbours are the edge's own samples.
__device__ __forceinline__ int upsample(const uint8_t* c, int pitch, int ch,
                                        int cw, int hs, int vs, int y, int x) {
  if (hs == 1) return c[y * pitch + x];
  const int col = x >> 1;
  const bool odd = x & 1;
  const int nb = odd ? min(col + 1, cw - 1) : max(col - 1, 0);
  if (vs == 1) {
    const uint8_t* row = c + y * pitch;
    return (3 * row[col] + row[nb] + (odd ? 2 : 1)) >> 2;
  }
  const int r = y >> 1;
  const int far = (y & 1) ? min(r + 1, ch - 1) : max(r - 1, 0);
  const uint8_t* near_row = c + r * pitch;
  const uint8_t* far_row = c + far * pitch;
  const int this_sum = 3 * near_row[col] + far_row[col];
  const int nb_sum = 3 * near_row[nb] + far_row[nb];
  return (3 * this_sum + nb_sum + (odd ? 7 : 8)) >> 4;
}

// Y (h, w) and Cb, Cr (ch, cw) planes -> (h, w, 3) u8 RGB, libjpeg's
// upsampling and jdcolor.c's tables (FIX(1.40200) = 91881, FIX(1.77200) =
// 116130, FIX(0.71414) = 46802, FIX(0.34414) = 22554, ONE_HALF = 32768).
__global__ void ycc_to_rgb_kernel(const uint8_t* __restrict__ yp, int ypitch,
                                  const uint8_t* __restrict__ cb,
                                  const uint8_t* __restrict__ cr, int cpitch,
                                  int h, int w, int ch, int cw, int hs, int vs,
                                  uint8_t* __restrict__ rgb) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int luma = yp[y * ypitch + x];
  const int b = upsample(cb, cpitch, ch, cw, hs, vs, y, x) - 128;
  const int r = upsample(cr, cpitch, ch, cw, hs, vs, y, x) - 128;
  const int red = luma + ((91881 * r + 32768) >> 16);
  const int green = luma + ((-22554 * b + 32768 - 46802 * r) >> 16);
  const int blue = luma + ((116130 * b + 32768) >> 16);
  uint8_t* d = rgb + (static_cast<int64_t>(y) * w + x) * 3;
  d[0] = static_cast<uint8_t>(min(max(red, 0), 255));
  d[1] = static_cast<uint8_t>(min(max(green, 0), 255));
  d[2] = static_cast<uint8_t>(min(max(blue, 0), 255));
}

cudaError_t launch_ycc(const uint8_t* y, int ypitch, const uint8_t* cb,
                       const uint8_t* cr, int cpitch, int h, int w, int ch,
                       int cw, int hs, int vs, uint8_t* rgb,
                       cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  ycc_to_rgb_kernel<<<grid, block, 0, stream>>>(y, ypitch, cb, cr, cpitch, h,
                                                w, ch, cw, hs, vs, rgb);
  return cudaGetLastError();
}

cudaError_t launch_resize(const uint8_t* src, int n, int sh, int sw, int sc,
                          uint8_t* dst, int dh, int dw, int dc,
                          cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((dw + 31) / 32, (dh + 7) / 8, n);
  resize_bilinear_kernel<<<grid, block, 0, stream>>>(src, sh, sw, sc, dst, dh,
                                                     dw, dc);
  return cudaGetLastError();
}

struct Decoder {
  int device = 0;
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  cudaEvent_t ready = nullptr;  // the caller's stream, at the call
  cudaEvent_t done = nullptr;   // this stream, at the call's last launch
  uint8_t* staging = nullptr;  // a chunk's decoded frames, source size
  size_t staging_bytes = 0;
  uint8_t* planes = nullptr;  // a colour frame's Y, Cb and Cr planes
  size_t planes_bytes = 0;
  std::mutex mu;  // one call at a time per decoder
};

// Grow a device buffer on the decoder's stream (stream-ordered, so no
// device-wide synchronisation).
cudaError_t reserve(Decoder* dec, uint8_t** buf, size_t* have, size_t want) {
  if (*have >= want) return cudaSuccess;
  cudaError_t err = cudaSuccess;
  if (*buf != nullptr) err = cudaFreeAsync(*buf, dec->stream);
  if (err != cudaSuccess) return err;
  *buf = nullptr;
  *have = 0;
  err = cudaMallocAsync(reinterpret_cast<void**>(buf), want, dec->stream);
  if (err == cudaSuccess) *have = want;
  return err;
}

int read_file(const char* path, std::vector<unsigned char>* data) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return kNoFile;
  std::fseek(fh, 0, SEEK_END);
  const long size = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  if (size <= 0) {
    std::fclose(fh);
    return kCorrupt;
  }
  data->resize(static_cast<size_t>(size));
  const size_t got = std::fread(data->data(), 1, data->size(), fh);
  std::fclose(fh);
  return got == data->size() ? kOk : kCorrupt;
}

// Resize the chunk's `count` frames into `out`, (count, dh, dw, dc) on the
// card.  sc is the staged frames' channels: 1 (gray) or 3 (RGB).
int flush(Decoder* dec, int count, int sh, int sw, int sc, int dh, int dw,
          int dc, uint8_t* out, int* launches) {
  if (count == 0) return kOk;
  if (launch_resize(dec->staging, count, sh, sw, sc, out, dh, dw, dc,
                    dec->stream) != cudaSuccess) {
    return kCuda;
  }
  ++*launches;
  return kOk;
}

// (hs, vs) of a colour JPEG's chroma, or false for a subsampling the
// colour kernel does not take.
bool chroma_factors(nvjpegChromaSubsampling_t s, int* hs, int* vs) {
  switch (s) {
    case NVJPEG_CSS_444: *hs = 1; *vs = 1; return true;
    case NVJPEG_CSS_422: *hs = 2; *vs = 1; return true;
    case NVJPEG_CSS_420: *hs = 2; *vs = 2; return true;
    default: return false;
  }
}

// Decode one frame into `slot` as (sh, sw, sc) u8: a gray JPEG's Y plane,
// or a colour JPEG's planes converted to RGB.
int decode_frame(Decoder* dec, const std::vector<unsigned char>& data,
                 int comps, nvjpegChromaSubsampling_t subsampling,
                 const int* widths, const int* heights, uint8_t* slot,
                 int* ycc_launches) {
  nvjpegImage_t image = {};
  if (comps == 1) {
    image.channel[0] = slot;
    image.pitch[0] = widths[0];
    if (nvjpegDecode(dec->handle, dec->state, data.data(), data.size(),
                     NVJPEG_OUTPUT_Y, &image, dec->stream) !=
        NVJPEG_STATUS_SUCCESS) {
      return kCorrupt;
    }
    return kOk;
  }
  int hs = 1, vs = 1;
  if (!chroma_factors(subsampling, &hs, &vs)) return kSubsampling;
  const int w = widths[0], h = heights[0], cw = widths[1], ch = heights[1];
  if (cw != (w + hs - 1) / hs || ch != (h + vs - 1) / vs ||
      widths[2] != cw || heights[2] != ch) {
    return kSubsampling;
  }
  const size_t luma = static_cast<size_t>(w) * h;
  const size_t chroma = static_cast<size_t>(cw) * ch;
  if (reserve(dec, &dec->planes, &dec->planes_bytes, luma + 2 * chroma) !=
      cudaSuccess) {
    return kCuda;
  }
  for (int c = 0; c < 3; ++c) {
    image.channel[c] = dec->planes + (c == 0 ? 0 : luma + (c - 1) * chroma);
    image.pitch[c] = c == 0 ? w : cw;
  }
  if (nvjpegDecode(dec->handle, dec->state, data.data(), data.size(),
                   NVJPEG_OUTPUT_YUV, &image, dec->stream) !=
      NVJPEG_STATUS_SUCCESS) {
    return kCorrupt;
  }
  if (launch_ycc(image.channel[0], w, image.channel[1], image.channel[2], cw,
                 h, w, ch, cw, hs, vs, slot, dec->stream) != cudaSuccess) {
    return kCuda;
  }
  ++*ycc_launches;
  return kOk;
}

struct Frame {
  std::vector<unsigned char> data;
  int comps = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
};

// Every file read and its header parsed, so the output's channels are known
// before the first write and no file fails after one.
int read_frames(Decoder* dec, const char** paths, int n,
                std::vector<Frame>* frames) {
  frames->resize(n);
  for (int i = 0; i < n; ++i) {
    Frame& f = (*frames)[i];
    const int rc = read_file(paths[i], &f.data);
    if (rc != kOk) return rc;
    if (nvjpegGetImageInfo(dec->handle, f.data.data(), f.data.size(), &f.comps,
                           &f.subsampling, f.widths, f.heights) !=
        NVJPEG_STATUS_SUCCESS) {
      return kCorrupt;
    }
    if (f.comps != 1 && f.comps != 3) return kComponents;
  }
  return kOk;
}

int decode_frames(Decoder* dec, const std::vector<Frame>& frames, int dh,
                  int dw, int dc, uint8_t* out, int* launches,
                  int* ycc_launches) {
  const size_t frame_out = static_cast<size_t>(dh) * dw * dc;
  const int n = static_cast<int>(frames.size());
  int count = 0, first = 0, sh = 0, sw = 0, sc = 0;
  for (int i = 0; i < n; ++i) {
    const Frame& f = frames[i];
    if (count > 0 && (f.widths[0] != sw || f.heights[0] != sh ||
                      f.comps != sc || count == kChunkFrames)) {
      const int rc = flush(dec, count, sh, sw, sc, dh, dw, dc,
                           out + frame_out * first, launches);
      if (rc != kOk) return rc;
      first = i;
      count = 0;
    }
    sw = f.widths[0];
    sh = f.heights[0];
    sc = f.comps;
    const size_t frame_in = static_cast<size_t>(sh) * sw * sc;
    if (count == 0 &&
        reserve(dec, &dec->staging, &dec->staging_bytes,
                frame_in * kChunkFrames) != cudaSuccess) {
      return kCuda;
    }
    const int rc = decode_frame(dec, f.data, f.comps, f.subsampling, f.widths,
                                f.heights, dec->staging + frame_in * count,
                                ycc_launches);
    if (rc != kOk) return rc;
    // nvJPEG's state (its pinned and device buffers) serves the next frame,
    // whose host phase must not overwrite what this frame's device phase
    // still reads
    if (cudaStreamSynchronize(dec->stream) != cudaSuccess) return kCuda;
    ++count;
  }
  return flush(dec, count, sh, sw, sc, dh, dw, dc, out + frame_out * first,
               launches);
}

int decode_video(Decoder* dec, const char** paths, int n, int dh, int dw,
                 uint8_t* out, cudaStream_t caller, int* channels,
                 int* launches, int* ycc_launches) {
  if (cudaSetDevice(dec->device) != cudaSuccess) return kCuda;
  std::vector<Frame> frames;
  int rc = read_frames(dec, paths, n, &frames);
  if (rc != kOk) return rc;
  int dc = 1;
  for (const Frame& f : frames) dc = f.comps == 3 ? 3 : dc;
  *channels = dc;
  // `out` may still be in use by work queued on the caller's stream
  if (cudaEventRecord(dec->ready, caller) != cudaSuccess ||
      cudaStreamWaitEvent(dec->stream, dec->ready, 0) != cudaSuccess) {
    return kCuda;
  }
  rc = decode_frames(dec, frames, dh, dw, dc, out, launches, ycc_launches);
  if (rc != kOk) {
    // nothing of this call writes `out` once it has returned
    cudaStreamSynchronize(dec->stream);
    return rc;
  }
  if (cudaEventRecord(dec->done, dec->stream) != cudaSuccess ||
      cudaStreamWaitEvent(caller, dec->done, 0) != cudaSuccess) {
    return kCuda;
  }
  return kOk;
}

}  // namespace

extern "C" {

const char* ammc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// A decoder on `device`: an nvJPEG handle and state and a stream of its own.
// It lives as long as the process (the binding keeps one per device).
int ammc_jpeg_decoder_create(int device, void** out) {
  if (cudaSetDevice(device) != cudaSuccess) return kCuda;
  auto* dec = new Decoder;
  dec->device = device;
  if (nvjpegCreateSimple(&dec->handle) != NVJPEG_STATUS_SUCCESS ||
      nvjpegJpegStateCreate(dec->handle, &dec->state) !=
          NVJPEG_STATUS_SUCCESS) {
    delete dec;
    return kNvjpeg;
  }
  if (cudaStreamCreateWithFlags(&dec->stream, cudaStreamNonBlocking) !=
          cudaSuccess ||
      cudaEventCreateWithFlags(&dec->ready, cudaEventDisableTiming) !=
          cudaSuccess ||
      cudaEventCreateWithFlags(&dec->done, cudaEventDisableTiming) !=
          cudaSuccess) {
    if (dec->ready != nullptr) cudaEventDestroy(dec->ready);
    if (dec->stream != nullptr) cudaStreamDestroy(dec->stream);
    nvjpegJpegStateDestroy(dec->state);
    nvjpegDestroy(dec->handle);
    delete dec;
    return kCuda;
  }
  *out = dec;
  return kOk;
}

// JPEG files -> out, a device buffer of n * out_h * out_w * 3 bytes, which
// gets (n, out_h, out_w, *channels) u8: *channels 1 when every frame is
// grayscale, else 3 (RGB).  The decode waits for the work queued on
// `stream` (the caller's) so far, and `stream` waits for the decode.
// *launches and *ycc_launches get the resize and the colour kernel's
// launches.  Returns 0 or an error code (above).
int ammc_gpu_decode_video(void* handle, const char** paths, int n, int out_h,
                          int out_w, void* out, void* stream, int* channels,
                          int* launches, int* ycc_launches) {
  auto* dec = static_cast<Decoder*>(handle);
  std::lock_guard<std::mutex> lock(dec->mu);
  *channels = 0;
  *launches = 0;
  *ycc_launches = 0;
  return decode_video(dec, paths, n, out_h, out_w, static_cast<uint8_t*>(out),
                      static_cast<cudaStream_t>(stream), channels, launches,
                      ycc_launches);
}

// The colour kernel alone on device buffers: y (h, w), cb and cr (ch, cw)
// u8, contiguous, (hs, vs) the chroma factors; rgb (h, w, 3) u8; on the
// caller's stream.  Returns a cudaError_t.
int ammc_ycc_to_rgb(const void* y, const void* cb, const void* cr, int h,
                    int w, int ch, int cw, int hs, int vs, void* rgb,
                    void* stream) {
  return launch_ycc(static_cast<const uint8_t*>(y), w,
                    static_cast<const uint8_t*>(cb),
                    static_cast<const uint8_t*>(cr), cw, h, w, ch, cw, hs, vs,
                    static_cast<uint8_t*>(rgb),
                    static_cast<cudaStream_t>(stream));
}

// The resize kernel alone on device buffers: src (n, sh, sw, c) u8 with c
// in {1, 3}, dst (n, dh, dw, c) u8, on the caller's stream.  Returns a
// cudaError_t.
int ammc_resize_bilinear_u8(const void* src, int n, int sh, int sw, int c,
                            void* dst, int dh, int dw, void* stream) {
  return launch_resize(static_cast<const uint8_t*>(src), n, sh, sw, c,
                       static_cast<uint8_t*>(dst), dh, dw, c,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
