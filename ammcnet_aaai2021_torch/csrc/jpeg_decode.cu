// JPEG frames decoded as libjpeg decodes them, on the GPU, and resized by
// a CUDA kernel, for scoring raw video on a machine whose host has no
// libjpeg.
//
// It replaces the JPEG half of the host loader (ammc_loader.cpp, the port's
// copy of ammcnet_aaai2021_tpu/native/ammc_loader.cpp:54-119,130-163,
// 216-227) and gives its bytes: a video's frames are read from disk and
// entropy-decoded to quantized DCT coefficients on the host's threads
// (jpeg_huffman.cpp, included below: the port's own Huffman decode, since
// no library on the card's machine hands out coefficients), a chunk of up
// to kChunkFrames frames at a time into pinned memory, copied to the card
// in one transfer, dequantized and inverse-transformed there by
// `idct_islow_kernel` (libjpeg's accurate integer IDCT), a colour frame's
// planes converted to RGB by `ycc_to_rgb_kernel`, and the chunk resized to
// (dh, dw) by `resize_bilinear_kernel` straight into the caller's device
// buffer, (T, dh, dw, C) u8: C = 1 when every frame is grayscale (cv2's
// decode of a grayscale JPEG is that value on all three channels, so the
// scorer broadcasts it on the card), else 3, RGB, a grayscale frame of a
// mixed video written to all three.  While the card works on one chunk
// the host decodes the next into the other of two pinned buffers.
//
// The IDCT is jidctint.c's jpeg_idct_islow (libjpeg-turbo 2.1.5,
// JPEG_LIB_VERSION 62, which cv2 and the host loader run): dequantize,
// a column pass with CONST_BITS 13 and PASS1_BITS 2 and its DESCALE
// rounding, a row pass descaled by CONST_BITS + PASS1_BITS + 3, and the
// range limit of jdmaster.c (index `x & 1023` into the post-IDCT table: x
// + 128 clamped for -512 <= x < 512, wrapping beyond).  libjpeg's zero-AC
// shortcuts give the same values as its full path (the DC term alone
// descales to the same number), so the kernel always takes the full path.
// Products of a valid 8-bit JPEG's dequantized coefficients stay within
// 32 bits, as in libjpeg's SIMD build.  With libjpeg's planes, the colour
// conversion below is libjpeg's (fancy upsampling, the jdcolor.c tables),
// so a frame is bitwise the host route's; the plain version of each kernel
// sits in ammcnet_aaai2021_torch/data/native.py.
//
// The colour conversion is libjpeg's, which cv2 runs: "fancy" (triangle)
// upsampling of 4:2:0 or 4:2:2 chroma (jdsample.c h2v2_fancy_upsample,
// h2v1_fancy_upsample, edges replicated) and the fixed-point YCbCr -> RGB
// tables of jdcolor.c (16 fraction bits).  Other subsamplings are refused
// (code 9).
//
// The resize is the host loader's: cv2 INTER_LINEAR's half-pixel map
// (fx = (x + 0.5) * src/dst - 0.5, x0 = floor(fx), w = fx - x0, both taps
// clamped to the edge) and its float arithmetic, a horizontal lerp of the
// two source rows then a vertical lerp, rounded by +0.5 and truncation.
// Every product and sum is an IEEE-rounded __fmul_rn / __fadd_rn (no fused
// multiply-add; the host library is built with -ffp-contract=off), so the
// kernel is bitwise the host route and its plain PyTorch version
// (ammcnet_aaai2021_torch/data/native.py:resize_bilinear_u8_ref).
//
// What bounds the kernels on this card: bytes.  The IDCT reads 2 bytes a
// coefficient and writes 1 a pixel, with about 40 integer operations a
// pixel; the resize reads 4 source pixels (cached) for each output pixel
// and writes a byte a channel; the colour kernel reads 1.5 bytes and
// writes 3 a pixel (4:2:0).  A grayscale 240x360 frame moves about 0.2 MB
// in all, microseconds at 3.35 TB/s; the host's Huffman decode and file
// reads take the time.  The design is simple: 8 threads an 8x8 block in
// the IDCT (a column each, then a row each, through shared memory), one
// thread an output pixel in the others, one IDCT launch per chunk and
// component, one resize launch per chunk, one colour launch per colour
// frame, and one stream per decoder, ordered after the caller's stream by
// an event and before it by another, so the frames never leave the card.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes (ammcnet_aaai2021_torch/data/native.py).  Error codes are the
// host loader's and jpeg_huffman.cpp's: 2 a file that does not open, 3
// corrupt data, 8 a JPEG with other than 1 or 3 components, 10-14 a JPEG
// the Huffman decode does not take (progressive, lossless or hierarchical,
// arithmetic-coded, not 8-bit, not YCbCr); also 6 a CUDA error, 9 a colour
// JPEG subsampled other than 4:4:4, 4:2:2 or 4:2:0.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <mutex>
#include <vector>

#include "jpeg_huffman.cpp"

namespace {

constexpr int kChunkFrames = 32;  // frames of one geometry a chunk

enum : int {
  kOk = 0,
  kCuda = 6,
  kSubsampling = 9,
};

// jidctint.c's constants: CONST_BITS, PASS1_BITS and FIX(c) = c * 2^13
constexpr int kConstBits = 13, kPass1Bits = 2;

// The butterfly of jidctint.c on 8 inputs along one axis (dequantized in
// the column pass): the 8 outputs before their DESCALE.
__device__ __forceinline__ void idct_1d(const int d[8], int o[8]) {
  int z1 = (d[2] + d[6]) * 4433;                 // FIX_0_541196100
  const int tmp2 = z1 + d[6] * -15137;           // FIX_1_847759065
  const int tmp3 = z1 + d[2] * 6270;             // FIX_0_765366865
  const int tmp0 = (d[0] + d[4]) * (1 << kConstBits);
  const int tmp1 = (d[0] - d[4]) * (1 << kConstBits);
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int t0 = d[7], t1 = d[5], t2 = d[3], t3 = d[1];
  z1 = t0 + t3;
  int z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const int z5 = (z3 + z4) * 9633;               // FIX_1_175875602
  t0 *= 2446;                                    // FIX_0_298631336
  t1 *= 16819;                                   // FIX_2_053119869
  t2 *= 25172;                                   // FIX_3_072711026
  t3 *= 12299;                                   // FIX_1_501321110
  z1 *= -7373;                                   // FIX_0_899976223
  z2 *= -20995;                                  // FIX_2_562915447
  z3 = z3 * -16069 + z5;                         // FIX_1_961570560
  z4 = z4 * -3196 + z5;                          // FIX_0_390180644
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = tmp10 + t3;
  o[7] = tmp10 - t3;
  o[1] = tmp11 + t2;
  o[6] = tmp11 - t2;
  o[2] = tmp12 + t1;
  o[5] = tmp12 - t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
}

__device__ __forceinline__ int descale(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

// jdmaster.c's range limit as the IDCT indexes it (x & 1023 of a descaled,
// centred value x).
__device__ __forceinline__ uint8_t range_limit(int x) {
  const int v = x & 1023;
  if (v < 128) return static_cast<uint8_t>(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return static_cast<uint8_t>(v - 896);
}

constexpr int kIdctBlocks = 32;  // 8x8 blocks a thread block, 8 threads each

// (F, bh, bw, 64) int16 quantized coefficients (natural order) and (F, 64)
// uint16 tables -> (F, h, w) u8 planes, cropped.  Thread `lane` of a
// block's 8 transforms column `lane`, then row `lane`.
__global__ void idct_islow_kernel(const int16_t* __restrict__ coefs,
                                  const uint16_t* __restrict__ qtables,
                                  int nframes, int bh, int bw, int h, int w,
                                  uint8_t* __restrict__ out) {
  __shared__ int ws[kIdctBlocks][64];
  const int group = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int64_t per_frame = static_cast<int64_t>(bh) * bw;
  const int64_t block = static_cast<int64_t>(blockIdx.x) * kIdctBlocks + group;
  const bool valid = block < per_frame * nframes;
  const int64_t frame = valid ? block / per_frame : 0;
  const int rem = valid ? static_cast<int>(block - frame * per_frame) : 0;
  const int by = rem / bw, bx = rem - (rem / bw) * bw;
  if (valid) {
    const int16_t* c = coefs + block * 64;
    const uint16_t* q = qtables + frame * 64;
    int d[8], o[8];
    for (int k = 0; k < 8; ++k) {
      // DEQUANTIZE, the table as libjpeg stores it (short)
      d[k] = static_cast<int>(c[k * 8 + lane]) *
             static_cast<int>(static_cast<int16_t>(q[k * 8 + lane]));
    }
    idct_1d(d, o);
    for (int k = 0; k < 8; ++k) {
      ws[group][k * 8 + lane] = descale(o[k], kConstBits - kPass1Bits);
    }
  }
  __syncwarp();  // a block's 8 threads share a warp
  if (!valid) return;
  int d[8], o[8];
  for (int k = 0; k < 8; ++k) d[k] = ws[group][lane * 8 + k];
  idct_1d(d, o);
  const int y = by * 8 + lane;
  if (y >= h) return;
  uint8_t* row = out + (frame * h + y) * static_cast<int64_t>(w) + bx * 8;
  for (int k = 0; k < 8 && bx * 8 + k < w; ++k) {
    row[k] = range_limit(descale(o[k], kConstBits + kPass1Bits + 3));
  }
}

cudaError_t launch_idct(const int16_t* coefs, const uint16_t* qtables,
                        int nframes, int bh, int bw, int h, int w,
                        uint8_t* out, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(nframes) * bh * bw;
  const int grid = static_cast<int>((blocks + kIdctBlocks - 1) / kIdctBlocks);
  idct_islow_kernel<<<grid, kIdctBlocks * 8, 0, stream>>>(
      coefs, qtables, nframes, bh, bw, h, w, out);
  return cudaGetLastError();
}

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
  cudaStream_t stream = nullptr;
  cudaEvent_t ready = nullptr;  // the caller's stream, at the call
  cudaEvent_t done = nullptr;   // this stream, at the call's last launch
  uint8_t* staging = nullptr;  // a chunk's frames at source size, 1 or 3 ch
  size_t staging_bytes = 0;
  uint8_t* planes = nullptr;  // a colour chunk's Y, Cb and Cr planes
  size_t planes_bytes = 0;
  uint8_t* coefs = nullptr;  // a chunk's coefficients and tables, on the card
  size_t coefs_bytes = 0;
  uint8_t* host[2] = {nullptr, nullptr};  // the same, pinned, two in turn
  size_t host_bytes[2] = {0, 0};
  cudaEvent_t copied[2] = {nullptr, nullptr};  // a pinned buffer's copy done
  int slot = 0;
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

// Grow pinned buffer `slot`, whose last copy has completed.
cudaError_t reserve_host(Decoder* dec, int slot, size_t want) {
  if (dec->host_bytes[slot] >= want) return cudaSuccess;
  if (dec->host[slot] != nullptr) {
    const cudaError_t err = cudaFreeHost(dec->host[slot]);
    if (err != cudaSuccess) return err;
  }
  dec->host[slot] = nullptr;
  dec->host_bytes[slot] = 0;
  const cudaError_t err =
      cudaHostAlloc(reinterpret_cast<void**>(&dec->host[slot]), want,
                    cudaHostAllocDefault);
  if (err == cudaSuccess) dec->host_bytes[slot] = want;
  return err;
}

// (hs, vs) of a colour frame's chroma against its luma, or false for what
// the colour kernel does not take: Y must carry the largest factors, Cb
// and Cr equal ones, the ratio 4:4:4, 4:2:2 or 4:2:0 (as jdsample.c picks
// its fancy upsamplers).
bool chroma_factors(const ammc_jpeg::Info& info, int* hs, int* vs) {
  const ammc_jpeg::Component* c = info.comp;
  if (c[0].h_samp != info.max_h || c[0].v_samp != info.max_v ||
      c[1].h_samp != c[2].h_samp || c[1].v_samp != c[2].v_samp ||
      c[0].h_samp % c[1].h_samp || c[0].v_samp % c[1].v_samp) {
    return false;
  }
  *hs = c[0].h_samp / c[1].h_samp;
  *vs = c[0].v_samp / c[1].v_samp;
  return (*hs == 1 && *vs == 1) || (*hs == 2 && (*vs == 1 || *vs == 2));
}

bool same_geometry(const ammc_jpeg::Info& a, const ammc_jpeg::Info& b) {
  if (a.width != b.width || a.height != b.height || a.ncomp != b.ncomp) {
    return false;
  }
  for (int c = 0; c < a.ncomp; ++c) {
    if (a.comp[c].h_samp != b.comp[c].h_samp ||
        a.comp[c].v_samp != b.comp[c].v_samp) {
      return false;
    }
  }
  return true;
}

struct Frame {
  std::vector<uint8_t> data;
  ammc_jpeg::Info info;
};

struct Launches {
  int idct = 0, ycc = 0, resize = 0;
};

// Every file read and its headers parsed, on the host's threads, so the
// output's channels are known before the first write and no file fails
// on its headers after one.
int read_frames(const char** paths, int n, int n_threads,
                std::vector<Frame>* frames) {
  frames->resize(n);
  return ammc_jpeg::parallel_for(n, n_threads, [&](int i) {
    Frame& f = (*frames)[i];
    int rc = ammc_jpeg::read_file(paths[i], &f.data);
    if (rc != kOk) return rc;
    rc = ammc_jpeg::read_info(f.data.data(), f.data.size(), &f.info);
    if (rc != kOk) return rc;
    int hs, vs;
    if (f.info.ncomp == 3 && !chroma_factors(f.info, &hs, &vs)) {
      return static_cast<int>(kSubsampling);
    }
    return static_cast<int>(kOk);
  });
}

// Frames [first, first + count) of one geometry: Huffman decode on the
// host into a pinned buffer, one copy to the card, the IDCT per component,
// the colour conversion per colour frame, one resize into `out`.
int decode_chunk(Decoder* dec, const std::vector<Frame>& frames, int first,
                 int count, int n_threads, int dh, int dw, int dc,
                 uint8_t* out, Launches* launches) {
  const ammc_jpeg::Info& info = frames[first].info;
  const int nc = info.ncomp;
  size_t coef_off[ammc_jpeg::kMaxComps + 1] = {0};
  for (int c = 0; c < nc; ++c) {
    coef_off[c + 1] = coef_off[c] + static_cast<size_t>(count) *
                                        info.comp[c].blocks_h *
                                        info.comp[c].blocks_w * 64 * 2;
  }
  const size_t qt_off = coef_off[nc];
  const size_t bytes = qt_off + static_cast<size_t>(nc) * count * 64 * 2;
  const int slot = dec->slot;
  dec->slot ^= 1;
  // the pinned buffer's previous copy (two chunks ago) must have landed
  if (cudaEventSynchronize(dec->copied[slot]) != cudaSuccess ||
      reserve_host(dec, slot, bytes) != cudaSuccess) {
    return kCuda;
  }
  uint8_t* host = dec->host[slot];
  const int rc = ammc_jpeg::parallel_for(count, n_threads, [&](int f) {
    const Frame& fr = frames[first + f];
    int16_t* coefs[ammc_jpeg::kMaxComps];
    uint16_t* qts[ammc_jpeg::kMaxComps];
    for (int c = 0; c < nc; ++c) {
      const size_t blocks = static_cast<size_t>(info.comp[c].blocks_h) *
                            info.comp[c].blocks_w;
      coefs[c] = reinterpret_cast<int16_t*>(host + coef_off[c]) +
                 f * blocks * 64;
      qts[c] = reinterpret_cast<uint16_t*>(host + qt_off) +
               (static_cast<size_t>(c) * count + f) * 64;
    }
    return ammc_jpeg::decode_coefs(fr.data.data(), fr.data.size(), info,
                                   coefs, qts);
  });
  if (rc != kOk) return rc;
  if (reserve(dec, &dec->coefs, &dec->coefs_bytes, bytes) != cudaSuccess ||
      cudaMemcpyAsync(dec->coefs, host, bytes, cudaMemcpyHostToDevice,
                      dec->stream) != cudaSuccess ||
      cudaEventRecord(dec->copied[slot], dec->stream) != cudaSuccess) {
    return kCuda;
  }
  const int sh = info.height, sw = info.width, sc = nc == 1 ? 1 : 3;
  const size_t frame_in = static_cast<size_t>(sh) * sw * sc;
  if (reserve(dec, &dec->staging, &dec->staging_bytes,
              frame_in * kChunkFrames) != cudaSuccess) {
    return kCuda;
  }
  const auto* qt = reinterpret_cast<const uint16_t*>(dec->coefs + qt_off);
  auto idct = [&](int c, uint8_t* dst) {
    const ammc_jpeg::Component& cp = info.comp[c];
    ++launches->idct;
    return launch_idct(
        reinterpret_cast<const int16_t*>(dec->coefs + coef_off[c]),
        qt + static_cast<size_t>(c) * count * 64, count, cp.blocks_h,
        cp.blocks_w, cp.height, cp.width, dst, dec->stream);
  };
  if (nc == 1) {
    // a gray frame's Y plane is its staged frame
    if (idct(0, dec->staging) != cudaSuccess) return kCuda;
  } else {
    int hs, vs;
    chroma_factors(info, &hs, &vs);
    const int cw = info.comp[1].width, ch = info.comp[1].height;
    const size_t luma = static_cast<size_t>(sw) * sh;
    const size_t chroma = static_cast<size_t>(cw) * ch;
    if (reserve(dec, &dec->planes, &dec->planes_bytes,
                (luma + 2 * chroma) * kChunkFrames) != cudaSuccess) {
      return kCuda;
    }
    uint8_t* y = dec->planes;
    uint8_t* cb = y + luma * count;
    uint8_t* cr = cb + chroma * count;
    if (idct(0, y) != cudaSuccess || idct(1, cb) != cudaSuccess ||
        idct(2, cr) != cudaSuccess) {
      return kCuda;
    }
    for (int f = 0; f < count; ++f) {
      if (launch_ycc(y + luma * f, sw, cb + chroma * f, cr + chroma * f, cw,
                     sh, sw, ch, cw, hs, vs, dec->staging + frame_in * f,
                     dec->stream) != cudaSuccess) {
        return kCuda;
      }
      ++launches->ycc;
    }
  }
  if (launch_resize(dec->staging, count, sh, sw, sc, out, dh, dw, dc,
                    dec->stream) != cudaSuccess) {
    return kCuda;
  }
  ++launches->resize;
  return kOk;
}

int decode_frames(Decoder* dec, const std::vector<Frame>& frames,
                  int n_threads, int dh, int dw, int dc, uint8_t* out,
                  Launches* launches) {
  const size_t frame_out = static_cast<size_t>(dh) * dw * dc;
  const int n = static_cast<int>(frames.size());
  for (int first = 0; first < n;) {
    int end = first + 1;
    while (end < n && end - first < kChunkFrames &&
           same_geometry(frames[first].info, frames[end].info)) {
      ++end;
    }
    const int rc = decode_chunk(dec, frames, first, end - first, n_threads,
                                dh, dw, dc, out + frame_out * first,
                                launches);
    if (rc != kOk) return rc;
    first = end;
  }
  return kOk;
}

int decode_video(Decoder* dec, const char** paths, int n, int dh, int dw,
                 int n_threads, uint8_t* out, cudaStream_t caller,
                 int* channels, Launches* launches) {
  if (cudaSetDevice(dec->device) != cudaSuccess) return kCuda;
  std::vector<Frame> frames;
  int rc = read_frames(paths, n, n_threads, &frames);
  if (rc != kOk) return rc;
  int dc = 1;
  for (const Frame& f : frames) dc = f.info.ncomp == 3 ? 3 : dc;
  *channels = dc;
  // `out` may still be in use by work queued on the caller's stream
  if (cudaEventRecord(dec->ready, caller) != cudaSuccess ||
      cudaStreamWaitEvent(dec->stream, dec->ready, 0) != cudaSuccess) {
    return kCuda;
  }
  rc = decode_frames(dec, frames, n_threads, dh, dw, dc, out, launches);
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

// A decoder on `device`: a stream, events and buffers of its own.  It lives
// as long as the process (the binding keeps one per device).
int ammc_jpeg_decoder_create(int device, void** out) {
  if (cudaSetDevice(device) != cudaSuccess) return kCuda;
  auto* dec = new Decoder;
  dec->device = device;
  bool ok = cudaStreamCreateWithFlags(&dec->stream, cudaStreamNonBlocking) ==
            cudaSuccess;
  cudaEvent_t* events[] = {&dec->ready, &dec->done, &dec->copied[0],
                           &dec->copied[1]};
  for (cudaEvent_t* e : events) {
    ok = ok && cudaEventCreateWithFlags(e, cudaEventDisableTiming) ==
                   cudaSuccess;
  }
  if (!ok) {
    for (cudaEvent_t* e : events) {
      if (*e != nullptr) cudaEventDestroy(*e);
    }
    if (dec->stream != nullptr) cudaStreamDestroy(dec->stream);
    delete dec;
    return kCuda;
  }
  *out = dec;
  return kOk;
}

// JPEG files -> out, a device buffer of n * out_h * out_w * 3 bytes, which
// gets (n, out_h, out_w, *channels) u8: *channels 1 when every frame is
// grayscale, else 3 (RGB).  The Huffman decode runs on n_threads host
// threads.  The decode waits for the work queued on `stream` (the
// caller's) so far, and `stream` waits for the decode.  *idct_launches,
// *launches and *ycc_launches get the IDCT, the resize and the colour
// kernel's launches.  Returns 0 or an error code (above).
int ammc_gpu_decode_video(void* handle, const char** paths, int n, int out_h,
                          int out_w, int n_threads, void* out, void* stream,
                          int* channels, int* idct_launches, int* launches,
                          int* ycc_launches) {
  auto* dec = static_cast<Decoder*>(handle);
  std::lock_guard<std::mutex> lock(dec->mu);
  *channels = 0;
  Launches counts;
  const int rc = decode_video(dec, paths, n, out_h, out_w, n_threads,
                              static_cast<uint8_t*>(out),
                              static_cast<cudaStream_t>(stream), channels,
                              &counts);
  *idct_launches = counts.idct;
  *launches = counts.resize;
  *ycc_launches = counts.ycc;
  return rc;
}

// The IDCT kernel alone on device buffers: coefs (nframes, bh, bw, 64)
// int16, qtables (nframes, 64) uint16, out (nframes, h, w) u8, on the
// caller's stream.  Returns a cudaError_t.
int ammc_idct_islow_u8(const void* coefs, const void* qtables, int nframes,
                       int bh, int bw, int h, int w, void* out,
                       void* stream) {
  return launch_idct(static_cast<const int16_t*>(coefs),
                     static_cast<const uint16_t*>(qtables), nframes, bh, bw,
                     h, w, static_cast<uint8_t*>(out),
                     static_cast<cudaStream_t>(stream));
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
