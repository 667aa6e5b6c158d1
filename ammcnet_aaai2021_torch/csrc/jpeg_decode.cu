// JPEG frames decoded as libjpeg decodes them, on the GPU, and resized by
// a CUDA kernel, for scoring raw video on a machine whose host has no
// libjpeg.
//
// It replaces the JPEG half of the host loader (ammc_loader.cpp, the port's
// copy of ammcnet_aaai2021_tpu/native/ammc_loader.cpp:54-119,130-163,
// 216-227) and gives its bytes: a video's frames are read from disk and
// entropy-decoded to quantized DCT coefficients on the host's threads
// (jpeg_huffman.cpp, included below: the port's own entropy decode, since
// no library on the card's machine hands out coefficients), a chunk of up
// to kChunkFrames frames at a time into pinned memory, copied to the card
// in one transfer, dequantized and inverse-transformed there by
// `idct_islow_kernel` (libjpeg's accurate integer IDCT), a colour chunk's
// planes converted to RGB by `ycc_to_rgb_kernel`, and the chunk resized to
// (dh, dw) by `resize_bilinear_kernel` straight into the caller's device
// buffer, (T, dh, dw, 3) u8 RGB: a grayscale frame's one plane is resized
// to three channels as the host resizes libjpeg's RGB decode of it (whose
// channel 0 can round 1 LSB off the other two).  A progressive frame that
// libjpeg block-smooths at output is smoothed on the host threads, after
// its entropy decode, into the pinned buffer (jpeg_huffman.cpp
// smooth_component).  While the card works on one chunk the host decodes
// the next into the other of two pinned buffers.
//
// The IDCT is libjpeg-turbo 2.1.5's islow IDCT (JPEG_LIB_VERSION 62, which
// cv2 and the host loader run) as its x86 SIMD build computes it
// (jidctint-avx2.asm; jsimd picks it over jidctint.c on any x86-64 host):
// dequantize by pmullw (the low 16 bits of coefficient x table, the table
// as a short), a column pass with CONST_BITS 13 and PASS1_BITS 2 whose
// outputs are descaled and saturated to 16 bits (packssdw) -- or, when
// rows 1-7 of the block are all zero, row 0 << PASS1_BITS in 16-bit lanes
// -- and a row pass descaled by CONST_BITS + PASS1_BITS + 3 and saturated
// to [-128, 127] (packssdw, packsswb) before + 128.  Its butterfly is
// jidctint.c's with the sums in0 +- in4, in1 + in5, in3 + in7 in 16-bit
// lanes.  On a real image's coefficients that is jidctint.c's result; it
// differs where a lane wraps or saturates or a sum passes jidctint.c's
// range limit (which wraps beyond +-512), as coefficients decoded from
// zero bytes past a truncated arithmetic-coded frame's end do.  With
// libjpeg's planes, the colour conversion below is libjpeg's (fancy
// upsampling, the jdcolor.c tables), so a frame is bitwise the host
// route's; the plain version of each kernel sits in
// ammcnet_aaai2021_torch/data/native.py.
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
// two source rows then a vertical lerp, rounded by +0.5 and truncation,
// with the fused multiply-adds of the JAX package's -O3 -march=native
// build (ammc_loader.cpp:resize_bilinear lists them) as __fmaf_rn and
// every other product and sum an IEEE-rounded __fmul_rn / __fadd_rn, so
// the kernel is bitwise the host route and its plain PyTorch version
// (ammcnet_aaai2021_torch/data/native.py:resize_bilinear_u8_ref).  It
// always writes three channels: a one-channel source is resized as the
// host resizes its RGB decode, channel 0 with its own rounding.
//
// What bounds the kernels on this card: bytes, with the integer work
// close behind.  The IDCT reads 2 bytes a coefficient and writes 1 a
// pixel, with about 25 integer operations a pixel; the colour kernel reads
// 1.5 bytes and writes 3 a pixel (4:2:0), with about 28.  The resize moves
// few bytes (a 32-frame gray 240x360 chunk reads 2.8 MB and writes 6.3 MB
// of 256x256 RGB, 2.7 microseconds at 3.35 TB/s): what held its first
// design back was instructions and stores, each thread an output pixel
// that recomputed both axis maps (an IEEE division each), walked back over
// earlier rows for the row buffer's copy, gathered its 4 taps a channel
// through L1 and stored single bytes.  So the resize now computes its axis
// taps once a block into shared memory, stages the source rows a tile
// needs with 16-byte loads, turns bytes into floats and rounds back by
// exponent tricks in place of conversion instructions, and stores each
// thread's 16 whole pixels with 16-byte stores (resize_bilinear_kernel,
// below).  The IDCT's and the colour kernel's tilings likewise lay the
// grid over (rows, frames) with no division in a thread, stage what a
// tile reads with coalesced copies, and store whole words.  One IDCT
// launch per chunk and component, one colour launch and one resize launch
// per chunk, and one stream per decoder, ordered after the caller's stream
// by an event and before it by another, so the frames never leave the
// card.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes (ammcnet_aaai2021_torch/data/native.py).  Error codes are the
// host loader's and jpeg_huffman.cpp's: 2 a file that does not open, 3
// corrupt data, 8 a JPEG with other than 1 or 3 components, 10-14 a JPEG
// the entropy decode does not take (a progressive scan whose parameters
// libjpeg rejects, lossless or hierarchical, a malformed DAC, not
// 8-bit, not YCbCr); also 6 a CUDA error, 9 a colour JPEG subsampled other
// than 4:4:4, 4:2:2 or 4:2:0.

#include <cuda_runtime.h>

#include <algorithm>
#include <chrono>
#include <cmath>
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
constexpr int F029 = 2446, F039 = 3196, F054 = 4433, F076 = 6270,
              F089 = 7373, F117 = 9633, F150 = 12299, F184 = 15137,
              F196 = 16069, F205 = 16819, F256 = 20995, F307 = 25172;

// A 16-bit lane's value: the low 16 bits of x, sign-extended.
__device__ __forceinline__ int wrap16(int x) {
  return static_cast<int16_t>(static_cast<uint16_t>(x));
}

// The butterfly of libjpeg-turbo's x86 SIMD islow IDCT (jidctint-avx2.asm,
// jidctint-sse2.asm) on 8 inputs of 16 bits along one axis: jidctint.c's
// butterfly with its products regrouped as pmaddwd pairs and the sums in0
// +- in4, in1 + in5 and in3 + in7 taken in 16-bit lanes; the 8 outputs
// before their DESCALE.  For 16-bit inputs no other sum leaves int32
// (|out| < 1.7e9).
__device__ __forceinline__ void idct_1d(const int d[8], int o[8]) {
  const int tmp3 = d[2] * (F054 + F076) + d[6] * F054;
  const int tmp2 = d[2] * F054 + d[6] * (F054 - F184);
  const int tmp0 = wrap16(d[0] + d[4]) * (1 << kConstBits);
  const int tmp1 = wrap16(d[0] - d[4]) * (1 << kConstBits);
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int z3 = wrap16(d[7] + d[3]), z4 = wrap16(d[5] + d[1]);
  const int z3p = z3 * (F117 - F196) + z4 * F117;
  const int z4p = z3 * F117 + z4 * (F117 - F039);
  const int t0 = d[7] * (F029 - F089) + d[1] * -F089 + z3p;
  const int t3 = d[7] * -F089 + d[1] * (F150 - F089) + z4p;
  const int t1 = d[5] * (F205 - F256) + d[3] * -F256 + z4p;
  const int t2 = d[5] * -F256 + d[3] * (F307 - F256) + z3p;
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

// (c << 16) | sat_u8(a) << 8 | sat_u8(b): two ints saturated to bytes and
// packed over c's low half (cvt.pack.sat.u8.s32.b32)
__device__ __forceinline__ uint32_t pack_u8(int a, int b, uint32_t c) {
  uint32_t d;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// 4 ints saturated to bytes, v[0] lowest
__device__ __forceinline__ uint32_t pack4_u8(int v0, int v1, int v2, int v3) {
  return pack_u8(v1, v0, pack_u8(v3, v2, 0));
}

// sat_s16(a) << 16 | sat_s16(b) (cvt.pack.sat.s16.s32: packssdw's
// saturation)
__device__ __forceinline__ uint32_t pack_s16(int a, int b) {
  uint32_t d;
  asm("cvt.pack.sat.s16.s32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Coefficient (row k, column c) of a block held as 8 uint4 rows (natural
// order), dequantized by q (its table entry as a short) as pmullw does: the
// low 16 bits of the product, sign-extended.  The high half of a word is
// multiplied in place, so no carry from the low half reaches its bits.
template <int K, int C>
__device__ __forceinline__ int dequantize(const uint4 (&rows)[8], int q) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&rows[K]);
  const uint32_t word = w[C >> 1];
  if (C & 1) {
    return static_cast<int>((word & 0xFFFF0000u) * static_cast<uint32_t>(q)) >>
           16;
  }
  return wrap16(static_cast<int>(word * static_cast<uint32_t>(q)));
}

// Pass 1 of a block whose rows 1-7 are all zero, columns C and C + 1: row
// 0 dequantized << PASS1_BITS in 16-bit lanes on every row, packed (the
// SIMD build's shortcut).  qs: the table column-major, as ints.
template <int C>
__device__ __forceinline__ void dc_rows(const uint4 (&blk)[8], const int* qs,
                                        uint32_t (&ws)[8][4]) {
  const int lo = wrap16(dequantize<0, C>(blk, qs[C * 8]) * (1 << kPass1Bits));
  const int hi =
      wrap16(dequantize<0, C + 1>(blk, qs[(C + 1) * 8]) * (1 << kPass1Bits));
  const uint32_t v = pack_s16(hi, lo);
#pragma unroll
  for (int r = 0; r < 8; ++r) ws[r][C / 2] = v;
}

// Pass 1 of column C, descaled (not yet saturated).
template <int C>
__device__ __forceinline__ void column(const uint4 (&blk)[8], const int* qs,
                                       int (&o)[8]) {
  const int4 qa = *reinterpret_cast<const int4*>(qs + C * 8);
  const int4 qb = *reinterpret_cast<const int4*>(qs + C * 8 + 4);
  const int d[8] = {
      dequantize<0, C>(blk, qa.x), dequantize<1, C>(blk, qa.y),
      dequantize<2, C>(blk, qa.z), dequantize<3, C>(blk, qa.w),
      dequantize<4, C>(blk, qb.x), dequantize<5, C>(blk, qb.y),
      dequantize<6, C>(blk, qb.z), dequantize<7, C>(blk, qb.w)};
  idct_1d(d, o);
#pragma unroll
  for (int r = 0; r < 8; ++r) o[r] = descale(o[r], kConstBits - kPass1Bits);
}

// Pass 1 of columns C and C + 1, saturated to 16 bits and packed as
// packssdw packs them: ws[r][C / 2] = column C + 1's row r << 16 | column
// C's.
template <int C>
__device__ __forceinline__ void column_pair(const uint4 (&blk)[8],
                                            const int* qs,
                                            uint32_t (&ws)[8][4]) {
  int even[8], odd[8];
  column<C>(blk, qs, even);
  column<C + 1>(blk, qs, odd);
#pragma unroll
  for (int r = 0; r < 8; ++r) ws[r][C / 2] = pack_s16(odd[r], even[r]);
}

// The IDCT's tiling: a CTA of (cols, rows) threads, a thread an 8x8 block,
// covers `rows` block rows (strips) of one frame, `cols` blocks of each.
constexpr int kIdctCols = 128;     // blocks a strip of a CTA, at most
constexpr int kIdctThreads = 128;  // a CTA's threads, about

// (F, bh, bw, 64) int16 quantized coefficients (natural order) and (F, 64)
// uint16 tables -> (F, h, w) u8 planes, cropped; `aligned`: every output
// row starts on 8 bytes (w % 8 == 0 and `out` 8-aligned).
// CTA (bx, by, bz): strips [bx * rows, +rows) of frames bz, bz + gridDim.z,
// ..., blocks [by * cols, +cols) of each.  The frame's table goes to shared
// memory as ints (short-cast), the tile's coefficients by 16-byte cp.async
// copies, coalesced (a strip's blocks are one contiguous run), each block's
// eight 16-byte rows at row ^ (block & 7) so that the 8 threads of a
// quarter-warp, reading row k of 8 consecutive blocks, hit 8 distinct bank
// groups.  A thread then holds its block in registers: pass 1 (columns)
// descaled and saturated to 16 bits, or, where rows 1-7 of the block are
// all zero, row 0 << PASS1_BITS in 16 bits (the SIMD build's shortcut);
// pass 2 (rows) descaled and saturated to samples; each 8-pixel row stored
// as one 8-byte word, a warp's 32 blocks of a strip one contiguous 256-byte
// run per row.  Bitwise the plain version (idct_islow_u8_ref).
__global__ void __launch_bounds__(kIdctThreads) idct_islow_kernel(
    const int16_t* __restrict__ coefs, const uint16_t* __restrict__ qtables,
    int nframes, int bh, int bw, int h, int w, bool aligned,
    uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int cols = blockDim.x, rows = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // the table as shorts widened to ints, column-major (column C's eight
  // quantizers one 32-byte run)
  int* qs = reinterpret_cast<int*>(smem + rows * cols * 128);
  const int by = blockIdx.x * rows + ty;
  const int bx = blockIdx.y * cols + tx;
  const int ncols = min(cols, bw - static_cast<int>(blockIdx.y) * cols);
  const int tid = ty * cols + tx;
  uint8_t* tile = smem + ty * cols * 128;
  for (int f = blockIdx.z; f < nframes; f += gridDim.z) {
    for (int i = tid; i < 64; i += rows * cols) {
      qs[(i & 7) * 8 + (i >> 3)] =
          static_cast<int16_t>(qtables[static_cast<size_t>(f) * 64 + i]);
    }
    if (by < bh) {
      const uint8_t* g = reinterpret_cast<const uint8_t*>(coefs) +
                         ((static_cast<size_t>(f) * bh + by) * bw +
                          static_cast<size_t>(blockIdx.y) * cols) * 128;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = tx + k * cols;  // 16-byte chunk j of the strip's run
        if (j < ncols * 8) {
          const int b = j >> 3, r = j & 7;
          const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(
              tile + b * 128 + ((r ^ (b & 7)) << 4)));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                       "l"(g + j * 16));
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (by < bh && tx < ncols) {
      uint4 blk[8];
      const uint8_t* mine = tile + tx * 128;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        blk[k] = *reinterpret_cast<const uint4*>(mine + ((k ^ (tx & 7)) << 4));
      }
      uint32_t ac = 0;
#pragma unroll
      for (int k = 1; k < 8; ++k) ac |= blk[k].x | blk[k].y | blk[k].z | blk[k].w;
      // pass 1's outputs, 16-bit, packed: ws[r][c / 2] holds row r's
      // columns c (low half) and c + 1 (high half)
      uint32_t ws[8][4];
      if (ac == 0) {
        dc_rows<0>(blk, qs, ws);
        dc_rows<2>(blk, qs, ws);
        dc_rows<4>(blk, qs, ws);
        dc_rows<6>(blk, qs, ws);
      } else {
        column_pair<0>(blk, qs, ws);
        column_pair<2>(blk, qs, ws);
        column_pair<4>(blk, qs, ws);
        column_pair<6>(blk, qs, ws);
      }
      const int x0 = bx * 8;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int y = by * 8 + r;
        if (y >= h) break;
        int d[8], o[8];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          d[2 * c] = wrap16(static_cast<int>(ws[r][c]));
          d[2 * c + 1] = static_cast<int>(ws[r][c]) >> 16;
        }
        idct_1d(d, o);
        // descaled, + CENTERJSAMPLE (a multiple of 2^18 before the shift),
        // saturated to [0, 255]: the SIMD build's saturation to [-128,
        // 127] before its + 128
        constexpr int kRound = (1 << (kConstBits + kPass1Bits + 2)) +
                               (128 << (kConstBits + kPass1Bits + 3));
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          o[k] = (o[k] + kRound) >> (kConstBits + kPass1Bits + 3);
        }
        const uint32_t lo = pack4_u8(o[0], o[1], o[2], o[3]);
        const uint32_t hi = pack4_u8(o[4], o[5], o[6], o[7]);
        uint8_t* row = out + (static_cast<size_t>(f) * h + y) * w + x0;
        if (aligned && x0 + 8 <= w) {
          *reinterpret_cast<uint2*>(row) = make_uint2(lo, hi);
        } else {
          for (int k = 0; k < 8 && x0 + k < w; ++k) {
            row[k] = static_cast<uint8_t>((k < 4 ? lo >> (8 * k)
                                                 : hi >> (8 * (k - 4))) & 0xFF);
          }
        }
      }
    }
    __syncthreads();  // the tile and the table are restaged for the next frame
  }
}

cudaError_t launch_idct(const int16_t* coefs, const uint16_t* qtables,
                        int nframes, int bh, int bw, int h, int w,
                        uint8_t* out, cudaStream_t stream) {
  const int cols = std::min(bw, kIdctCols);
  const int rows = std::max(1, std::min(bh, kIdctThreads / cols));
  const dim3 grid((bh + rows - 1) / rows, (bw + cols - 1) / cols,
                  std::min(nframes, 65535));
  if (reinterpret_cast<uintptr_t>(coefs) % 16 != 0) {
    return cudaErrorMisalignedAddress;  // the cp.async copies take 16 bytes
  }
  const bool aligned = w % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  idct_islow_kernel<<<grid, dim3(cols, rows),
                      rows * cols * 128 + 64 * sizeof(int), stream>>>(
      coefs, qtables, nframes, bh, bw, h, w, aligned, out);
  return cudaGetLastError();
}

// One axis of the half-pixel map: the two clamped source taps and the
// weight of the second, as AxisMap in ammc_loader.cpp computes them (scale
// = __fdiv_rn(src_n, dst_n), computed once by the caller).
__device__ __forceinline__ void axis_map(int x, int src_n, float scale,
                                         int* i0, int* i1, float* w) {
  const float fx =
      __fmaf_rn(__fadd_rn(static_cast<float>(x), 0.5f), scale, -0.5f);
  const int x0 = static_cast<int>(fx >= 0.f ? fx : __fsub_rn(fx, 1.f));
  *w = __fsub_rn(fx, static_cast<float>(x0));
  *i0 = min(max(x0, 0), src_n - 1);
  *i1 = min(max(x0 + 1, 0), src_n - 1);
}

// The host loader keeps two row buffers; its second one, for source row
// y1, is row0's copy when the first output row that needs y1 has y0 == y1,
// else resampled with channel 0 of a 3-channel image fused the other way
// (ammc_loader.cpp:resize_bilinear).  y1 never decreases with y.  Where y1
// lies inside the image (0 < y1 < sh - 1) that first row has x0 + 1 == y1,
// so y0 == y1 - 1 and the row is no copy; at the edges the rows that share
// y1 are walked back.
__device__ bool row1_is_copy(int y, int sh, float scale, int y1) {
  if (y1 > 0 && y1 < sh - 1) return false;
  int first = y, f0, f1;
  float fw;
  while (first > 0) {
    axis_map(first - 1, sh, scale, &f0, &f1, &fw);
    if (f1 != y1) break;
    --first;
  }
  axis_map(first, sh, scale, &f0, &f1, &fw);
  return f0 == y1;
}

// A u8 as float, exactly, without a conversion instruction: 2^23 + b's
// bits, minus 2^23.
__device__ __forceinline__ float u8f(uint32_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.f);
}

// trunc(v + 0.5) of a value in [0, 256), as __float2uint_rz would give it,
// in the low byte: 2^23 + t rounded toward zero holds floor(t) in its low
// mantissa bits.
__device__ __forceinline__ uint32_t round_u8(float v) {
  return __float_as_uint(__fadd_rz(__fadd_rn(v, 0.5f), 8388608.f)) & 0xFFu;
}

// The resize kernel's tiling of one launch, chosen on the host
// (resize_plan): a block stages the source rows and columns that
// `rows` output rows by `tile_w` output columns of `frames` frames need,
// `slot_rows` rows of `slot_bytes` bytes.
struct ResizePlan {
  int rows, tile_w, frames, slot_rows, slot_bytes, threads, smem;
};

constexpr int kResizeRun = 16;        // output pixels a thread writes
constexpr int kResizeThreads = 256;   // at most, a block
constexpr int kResizeSmem = 48 << 10; // a block's shared memory, at most

struct ColTap {  // a tile column's taps (bytes into a staged row), weights
  int i0, i1;
  float w, v;  // w, 1 - w
};
struct RowTap {  // an output row's staged slots, source rows and weights
  int s0, s1, y0, y1;
  float w, v;
  int copied, pad;
};

// (n, sh, sw, SC) u8, SC 1 or 3 -> (n, dh, dw, 3) u8, a gray source on all
// three channels as the host resizes its RGB decode.
// Block (bx, by, bz) writes output rows [by * rows, +rows) and columns
// [bx * tile_w, +tile_w) of frames [bz * frames, +frames).  It computes its
// column taps and row taps once (the same operations as the host's
// AxisMap), then per frame stages the distinct source rows it reads with
// 16-byte loads into shared memory (the contiguous range y0(first) ..
// y1(last) when it fits, else each output row's pair), and each thread
// resamples runs of kResizeRun output pixels from shared memory and
// stores a run's whole pixels with 16-byte stores where the address
// allows.  Every rounding step is the host's: __fmaf_rn where its build
// fused, __fmul_rn, __fadd_rn and __fsub_rn elsewhere, in its order.
template <int SC>
__global__ void __launch_bounds__(kResizeThreads)
    resize_bilinear_kernel(const uint8_t* __restrict__ src, int n, int sh,
                           int sw, uint8_t* __restrict__ dst, int dh, int dw,
                           ResizePlan plan) {
  constexpr int DC = 3;  // RGB out
  extern __shared__ __align__(16) uint8_t smem[];
  // column x's taps at (x % kResizeRun) * runs + x / kResizeRun: the
  // threads of a warp, on consecutive runs, read consecutive entries
  const int runs = (plan.tile_w + kResizeRun - 1) / kResizeRun;
  ColTap* cols = reinterpret_cast<ColTap*>(smem);
  RowTap* rows = reinterpret_cast<RowTap*>(smem + runs * kResizeRun *
                                                      sizeof(ColTap));
  uint8_t* slots = reinterpret_cast<uint8_t*>(rows + plan.rows);
  const int tid = threadIdx.x;
  const int x_lo = blockIdx.x * plan.tile_w;
  const int tile_w = min(plan.tile_w, dw - x_lo);
  const int y_lo = blockIdx.y * plan.rows;
  const int nrows = min(plan.rows, dh - y_lo);
  const float sx = __fdiv_rn(static_cast<float>(sw), static_cast<float>(dw));
  const float sy = __fdiv_rn(static_cast<float>(sh), static_cast<float>(dh));
  // the staged columns: c_lo .. c_hi of every staged row
  int c_lo, c_hi, t0, t1;
  float tw;
  axis_map(x_lo, sw, sx, &c_lo, &t1, &tw);
  axis_map(x_lo + tile_w - 1, sw, sx, &t0, &c_hi, &tw);
  const int span = (c_hi - c_lo + 1) * SC;
  // the staged rows: r_lo .. r_hi if they fit, else each row's pair
  int r_lo, r_hi;
  axis_map(y_lo, sh, sy, &r_lo, &t1, &tw);
  axis_map(y_lo + nrows - 1, sh, sy, &t0, &r_hi, &tw);
  const bool pairs = r_hi - r_lo + 1 > plan.slot_rows;
  const int nslots = pairs ? 2 * nrows : r_hi - r_lo + 1;
  for (int i = tid; i < tile_w; i += blockDim.x) {
    ColTap t;
    float w;
    axis_map(x_lo + i, sw, sx, &t.i0, &t.i1, &w);
    t.i0 = (t.i0 - c_lo) * SC;
    t.i1 = (t.i1 - c_lo) * SC;
    t.w = w;
    t.v = __fsub_rn(1.f, w);
    cols[(i % kResizeRun) * runs + i / kResizeRun] = t;
  }
  for (int r = tid; r < nrows; r += blockDim.x) {
    RowTap t;
    float w;
    axis_map(y_lo + r, sh, sy, &t.y0, &t.y1, &w);
    t.s0 = pairs ? 2 * r : t.y0 - r_lo;
    t.s1 = pairs ? 2 * r + 1 : t.y1 - r_lo;
    t.w = w;
    t.v = __fsub_rn(1.f, w);
    t.copied = row1_is_copy(y_lo + r, sh, sy, t.y1);
    t.pad = 0;
    rows[r] = t;
  }
  __syncthreads();
  const int64_t frame_in = static_cast<int64_t>(sh) * sw * SC;
  const int64_t frame_out = static_cast<int64_t>(dh) * dw * DC;
  const int runs_per_row = (tile_w + kResizeRun - 1) / kResizeRun;
  const int chunks = plan.slot_bytes / 16;
  const int f_end = min(n, (static_cast<int>(blockIdx.z) + 1) * plan.frames);
  for (int f = blockIdx.z * plan.frames; f < f_end; ++f) {
    const uint8_t* frame = src + f * frame_in;
    // stage: slot k holds source row `row` bytes [c_lo, c_hi] at offset
    // (address & 15), so 16-byte aligned chunks land aligned
    for (int i = tid; i < nslots * chunks; i += blockDim.x) {
      const int k = i / chunks, q = i - k * chunks;
      const int row = pairs ? ((k & 1) ? rows[k >> 1].y1 : rows[k >> 1].y0)
                            : r_lo + k;
      const uint8_t* g0 = frame + static_cast<int64_t>(row) * sw * SC +
                          c_lo * SC;
      const uint8_t* g1 = g0 + span;
      const uint8_t* a0 = reinterpret_cast<const uint8_t*>(
          reinterpret_cast<uintptr_t>(g0) & ~uintptr_t{15});
      const uint8_t* a = a0 + 16 * q;
      if (a >= g1) continue;
      uint8_t* s = slots + k * plan.slot_bytes + 16 * q;
      if (a >= g0 && a + 16 <= g1) {
        *reinterpret_cast<uint4*>(s) = __ldg(reinterpret_cast<const uint4*>(a));
      } else {
        for (int b = 0; b < 16; ++b) {
          if (a + b >= g0 && a + b < g1) s[b] = a[b];
        }
      }
    }
    __syncthreads();
    const uintptr_t base = reinterpret_cast<uintptr_t>(frame) + c_lo * SC;
    for (int j = tid; j < nrows * runs_per_row; j += blockDim.x) {
      const int r = j / runs_per_row;
      const int run = j - r * runs_per_row, x0 = run * kResizeRun;
      const RowTap rt = rows[r];
      const uint8_t* p0 =
          slots + rt.s0 * plan.slot_bytes +
          ((base + static_cast<uintptr_t>(rt.y0) * sw * SC) & 15);
      const uint8_t* p1 =
          slots + rt.s1 * plan.slot_bytes +
          ((base + static_cast<uintptr_t>(rt.y1) * sw * SC) & 15);
      const int count = min(kResizeRun, tile_w - x0);
      uint32_t words[kResizeRun * DC / 4];
#pragma unroll
      for (int i = 0; i < kResizeRun * DC / 4; ++i) words[i] = 0;
#pragma unroll
      for (int p = 0; p < kResizeRun; ++p) {
        if (p < count) {
          const ColTap ct = cols[p * runs + run];
          uint32_t out[DC];
#pragma unroll
          for (int c = 0; c < SC; ++c) {
            const float a0 = u8f(p0[ct.i0 + c]), b0 = u8f(p0[ct.i1 + c]);
            const float a1 = u8f(p1[ct.i0 + c]), b1 = u8f(p1[ct.i1 + c]);
            // fmaf(1 - w, a, w * b) for both rows, then the vertical lerp
            const float h0 = __fmaf_rn(ct.v, a0, __fmul_rn(ct.w, b0));
            const float h1 = __fmaf_rn(ct.v, a1, __fmul_rn(ct.w, b1));
            out[SC == 3 ? c : 1] =
                round_u8(__fmaf_rn(rt.v, h0, __fmul_rn(rt.w, h1)));
            if (c != 0) continue;
            // channel 0 of the second row buffer, fused the other way
            // (fmaf(w, b, (1 - w) * a)) unless it is row0's copy
            const float h1f = __fmaf_rn(ct.w, b1, __fmul_rn(ct.v, a1));
            out[0] = rt.copied ? out[SC == 3 ? 0 : 1]
                               : round_u8(__fmaf_rn(rt.v, h0,
                                                    __fmul_rn(rt.w, h1f)));
          }
          if constexpr (SC == 1) out[2] = out[1];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            const int k = p * DC + c;
            words[k >> 2] |= out[c] << (8 * (k & 3));
          }
        }
      }
      uint8_t* d = dst + f * frame_out +
                   (static_cast<int64_t>(y_lo + r) * dw + x_lo + x0) * DC;
      const uintptr_t addr = reinterpret_cast<uintptr_t>(d);
      if (count == kResizeRun && (addr & 15) == 0) {
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          reinterpret_cast<uint4*>(d)[i] =
              make_uint4(words[4 * i], words[4 * i + 1], words[4 * i + 2],
                         words[4 * i + 3]);
        }
      } else if (count == kResizeRun && (addr & 3) == 0) {
#pragma unroll
        for (int i = 0; i < kResizeRun * DC / 4; ++i) {
          reinterpret_cast<uint32_t*>(d)[i] = words[i];
        }
      } else {
#pragma unroll
        for (int k = 0; k < kResizeRun * DC; ++k) {
          if (k < count * DC) d[k] = (words[k >> 2] >> (8 * (k & 3))) & 0xFF;
        }
      }
    }
    __syncthreads();  // the slots are restaged for the next frame
  }
}

// The tiling of one resize launch: output tiles of up to 256 columns and
// the most rows (up to 4096 pixels a block) whose staged source fits
// kResizeSmem, shrunk row-wise, then column-wise; a block takes several
// frames when there are more tiles than 4 blocks an SM would run.  The
// staged rows and columns of a tile are bounded by the scale (a span of k
// outputs reaches at most floor((k - 1) * scale) + 3 sources; one more for
// the float map's rounding).
ResizePlan resize_plan(int n, int sh, int sw, int sc, int dh, int dw) {
  const double sy = static_cast<float>(sh) / static_cast<float>(dh);
  const double sx = static_cast<float>(sw) / static_cast<float>(dw);
  ResizePlan p{};
  p.tile_w = std::min((dw + kResizeRun - 1) / kResizeRun * kResizeRun, 256);
  p.rows = std::max(1, std::min(dh, 4096 / p.tile_w));
  for (;;) {
    const int span = std::min(
        sw, static_cast<int>(std::floor((p.tile_w - 1) * sx)) + 4);
    p.slot_bytes = (span * sc + 15 + 15) / 16 * 16;
    p.slot_rows = std::min(
        2 * p.rows, static_cast<int>(std::floor((p.rows - 1) * sy)) + 4);
    p.smem = (p.tile_w + kResizeRun - 1) / kResizeRun * kResizeRun *
                 static_cast<int>(sizeof(ColTap)) +
             p.rows * static_cast<int>(sizeof(RowTap)) +
             p.slot_rows * p.slot_bytes;
    if (p.smem <= kResizeSmem || (p.rows == 1 && p.tile_w == 1)) break;
    if (p.rows > 1) {
      p.rows /= 2;
    } else {
      p.tile_w = std::max(1, p.tile_w / 2);
    }
  }
  const int runs = p.rows * ((p.tile_w + kResizeRun - 1) / kResizeRun);
  p.threads = std::min(kResizeThreads, std::max(32, (runs + 31) / 32 * 32));
  const int64_t tiles = static_cast<int64_t>((dw + p.tile_w - 1) / p.tile_w) *
                        ((dh + p.rows - 1) / p.rows);
  constexpr int64_t kTargetBlocks = 4 * 132;
  p.frames = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(n, tiles * n / kTargetBlocks)));
  p.frames = std::max(p.frames, (n + 65534) / 65535);
  return p;
}

template <int SC>
cudaError_t launch_resize_as(const uint8_t* src, int n, int sh, int sw,
                             uint8_t* dst, int dh, int dw,
                             cudaStream_t stream) {
  const ResizePlan p = resize_plan(n, sh, sw, SC, dh, dw);
  if (p.smem > kResizeSmem) return cudaErrorInvalidConfiguration;
  const dim3 grid((dw + p.tile_w - 1) / p.tile_w, (dh + p.rows - 1) / p.rows,
                  (n + p.frames - 1) / p.frames);
  resize_bilinear_kernel<SC><<<grid, p.threads, p.smem, stream>>>(
      src, n, sh, sw, dst, dh, dw, p);
  return cudaGetLastError();
}

// The colour kernel's tiling: a CTA of (runs, rows) threads, a thread a
// run of RUN output pixels of a row, covers `rows` rows of one frame and
// runs * RUN columns.  RUN is 16 where the launch has enough of them to
// fill the card (a chunk), else 4 (a frame: four times the threads, and
// its chroma read straight from the planes through L1, since so small a
// launch is bound by latency, not bytes, and a staging round adds one).
constexpr int kYccRuns = 64;      // runs a CTA row, at most
constexpr int kYccThreads = 256;  // a CTA's threads, about
constexpr int64_t kYccWideRuns = 64 * 1024;  // 16-pixel runs that fill it

// N bytes of a plane row from column c0 on as ints, columns clamped to
// [0, cw) (edge samples standing in for missing neighbours)
template <int N>
__device__ __forceinline__ void row_bytes(const uint8_t* row, int c0, int cw,
                                          int (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __ldg(row + min(max(c0 + i, 0), cw - 1));
}

// N staged bytes from byte 3 of the 32-bit words at p on, as ints
template <int N>
__device__ __forceinline__ void staged_bytes(const uint32_t* p, int (&v)[N]) {
  uint32_t words[(N + 6) / 4];
#pragma unroll
  for (int q = 0; q < (N + 6) / 4; ++q) words[q] = p[q];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = (words[(i + 3) >> 2] >> (8 * ((i + 3) & 3))) & 0xFF;
  }
}

// Y (F, h, w) and Cb, Cr (F, ch, cw) u8 planes -> (F, h, w, 3) u8 RGB:
// libjpeg's fancy upsampling (HS, VS) = (2, 2) h2v2, (2, 1) h2v1, (1, 1)
// none (jdsample.c, edge samples standing in for missing neighbours) and
// jdcolor.c's tables (FIX(1.40200) = 91881, FIX(1.77200) = 116130,
// FIX(0.71414) = 46802, FIX(0.34414) = 22554, ONE_HALF = 32768, the
// chroma's - 128 folded into each constant term); `aligned`: every run
// starts on a whole word of Y and of RGB (w % RUN == 0 and the buffers
// 16-aligned); `chroma_words`: every chroma row starts on 4 bytes.
// CTA (bx, by, bz): rows [bx * rows, +rows) and columns [by * runs * RUN,
// ...) of frames bz, bz + gridDim.z, ...  At RUN 16 the chroma rows and
// columns the tile reads (one more on each side for the triangle filter,
// the edge rows and columns replicated) are staged once into shared
// memory by 32-bit words, so a chroma sample is read from memory once a
// tile.  Each thread loads its run's
// luma bytes in one load before the staging (the two overlap), then forms
// the chroma column sums (3 * near row + far row) of its RUN / HS + 2
// chroma columns from shared memory, converts four pixels (one luma word)
// at a time, saturates and packs four bytes at a time (cvt.pack.sat) and
// stores its 3 * RUN RGB bytes as three words (16 bytes each at RUN 16).
// Bitwise the plain version (ycc_to_rgb_u8_ref).
template <int HS, int VS, int RUN>
__global__ void __launch_bounds__(kYccThreads) ycc_to_rgb_kernel(
    const uint8_t* __restrict__ yp, const uint8_t* __restrict__ cbp,
    const uint8_t* __restrict__ crp, int nframes, int h, int w, int ch,
    int cw, bool aligned, bool chroma_words, uint8_t* __restrict__ rgb) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kCols = RUN / HS + 2;  // chroma columns a run reads
  constexpr bool kStaged = RUN == 16;
  const int runs = blockDim.x, rows = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y0 = blockIdx.x * rows;
  const int x0 = blockIdx.y * runs * RUN;
  // staged chroma: slot s of a plane holds chroma row r_lo - 1 + s (VS 2;
  // VS 1: r_lo + s), clamped; byte j of a slot chroma column c_lo - 4 + j,
  // clamped (c_lo is a multiple of 8, so a slot's words are the row's
  // words); slots of `words` 32-bit words
  const int r_lo = y0 / VS, c_lo = x0 / HS;
  const int nslots =
      VS == 2 ? (min(y0 + rows, h) - 1) / 2 - r_lo + 3 : min(rows, h - y0);
  const int words = (runs * RUN / HS + 5 + 3) / 4;
  uint32_t* stage[2] = {reinterpret_cast<uint32_t*>(smem),
                        reinterpret_cast<uint32_t*>(smem) + nslots * words};
  const size_t luma = static_cast<size_t>(h) * w;
  const size_t chroma = static_cast<size_t>(ch) * cw;
  const int y = y0 + ty, x = x0 + tx * RUN;
  const bool active = y < h && x < w;
  const int count = active ? min(RUN, w - x) : 0;
  for (int f = blockIdx.z; f < nframes; f += gridDim.z) {
    // the run's luma first, so its load overlaps the staging
    uint32_t lw[RUN / 4];
    const uint8_t* ysrc = yp + f * luma + static_cast<size_t>(y) * w + x;
    if (active && aligned && count == RUN) {
      if constexpr (RUN == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(ysrc));
        lw[0] = v.x;
        lw[1] = v.y;
        lw[2] = v.z;
        lw[3] = v.w;
      } else {
        lw[0] = __ldg(reinterpret_cast<const uint32_t*>(ysrc));
      }
    } else {
#pragma unroll
      for (int i = 0; i < RUN / 4; ++i) lw[i] = 0;
      for (int i = 0; i < count; ++i) {
        lw[i >> 2] |= static_cast<uint32_t>(ysrc[i]) << (8 * (i & 3));
      }
    }
    if constexpr (kStaged) {
      for (int p = 0; p < 2; ++p) {
        const uint8_t* plane = (p ? crp : cbp) + f * chroma;
        for (int s = ty; s < nslots; s += rows) {
          const int r = min(max(r_lo + s - (VS == 2 ? 1 : 0), 0), ch - 1);
          const uint8_t* src = plane + static_cast<size_t>(r) * cw;
          for (int q = tx; q < words; q += runs) {
            const int c = c_lo - 4 + 4 * q;
            uint32_t word;
            if (chroma_words && c >= 0 && c + 4 <= cw) {
              word = __ldg(reinterpret_cast<const uint32_t*>(src + c));
            } else {  // the edges, clamped
              word = 0;
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                word |= static_cast<uint32_t>(
                            src[min(max(c + b, 0), cw - 1)]) << (8 * b);
              }
            }
            stage[p][s * words + q] = word;
          }
        }
      }
      __syncthreads();
    }
    if (active) {
      // the chroma column sums of the run's columns (3 * near row + far
      // row where VS is 2, the samples where it is 1): sum[p][j] is column
      // x / HS - 1 + j of Cb (p 0) or Cr (p 1), staged byte x / HS - 1 -
      // (c_lo - 4), byte 3 of the slot's word q0
      int sum[2][kCols];
      const int q0 = tx * (RUN / HS) / 4;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint8_t* plane = (p ? crp : cbp) + f * chroma;
        const int c0 = x / HS - 1;
        if (VS == 2) {
          int n[kCols], fv[kCols];
          if constexpr (kStaged) {
            const int near = y / 2 - r_lo + 1;
            const int far = (y & 1) ? near + 1 : near - 1;
            staged_bytes(stage[p] + near * words + q0, n);
            staged_bytes(stage[p] + far * words + q0, fv);
          } else {
            const int near = y / 2;
            const int far = (y & 1) ? min(near + 1, ch - 1) : max(near - 1, 0);
            row_bytes(plane + static_cast<size_t>(near) * cw, c0, cw, n);
            row_bytes(plane + static_cast<size_t>(far) * cw, c0, cw, fv);
          }
#pragma unroll
          for (int i = 0; i < kCols; ++i) sum[p][i] = 3 * n[i] + fv[i];
        } else if constexpr (kStaged) {
          staged_bytes(stage[p] + (y - y0) * words + q0, sum[p]);
        } else {
          row_bytes(plane + static_cast<size_t>(y) * cw, c0, cw, sum[p]);
        }
      }
      // four pixels (a luma word, three RGB words) at a time
      uint32_t ow[3 * RUN / 4];
#pragma unroll
      for (int g = 0; g < RUN / 4; ++g) {
        int px[12];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 4 * g + k;
          int up[2];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int c = i / HS + 1;  // this pixel's column in sum[p]
            const int nb = (i & 1) ? c + 1 : c - 1;
            if (HS == 1) {
              up[p] = sum[p][c];
            } else if (VS == 2) {  // (3 * sum[c] + nb + 8 | 7) >> 4
              up[p] = (3 * sum[p][c] + sum[p][nb] + ((i & 1) ? 7 : 8)) >> 4;
            } else {  // (3 * v[c] + nb + 1 | 2) >> 2
              up[p] = (3 * sum[p][c] + sum[p][nb] + ((i & 1) ? 2 : 1)) >> 2;
            }
          }
          const int l = static_cast<int>((lw[g] >> (8 * k)) & 0xFF);
          px[3 * k] = l + ((91881 * up[1] + (32768 - 91881 * 128)) >> 16);
          px[3 * k + 1] = l + ((-22554 * up[0] - 46802 * up[1] +
                                (32768 + (22554 + 46802) * 128)) >> 16);
          px[3 * k + 2] =
              l + ((116130 * up[0] + (32768 - 116130 * 128)) >> 16);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ow[3 * g + k] = pack4_u8(px[4 * k], px[4 * k + 1], px[4 * k + 2],
                                   px[4 * k + 3]);
        }
      }
      uint8_t* dst = rgb + (f * luma + static_cast<size_t>(y) * w + x) * 3;
      if (aligned && count == RUN) {
        if constexpr (RUN == 16) {
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            reinterpret_cast<uint4*>(dst)[i] = make_uint4(
                ow[4 * i], ow[4 * i + 1], ow[4 * i + 2], ow[4 * i + 3]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 3 * RUN / 4; ++i) {
            reinterpret_cast<uint32_t*>(dst)[i] = ow[i];
          }
        }
      } else {
        for (int k = 0; k < count * 3; ++k) {
          dst[k] = static_cast<uint8_t>((ow[k >> 2] >> (8 * (k & 3))) & 0xFF);
        }
      }
    }
    if constexpr (kStaged) __syncthreads();  // restaged for the next frame
  }
}

template <int HS, int VS, int RUN>
cudaError_t launch_ycc_run(const uint8_t* y, const uint8_t* cb,
                          const uint8_t* cr, int nframes, int h, int w,
                          int ch, int cw, uint8_t* rgb, cudaStream_t stream) {
  const int run_count = (w + RUN - 1) / RUN;
  const int runs = std::min(run_count, kYccRuns);
  int rows = std::max(1, std::min(h, kYccThreads / runs));
  if (VS == 2 && rows > 1) rows &= ~1;
  const int nslots = VS == 2 ? rows / 2 + 3 : rows;
  const int words = (runs * RUN / HS + 5 + 3) / 4;
  const dim3 grid((h + rows - 1) / rows, (run_count + runs - 1) / runs,
                  std::min(nframes, 65535));
  const bool aligned = w % RUN == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(rgb) % 16 == 0;
  const bool chroma_words = cw % 4 == 0 &&
                            reinterpret_cast<uintptr_t>(cb) % 4 == 0 &&
                            reinterpret_cast<uintptr_t>(cr) % 4 == 0;
  const int smem = RUN == 16 ? 2 * nslots * words * 4 : 0;  // staged at 16
  ycc_to_rgb_kernel<HS, VS, RUN><<<grid, dim3(runs, rows), smem, stream>>>(
      y, cb, cr, nframes, h, w, ch, cw, aligned, chroma_words, rgb);
  return cudaGetLastError();
}

template <int HS, int VS>
cudaError_t launch_ycc_as(const uint8_t* y, const uint8_t* cb,
                          const uint8_t* cr, int nframes, int h, int w,
                          int ch, int cw, uint8_t* rgb, cudaStream_t stream) {
  const int64_t wide = static_cast<int64_t>(nframes) * h * ((w + 15) / 16);
  if (wide >= kYccWideRuns) {
    return launch_ycc_run<HS, VS, 16>(y, cb, cr, nframes, h, w, ch, cw, rgb,
                                     stream);
  }
  return launch_ycc_run<HS, VS, 4>(y, cb, cr, nframes, h, w, ch, cw, rgb,
                                  stream);
}

// One colour launch: nframes frames' Y (h, w) and Cb, Cr (ch, cw) planes,
// each plane's frames contiguous; (hs, vs) the chroma factors.
cudaError_t launch_ycc(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                       int nframes, int h, int w, int ch, int cw, int hs,
                       int vs, uint8_t* rgb, cudaStream_t stream) {
  if (hs == 2 && vs == 2) {
    return launch_ycc_as<2, 2>(y, cb, cr, nframes, h, w, ch, cw, rgb, stream);
  }
  if (hs == 2 && vs == 1) {
    return launch_ycc_as<2, 1>(y, cb, cr, nframes, h, w, ch, cw, rgb, stream);
  }
  if (hs == 1 && vs == 1) {
    return launch_ycc_as<1, 1>(y, cb, cr, nframes, h, w, ch, cw, rgb, stream);
  }
  return cudaErrorInvalidValue;
}

// One resize launch: sc 1 or 3 channels in, three out.
cudaError_t launch_resize(const uint8_t* src, int n, int sh, int sw, int sc,
                          uint8_t* dst, int dh, int dw, cudaStream_t stream) {
  if (sc == 3) return launch_resize_as<3>(src, n, sh, sw, dst, dh, dw, stream);
  if (sc == 1) return launch_resize_as<1>(src, n, sh, sw, dst, dh, dw, stream);
  return cudaErrorInvalidValue;
}

struct Decoder {
  int device = 0;
  cudaStream_t stream = nullptr;
  cudaEvent_t ready = nullptr;  // the caller's stream, at the call
  cudaEvent_t done = nullptr;   // this stream, at the call's last launch
  uint8_t* staging = nullptr;  // a chunk's frames at source size, 1 or 3 ch
                               // (a gray plane, or RGB)
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

// A call's kernel launches, and the host's wall seconds in its two
// phases: reading the files and parsing their headers, and the entropy
// decode (with block smoothing) of every chunk.
struct Launches {
  int idct = 0, ycc = 0, resize = 0;
  double read_s = 0, entropy_s = 0;
};

double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
      .count();
}

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

// Frames [first, first + count) of one geometry: entropy decode on the
// host into a pinned buffer, one copy to the card, the IDCT per component,
// one colour conversion for a colour chunk, one resize into `out`.
int decode_chunk(Decoder* dec, const std::vector<Frame>& frames, int first,
                 int count, int n_threads, int dh, int dw, uint8_t* out,
                 Launches* launches) {
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
  const auto t0 = std::chrono::steady_clock::now();
  const int rc = ammc_jpeg::parallel_for(count, n_threads, [&](int f) {
    const Frame& fr = frames[first + f];
    int16_t* coefs[ammc_jpeg::kMaxComps];
    uint16_t* qts[ammc_jpeg::kMaxComps];
    size_t blocks[ammc_jpeg::kMaxComps];
    for (int c = 0; c < nc; ++c) {
      blocks[c] = static_cast<size_t>(info.comp[c].blocks_h) *
                  info.comp[c].blocks_w;
      coefs[c] = reinterpret_cast<int16_t*>(host + coef_off[c]) +
                 f * blocks[c] * 64;
      qts[c] = reinterpret_cast<uint16_t*>(host + qt_off) +
               (static_cast<size_t>(c) * count + f) * 64;
    }
    ammc_jpeg::Smoothing sm;
    const int frc = ammc_jpeg::decode_coefs(fr.data.data(), fr.data.size(),
                                            info, coefs, qts, &sm);
    if (frc != kOk || !sm.apply) return frc;
    // libjpeg smooths this frame at output: the blocks as decoded move to
    // a copy, and the smoothed ones, which read the copy, go to the card
    std::vector<int16_t> decoded[ammc_jpeg::kMaxComps];
    const int16_t* unsmoothed[ammc_jpeg::kMaxComps];
    for (int c = 0; c < nc; ++c) {
      decoded[c].assign(coefs[c], coefs[c] + blocks[c] * 64);
      unsmoothed[c] = decoded[c].data();
    }
    ammc_jpeg::smooth_frame(info, unsmoothed, coefs, qts, sm);
    return static_cast<int>(kOk);
  });
  launches->entropy_s += seconds_since(t0);
  if (rc != kOk) return rc;
  if (reserve(dec, &dec->coefs, &dec->coefs_bytes, bytes) != cudaSuccess ||
      cudaMemcpyAsync(dec->coefs, host, bytes, cudaMemcpyHostToDevice,
                      dec->stream) != cudaSuccess ||
      cudaEventRecord(dec->copied[slot], dec->stream) != cudaSuccess) {
    return kCuda;
  }
  const int sh = info.height, sw = info.width, sc = nc == 1 ? 1 : 3;
  const size_t frame_in = static_cast<size_t>(sh) * sw * sc;  // staged
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
    if (launch_ycc(y, cb, cr, count, sh, sw, ch, cw, hs, vs, dec->staging,
                   dec->stream) != cudaSuccess) {
      return kCuda;
    }
    ++launches->ycc;
  }
  // a gray frame's plane to RGB, as the host resizes libjpeg's RGB decode
  if (launch_resize(dec->staging, count, sh, sw, sc, out, dh, dw,
                    dec->stream) != cudaSuccess) {
    return kCuda;
  }
  ++launches->resize;
  return kOk;
}

int decode_frames(Decoder* dec, const std::vector<Frame>& frames,
                  int n_threads, int dh, int dw, uint8_t* out,
                  Launches* launches) {
  const size_t frame_out = static_cast<size_t>(dh) * dw * 3;
  const int n = static_cast<int>(frames.size());
  for (int first = 0; first < n;) {
    int end = first + 1;
    while (end < n && end - first < kChunkFrames &&
           same_geometry(frames[first].info, frames[end].info)) {
      ++end;
    }
    const int rc = decode_chunk(dec, frames, first, end - first, n_threads,
                                dh, dw, out + frame_out * first, launches);
    if (rc != kOk) return rc;
    first = end;
  }
  return kOk;
}

int decode_video(Decoder* dec, const char** paths, int n, int dh, int dw,
                 int n_threads, uint8_t* out, cudaStream_t caller,
                 Launches* launches) {
  if (cudaSetDevice(dec->device) != cudaSuccess) return kCuda;
  std::vector<Frame> frames;
  const auto t0 = std::chrono::steady_clock::now();
  int rc = read_frames(paths, n, n_threads, &frames);
  launches->read_s += seconds_since(t0);
  if (rc != kOk) return rc;
  // `out` may still be in use by work queued on the caller's stream
  if (cudaEventRecord(dec->ready, caller) != cudaSuccess ||
      cudaStreamWaitEvent(dec->stream, dec->ready, 0) != cudaSuccess) {
    return kCuda;
  }
  rc = decode_frames(dec, frames, n_threads, dh, dw, out, launches);
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

// JPEG files -> out, a device buffer that gets (n, out_h, out_w, 3) u8 RGB,
// a grayscale frame's plane resized to three channels as the host route
// resizes libjpeg's RGB decode of it.  The entropy decode (and the block
// smoothing of a progressive frame that libjpeg smooths) runs on n_threads
// host threads.  The decode waits for the work queued on `stream` (the
// caller's) so far, and `stream` waits for the decode.  *idct_launches,
// *launches and *ycc_launches get the IDCT, the resize and the colour
// kernel's launches, host_s[0] and host_s[1] the host's seconds reading
// the files (and their headers) and entropy-decoding them.  Returns 0 or
// an error code (above).
int ammc_gpu_decode_video(void* handle, const char** paths, int n, int out_h,
                          int out_w, int n_threads, void* out, void* stream,
                          int* idct_launches, int* launches,
                          int* ycc_launches, double* host_s) {
  auto* dec = static_cast<Decoder*>(handle);
  std::lock_guard<std::mutex> lock(dec->mu);
  Launches counts;
  const int rc = decode_video(dec, paths, n, out_h, out_w, n_threads,
                              static_cast<uint8_t*>(out),
                              static_cast<cudaStream_t>(stream), &counts);
  *idct_launches = counts.idct;
  *launches = counts.resize;
  *ycc_launches = counts.ycc;
  host_s[0] = counts.read_s;
  host_s[1] = counts.entropy_s;
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

// The colour kernel alone on device buffers: y (nframes, h, w), cb and cr
// (nframes, ch, cw) u8, contiguous, (hs, vs) the chroma factors; rgb
// (nframes, h, w, 3) u8; on the caller's stream, one launch.  Returns a
// cudaError_t.
int ammc_ycc_to_rgb(const void* y, const void* cb, const void* cr,
                    int nframes, int h, int w, int ch, int cw, int hs, int vs,
                    void* rgb, void* stream) {
  return launch_ycc(static_cast<const uint8_t*>(y),
                    static_cast<const uint8_t*>(cb),
                    static_cast<const uint8_t*>(cr), nframes, h, w, ch, cw, hs,
                    vs, static_cast<uint8_t*>(rgb),
                    static_cast<cudaStream_t>(stream));
}

// The resize kernel alone on device buffers: src (n, sh, sw, sc) u8, dst
// (n, dh, dw, 3) u8, sc 1 or 3, on the caller's stream, one launch.
// Returns a cudaError_t.
int ammc_resize_bilinear_u8(const void* src, int n, int sh, int sw, int sc,
                            void* dst, int dh, int dw, void* stream) {
  return launch_resize(static_cast<const uint8_t*>(src), n, sh, sw, sc,
                       static_cast<uint8_t*>(dst), dh, dw,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
