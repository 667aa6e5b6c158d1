// FlowNetC's correlation layer on the bf16 tensor cores.
//
// flownet2-pytorch's correlation_package as FlowNet 2.0's FlowNetC uses it
// (pad 20, kernel 1, max displacement 20, stride1 1, stride2 2): for two
// bf16 maps f1, f2 (B, C, H, W), NCHW contiguous,
//
//   out[b, i * 21 + j, y, x] = (1 / C) sum_c f1[b, c, y, x] *
//                                            f2[b, c, y + 2i - 20, x + 2j - 20]
//
// with f2 zero outside the map, optionally LeakyReLU(0.1) (FlowNetC's
// corr_activation), stored as bf16 (B, 441, H, W); the sums in float32.
//
// It replaces no TPU kernel: the JAX package has FlowNet2-SD alone, which
// has no correlation.  No one PyTorch call computes it; its plain version
// (ops/correlation.py) is 441 shifted products over C channels.
//
// What bounds it: at FlowNet 2.0's shape for a 16-pair chunk of 256x256
// frames (C 256, 32x32) it reads 16.8 MB and writes 14.4 MB, against
// 2 * 441 * 256 * 1024 * 16 = 3.7 GFLOP: 9.4 us of bytes at 3.35 TB/s, 3.7
// us of bf16 products at 989 TFLOP/s, so the bytes bound it (about 0.58 us a
// pair).  The plain form moves about 7 GB.
//
// The design: a block takes up to four output rows of one parity, y_k =
// y0 + 2k, of one image (grid: groups of rows x images).  For each
// displacement row the products of an output row are a banded matrix
// product, f1's row (W pixels x C channels) times the zero-padded row r =
// y + 2i - 20 of f2 ((W + 40) pixels x C)^T, of which the kernel keeps the
// 21 diagonals at stride 2 (column x + 2j of row x); rows of one parity
// meet the same rows of f2, so the block walks over the f2 rows r that any
// of its output rows meets (up to 24 for 21 displacements of 4 rows) and
// multiplies each, once in shared memory, with every output row it serves.
// A 16-pixel tile of f1's row meets 56 columns of f2's, 7 mma.sync
// m16n8k16 column tiles, so the tensor cores compute 56 products a pixel
// where 21 are kept (a 16-pair chunk: about 7.5 GFLOP, the displacement
// rows outside the map skipped).  Measured on an H100 at (16, 256, 32, 32):
// 67 us, 14 % of the bytes' bound; what limits it is the ldmatrix traffic
// (1.5 KB a k step for four mma, 56 columns loaded for 21 kept) and the
// barriers between displacement rows.  A warp takes one output row's 16-pixel
// tile and three or four of its column tiles: one A fragment a k step
// feeds three or four independent accumulators, and the next k step's
// fragments are loaded before this one's products are issued.  Both
// operands sit in shared memory pixel-major with channels contiguous
// (transposed from NCHW on the way in: a thread's two 16-byte loads of a
// channel pair along a row become eight 4-byte words, both channels of a
// pixel), so ldmatrix reads A and B with no transpose, 16 bytes of padding
// a row keeping its eight rows on distinct banks.  Each thread's share of
// the loads and of the output is planned once a block.  The f1 rows are read once; the f2 rows are
// double-buffered: the next one's 16-byte loads are in flight in registers
// while the tensor cores work on the current one, then stored to the other
// buffer.  A displacement row that falls outside the map is written as
// zeros with no products.  The kept diagonals go to shared memory and are
// written out as whole rows of the output (21 rows of W bf16 a
// displacement row, two pixels a 4-byte store), each divided by C (a
// multiply by 1 / C where C is a power of two, which is exact, else IEEE
// division, as the plain version's) and passed through the LeakyReLU in
// float32 before the one rounding to bf16.  Only the margins of the shared
// buffers are zeroed.  A block holds four output rows where they fit in
// shared memory (W <= 32 at C 256), else two or one.
//
// Against the plain version: the products of two bf16 values are exact in
// float32, so the two differ only in the order of the float32 sum over C
// (the tensor cores' k16 steps against ATen's sum) and so, after the
// division, by at most one bf16 rounding step where the float32 results
// straddle a rounding boundary (tests/test_torch_cuda.py states the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDisp = 20;                        // max displacement, px
constexpr int kStep = 2;                            // stride2
constexpr int kSide = 2 * kMaxDisp / kStep + 1;     // 21 displacements an axis
constexpr int kTaps = kSide * kSide;                // 441 output channels
constexpr int kBand = 2 * kMaxDisp;                 // kept columns x .. x + 40
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kPitchPad = 8;                        // bf16 of padding a smem row

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kMaxUnits = 2;  // channel-pair loads a thread moves a row
constexpr int kMaxOut = 2;    // output pixel pairs a thread writes a row

// A thread's share of moving one row of a map, (C, W) of one image at one
// y, into shared memory pixel-major: unit u = tid + m * kThreads is the
// channel pair (2 cp, 2 cp + 1) at pixels 8 xv .. 8 xv + 7, cp = u / (W /
// 8) (so the lanes of a warp read whole 64-byte runs of a channel's row);
// its two 16-byte loads become eight 4-byte words (both channels of one
// pixel) in shared memory.  Fixed for the block, so computed once.
struct RowPlan {
  int n;                   // units this thread moves
  int goff[kMaxUnits];     // element offset of channel 2 cp, pixel 8 xv
  int soff[kMaxUnits];     // word offset of pixel 8 xv, channel pair cp
};

__device__ __forceinline__ RowPlan row_plan(int C, int W, int plane, int pitch) {
  RowPlan p;
  const int wv = W / 8, units = (C / 2) * wv;
  p.n = 0;
#pragma unroll
  for (int m = 0; m < kMaxUnits; ++m) {
    const int u = threadIdx.x + m * kThreads;
    if (u < units) {
      const int cp = u / wv, xv = u - cp * wv;
      p.goff[m] = 2 * cp * plane + 8 * xv;
      p.soff[m] = 8 * xv * (pitch / 2) + cp;
      p.n = m + 1;
    }
  }
  return p;
}

__device__ __forceinline__ void load_row(uint4 (&regs)[2 * kMaxUnits],
                                         const __nv_bfloat16* __restrict__ src,
                                         const RowPlan& p, int plane) {
#pragma unroll
  for (int m = 0; m < kMaxUnits; ++m) {
    if (m < p.n) {
      regs[2 * m] = __ldg(reinterpret_cast<const uint4*>(src + p.goff[m]));
      regs[2 * m + 1] = __ldg(reinterpret_cast<const uint4*>(src + p.goff[m] + plane));
    }
  }
}

__device__ __forceinline__ void store_row(const uint4 (&regs)[2 * kMaxUnits],
                                          uint32_t* dst, const RowPlan& p,
                                          int pitch) {
  const int wp = pitch / 2;  // words a pixel
#pragma unroll
  for (int m = 0; m < kMaxUnits; ++m) {
    if (m < p.n) {
      const uint32_t e[4] = {regs[2 * m].x, regs[2 * m].y, regs[2 * m].z, regs[2 * m].w};
      const uint32_t o[4] = {regs[2 * m + 1].x, regs[2 * m + 1].y, regs[2 * m + 1].z,
                             regs[2 * m + 1].w};
      uint32_t* d = dst + p.soff[m];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        d[(2 * q) * wp] = __byte_perm(e[q], o[q], 0x5410);      // pixel 2q
        d[(2 * q + 1) * wp] = __byte_perm(e[q], o[q], 0x7632);  // pixel 2q + 1
      }
    }
  }
}

// A thread's output pixel pairs of one displacement row (21 x W values):
// pair v = tid + m * kThreads is output channel j = v / (W / 2), pixels 2 xp,
// 2 xp + 1.
struct OutPlan {
  int n;
  int so[kMaxOut];  // float offset in the staged [21][W] row
  int go[kMaxOut];  // element offset j * plane + 2 xp
};

__device__ __forceinline__ OutPlan out_plan(int W, int plane) {
  OutPlan p;
  const int wp = W / 2;
  p.n = 0;
#pragma unroll
  for (int m = 0; m < kMaxOut; ++m) {
    const int v = threadIdx.x + m * kThreads;
    if (v < kSide * wp) {
      const int j = v / wp, xp = v - j * wp;
      p.so[m] = j * W + 2 * xp;
      p.go[m] = j * plane + 2 * xp;
      p.n = m + 1;
    }
  }
  return p;
}

__device__ __forceinline__ void zero_words(uint4* p, int n16) {
  for (int e = threadIdx.x; e < n16; e += kThreads) p[e] = make_uint4(0, 0, 0, 0);
}

__host__ __device__ __forceinline__ int padded_width(int w) { return (w + 15) & ~15; }

size_t smem_bytes(int c, int w, int rows) {
  const int wpad = padded_width(w);
  const int cols = wpad + kBand;
  return static_cast<size_t>(rows * wpad + 2 * cols) * (c + kPitchPad) * 2 +
         static_cast<size_t>(rows) * kSide * w * 4;
}

// A warp's products of one 16-pixel tile of an output row with nn <= 4
// column tiles of an f2 row: A fragments (pa) and B fragments (pb, column
// tile n at pb + n * 8 * pitch) one k step ahead of the products.
__device__ __forceinline__ void tile_products(float (&acc)[4][4], const uint16_t* pa,
                                              const uint16_t* pb, int pitch, int C,
                                              int nn) {
  uint32_t a0[4], a1[4], b0[4][2], b1[4][2];
  const auto load = [&](uint32_t (&a)[4], uint32_t (&bq)[4][2], int k0) {
    ldmatrix_x4(a, pa + k0);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n < nn) ldmatrix_x2(bq[n], pb + n * 8 * pitch + k0);
    }
  };
  const auto products = [&](const uint32_t (&a)[4], const uint32_t (&bq)[4][2]) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n < nn) mma_bf16(acc[n], a, bq[n]);
    }
  };
  load(a0, b0, 0);
  for (int k0 = 0; k0 < C; k0 += 32) {
    const bool next = k0 + 16 < C;
    if (next) load(a1, b1, k0 + 16);
    products(a0, b0);
    if (next) {
      if (k0 + 32 < C) load(a0, b0, k0 + 32);
      products(a1, b1);
    }
  }
}

// rows output rows y0, y0 + 2, ... a block (grid.x: row groups of both
// parities, grid.y: images)
__global__ void __launch_bounds__(kThreads, 1)
correlation_kernel(const __nv_bfloat16* __restrict__ f1,
                   const __nv_bfloat16* __restrict__ f2,
                   __nv_bfloat16* __restrict__ out, int C, int H, int W,
                   int rows, int leaky) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int groups = ((H + 1) / 2 + rows - 1) / rows;  // of parity 0
  const int parity = blockIdx.x >= groups;
  const int y0 = parity + 2 * rows * (blockIdx.x - parity * groups);
  const int nrows = min(rows, (H - y0 + 1) / 2);  // y0 + 2 (nrows - 1) < H
  const int wpad = padded_width(W), cols = wpad + kBand, pitch = C + kPitchPad;
  uint16_t* sa = reinterpret_cast<uint16_t*>(smem);   // [rows][wpad][pitch]
  uint16_t* sb0 = sa + rows * wpad * pitch;           // [cols][pitch], twice
  uint16_t* sb1 = sb0 + cols * pitch;
  float* so = reinterpret_cast<float*>(sb1 + cols * pitch);  // [rows][21][W]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int plane = H * W;
  const size_t image = static_cast<size_t>(b) * C * plane;
  __nv_bfloat16* oimg = out + static_cast<size_t>(b) * kTaps * plane;
  const RowPlan rp = row_plan(C, W, plane, pitch);
  const OutPlan op = out_plan(W, plane);

  // the displacement rows of each output row that fall outside the map
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.0f);
  for (int k = 0; k < nrows; ++k) {
    const int y = y0 + 2 * k;
    for (int i = 0; i < kSide; ++i) {
      const int r = y + kStep * i - kMaxDisp;
      if (r >= 0 && r < H) continue;
      __nv_bfloat16* o = oimg + static_cast<size_t>(i) * kSide * plane + y * W;
#pragma unroll
      for (int m = 0; m < kMaxOut; ++m) {
        if (m < op.n) *reinterpret_cast<__nv_bfloat162*>(o + op.go[m]) = zero2;
      }
    }
  }

  // zero f1's padding pixels and both f2 buffers' columns outside the map
  // (each f2 row stores columns 20 .. 20 + W - 1 alone)
  const int row16 = pitch / 8;  // 16-byte words a pixel
  for (int k = 0; k < rows; ++k) {
    zero_words(reinterpret_cast<uint4*>(sa + (k * wpad + W) * pitch), (wpad - W) * row16);
  }
  for (int buf = 0; buf < 2; ++buf) {
    uint16_t* sb = buf ? sb1 : sb0;
    zero_words(reinterpret_cast<uint4*>(sb), kMaxDisp * row16);
    zero_words(reinterpret_cast<uint4*>(sb + (kMaxDisp + W) * pitch),
               (cols - kMaxDisp - W) * row16);
  }

  uint4 regs[2 * kMaxUnits];
  for (int k = 0; k < nrows; ++k) {
    load_row(regs, f1 + image + (y0 + 2 * k) * W, rp, plane);
    store_row(regs, reinterpret_cast<uint32_t*>(sa + k * wpad * pitch), rp, pitch);
  }
  // the f2 rows r0, r0 + 2, ..., r1 that some output row meets
  int r0 = y0 - kMaxDisp, r1 = y0 + 2 * (nrows - 1) + kMaxDisp;
  while (r0 < 0) r0 += kStep;
  while (r1 >= H) r1 -= kStep;
  load_row(regs, f2 + image + r0 * W, rp, plane);
  store_row(regs, reinterpret_cast<uint32_t*>(sb0 + kMaxDisp * pitch), rp, pitch);

  const int mtiles = wpad / 16;
  const int tasks = nrows * mtiles * 2;  // (row, 16-px tile, column tiles 0-3 | 4-6)
  const int g = lane >> 2, t = lane & 3;
  // the division by C: a multiply where C is a power of two (exact)
  const bool pow2 = (C & (C - 1)) == 0;
  const float inv_c = 1.0f / static_cast<float>(C);
  int cur = 0;
  for (int r = r0; r <= r1; r += kStep) {
    __syncthreads();  // this row's buffer stored; the last outputs read from so
    if (r < r1) load_row(regs, f2 + image + (r + kStep) * W, rp, plane);
    const uint16_t* sbc = cur ? sb1 : sb0;
    for (int task = warp; task < tasks; task += kWarps) {
      const int k = task / (2 * mtiles), rem = task - k * 2 * mtiles;
      const int mt = rem >> 1, half = rem & 1;
      const int i2 = r - (y0 + 2 * k) + kMaxDisp;  // 2 i
      if (i2 < 0 || i2 > 2 * kMaxDisp) continue;
      const int x0 = mt * 16, n0 = x0 + half * 32, nn = half ? 3 : 4;
      float acc[4][4] = {};
      tile_products(acc,
                    sa + (k * wpad + x0 + (lane & 15)) * pitch + ((lane >> 4) << 3),
                    sbc + (n0 + (lane & 7)) * pitch + (((lane >> 3) & 1) << 3), pitch,
                    C, nn);
      float* sok = so + k * kSide * W;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = x0 + g + ((q >> 1) << 3);
          const int d = n0 + n * 8 + 2 * t + (q & 1) - x;
          if (n < nn && x < W && d >= 0 && d <= kBand && !(d & 1)) {
            sok[(d >> 1) * W + x] = acc[n][q];
          }
        }
      }
    }
    __syncthreads();  // so complete; every warp done with this row's buffer
    for (int k = 0; k < nrows; ++k) {
      const int y = y0 + 2 * k, i2 = r - y + kMaxDisp;
      if (i2 < 0 || i2 > 2 * kMaxDisp) continue;
      __nv_bfloat16* oi = oimg + static_cast<size_t>(i2 >> 1) * kSide * plane + y * W;
      const float* sok = so + k * kSide * W;
#pragma unroll
      for (int m = 0; m < kMaxOut; ++m) {
        if (m < op.n) {
          const float2 s2 = *reinterpret_cast<const float2*>(sok + op.so[m]);
          float v0 = pow2 ? s2.x * inv_c : s2.x / static_cast<float>(C);
          float v1 = pow2 ? s2.y * inv_c : s2.y / static_cast<float>(C);
          if (leaky) {
            if (v0 < 0.0f) v0 *= 0.1f;
            if (v1 < 0.0f) v1 *= 0.1f;
          }
          *reinterpret_cast<__nv_bfloat162*>(oi + op.go[m]) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    if (r < r1) {
      store_row(regs, reinterpret_cast<uint32_t*>((cur ? sb0 : sb1) + kMaxDisp * pitch), rp,
                pitch);
    }
    cur ^= 1;
  }
}

}  // namespace

extern "C" {

// The output rows a block takes: four where they fit in a block's shared
// memory, else two or one (0: not even one fits).
int block_rows(int c, int w) {
  for (int rows = 4; rows >= 1; rows /= 2) {
    if (smem_bytes(c, w, rows) <= 232448) return rows;
  }
  return 0;
}

// f1, f2 (B, C, H, W) bf16, NCHW contiguous, 16-byte aligned; out (B, 441,
// H, W) bf16.  C % 16 == 0, W % 8 == 0, C * W <= 16,384 and W <= 96 (the
// loads and stores a thread plans), C * H * W < 2^31, one output row's
// block in 227 KB of shared memory (see
// ammc_correlation_block_rows).  On the caller's stream; returns a
// cudaError_t (cudaErrorInvalidValue for a shape it does not take).
int ammc_correlation(const void* f1, const void* f2, void* out, int B, int C,
                     int H, int W, int leaky, void* stream) {
  const int rows = (C > 0 && W > 0) ? block_rows(C, W) : 0;
  if (B <= 0 || B > 65535 || C <= 0 || C % 16 || H <= 0 || H > 65535 ||
      W <= 0 || W % 8 || (C / 2) * (W / 8) > kMaxUnits * kThreads ||
      kSide * (W / 2) > kMaxOut * kThreads ||
      static_cast<int64_t>(C) * H * W > INT32_MAX || rows == 0 ||
      (reinterpret_cast<uintptr_t>(f1) & 15) ||
      (reinterpret_cast<uintptr_t>(f2) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_bytes(C, W, rows);
  static size_t opted = 0;
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        correlation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = bytes;
  }
  const int groups = ((H + 1) / 2 + rows - 1) / rows + (H / 2 + rows - 1) / rows;
  correlation_kernel<<<dim3(groups, B), kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2),
      static_cast<__nv_bfloat16*>(out), C, H, W, rows, leaky);
  return static_cast<int>(cudaGetLastError());
}

int ammc_correlation_block_rows(int C, int W) { return block_rows(C, W); }

const char* ammc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
