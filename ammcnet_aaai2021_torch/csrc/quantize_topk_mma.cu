// Fused top-k memory lookup for bf16 latents on Hopper's tensor cores
// (sm_90a, warp-level mma.sync): distance, top-k and gather in one pass.
//
// Kernel B1, tensor-core route.  It replaces the Pallas TPU kernel
// `_quantize_kernel` called by `quantize_topk_pallas`
// (ammcnet_aaai2021_tpu/ops/memory_pallas.py:48-82, :201-255) for bf16
// latents of width 64 with k <= 4; float32 latents and larger k take the
// CUDA-core kernel in quantize_topk.cu.  The routing rule is
// `lookup_route` in ammcnet_aaai2021_torch/ops/memory_kernels.py.
//
// It computes what the CUDA-core kernel computes: for each latent row z
// (64 bf16) against the codebook E (64, n_embed) f32 the ranking distance
//     dist[j] = fmaf(-2, z.E[:, j], ||E[:, j]||^2)    (f32; ||z||^2 dropped)
// with ||E[:, j]||^2 summed in f32 from the f32 codebook once per block, k
// rounds of "smallest, lowest index on ties", and the chosen codewords:
// q_topk (N, k*64) f32, q1 (N, 64) f32 (the top-1 codeword), idx (N,)
// int32.  Rows past N are neither read nor written.
//
// What bounds it on this card.  At the scoring path's shape (N = 196,608,
// n_embed 256, k 2) the compulsory traffic is
//     N*64*2 (z) + 64*256*4 (E) + N*2*64*4 (q_topk) + N*64*4 (q1) + N*4
//     = 177,012,736 B, i.e. 52.8 us at 3.35 TB/s,
// 151 MB of it the f32 outputs.  The products, three bf16 passes (below),
// are 3 * 2*N*64*256 = 19.3 GFLOP, 19.5 us at the 989 TFLOP/s bf16 dense
// peak.  So the bytes bound it, by 2.7x; the CUDA-core kernel, whose
// 6.4 GFLOP of f32 FMA alone need 96 us at 67 TFLOP/s, cannot reach that.
//
// What the design does about it.
//  * fp32-accurate products on bf16 tensor cores.  Each block splits the
//    f32 codebook once, as it loads it into shared memory, into three bf16
//    parts: hi = bf16(E), mid = bf16(E - hi), lo = bf16(E - hi - mid).
//    Each subtraction is exact in f32, and hi + mid + lo == E exactly for
//    every entry that is 0 or of magnitude in [2^-110, 3.39e38]: hi keeps
//    E's top 8 significant bits, mid the next 8 and lo the last 8 (below
//    2^-110 lo would need bf16 subnormals finer than 2^-133).  z is bf16,
//    so every product z*part is exact in the f32 accumulator and
//    z.E = z.lo + z.mid + z.hi (smallest terms first) carries only the
//    accumulator's own f32 rounding: 3 x 4 k-steps of
//    mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 per 16x8 tile.  Two parts
//    would leave an error of up to 2^-16 * sum|z_d E_d| in z.E, unbounded
//    against a small distance, so all three are kept.
//  * Selection in registers.  A warp owns a tile of 32 rows (two m16 tiles)
//    and walks n_embed in chunks of 64 columns (8 n8 tiles, 64 f32
//    accumulators a thread).  In an accumulator lane l holds rows l/4 and
//    l/4 + 8, columns 2(l%4) + {0, 1}; it visits its columns in increasing
//    order and keeps a running top-K of (distance, index) per row with a
//    strict <, so among its own equal distances the lowest index stays.
//    After the last chunk the four lanes of a quad merge their lists with
//    __shfl_xor_sync on 1 and 2, comparing (distance, index)
//    lexicographically: the lowest index wins ties, as on the TPU
//    (memory_pallas.py:64-72).  No distance tile goes to shared memory.
//  * Operand loads without ldmatrix.  The dot product does not care in
//    which order the 64 k-values are summed, so lane l feeds logical
//    k = 2(l%4) + {0, 1, 8, 9} of each of the four k-steps from the 16
//    physical d in [8(l%4), 8(l%4) + 8) and [32 + 8(l%4), ...) of its row,
//    the same d for A (z) and B (a codeword).  Those are two 16-byte chunks
//    of a 128-byte row: one n8 tile's B fragments of one part for all four
//    k-steps are two 16-byte shared loads, and the A fragments of a row two
//    more, held in registers over the whole walk (32 registers).  A
//    B-fragment load feeds both m16 tiles.
//  * Bank conflicts.  Rows of 128 bytes (a codeword of one part, a latent
//    row) store 16-byte chunk c at position c ^ swz(row), swz(r) =
//    4*(r & 1) + ((r >> 1) & 3): the 8 lanes of a quarter-warp reading
//    chunks t of codewords 2q and 2q+1 hit 8 distinct positions, and 8
//    consecutive codewords storing one chunk do too.
//  * Asynchronous input.  Each warp stages its next 32-row tile of z
//    (4 KiB) with cp.async into the second of two buffers while it scores
//    the current one; rows >= N are zero-filled and never written.
//  * Output that overlaps the compute.  The codewords are rebuilt in f32 as
//    (hi + mid) + lo, which equals E bitwise, so no f32 copy of the
//    codebook is kept and n_embed 512 fits (192 KiB of parts, 2 KiB of
//    norms, 32 KiB of staging for 4 warps).  A codeword is 16 lanes x
//    float4: a warp stores two rows' codewords per instruction with
//    streaming stores, and q1 comes from the registers of q_topk's first
//    block.  A tile's codewords are stored while the warp scores its next
//    tile, a slice of rows beside each column chunk, so the store queue
//    drains under the MMAs and the selection: on an H100 the compute alone
//    and the stores alone take about as long as each other, and stored at
//    the end of each tile they overlapped poorly.
//  * Work spread.  Blocks are persistent, at most one wave (the occupancy
//    calculator's count), one block per tile below that; tile T goes to
//    block T % grid, warp (T / grid) % warps, so a small N still reaches
//    every SM and the warps with one tile more than the rest spread across
//    SMs.  Each block loads and splits the codebook once.  12 warps a block
//    (8 at k = 4, 4 at n_embed 512), one block an SM: 197,632 B of shared
//    memory and at most 168 registers a thread at n_embed 256, k 2.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes (ammcnet_aaai2021_torch/ops/memory_kernels.py).  Launches go on
// the caller's stream; every entry point returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kDim = 64;             // latent width the kernel is built for
constexpr int kChunks = kDim / 8;    // 16-byte chunks (8 bf16) in a row
constexpr int kRowBytes = kDim * 2;  // one bf16 row: 128 B
constexpr int kTileRows = 32;        // rows a warp scores at once
constexpr int kTileBytes = kTileRows * kRowBytes;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHi = 0, kMid = 1, kLo = 2;  // the codebook's bf16 parts

template <int NE, int K>
struct Cfg {
  // 12 warps (at most 168 registers a thread) where the parts leave room
  // for their staging buffers; 8 for k = 4, whose top-4 lists need more
  // registers
  static constexpr int kWarps = NE >= 512 ? 4 : (K >= 4 ? 8 : 12);
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kChunkTiles = NE >= 64 ? 8 : NE / 8;  // n8 tiles
  static constexpr int kChunkCols = 8 * kChunkTiles;
  // rows of the previous tile stored beside each column chunk
  static constexpr int kSliceRows = kTileRows / (NE / kChunkCols);
  static constexpr int kPartBytes = NE * kRowBytes;
  static constexpr int kSmem =
      3 * kPartBytes + NE * 4 + kWarps * 2 * kTileBytes;
};

// byte offset of 16-byte chunk c of row r in an array of 128-byte rows
__device__ __forceinline__ int chunk_off(int r, int c) {
  const int swz = ((r & 1) << 2) | ((r >> 1) & 3);
  return r * kRowBytes + ((c ^ swz) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// c += A (16x16 bf16, row) * B (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// bf16 halves of a 32-bit word as f32 (exact)
__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Running top-K with the new candidate (d, j) visited after every index
// already held: a strict < keeps the earlier (lower) index among equals.
template <int K>
__device__ __forceinline__ void insert_after(float (&v)[K], int (&ix)[K],
                                             float d, int j) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool before_prev = d < v[s - 1];
    const bool before_this = d < v[s];
    v[s] = before_prev ? v[s - 1] : (before_this ? d : v[s]);
    ix[s] = before_prev ? ix[s - 1] : (before_this ? j : ix[s]);
  }
  const bool first = d < v[0];
  v[0] = first ? d : v[0];
  ix[0] = first ? j : ix[0];
}

// The same for a candidate of any index: (distance, index) lexicographic.
template <int K>
__device__ __forceinline__ void insert_lex(float (&v)[K], int (&ix)[K],
                                           float d, int j) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool before_prev = d < v[s - 1] || (d == v[s - 1] && j < ix[s - 1]);
    const bool before_this = d < v[s] || (d == v[s] && j < ix[s]);
    v[s] = before_prev ? v[s - 1] : (before_this ? d : v[s]);
    ix[s] = before_prev ? ix[s - 1] : (before_this ? j : ix[s]);
  }
  const bool first = d < v[0] || (d == v[0] && j < ix[0]);
  v[0] = first ? d : v[0];
  ix[0] = first ? j : ix[0];
}

// acc = z.E over the chunk's columns [cb, cb + 8 CT): lane (g, t) feeds
// codeword cb + 8 nt + g to the B operand, lo, mid and hi in turn
template <int NE, int CT>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][CT][4],
                                          const uint32_t (&a)[2][2][8],
                                          const unsigned char* parts, int cb,
                                          int g, int t) {
  constexpr int kPartBytes = NE * kRowBytes;
#pragma unroll
  for (int nt = 0; nt < CT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
#pragma unroll
  for (int nt = 0; nt < CT; ++nt) {
    const int j = cb + nt * 8 + g;
    constexpr int kOrder[3] = {kLo, kMid, kHi};  // the smallest terms first
#pragma unroll
    for (int pi = 0; pi < 3; ++pi) {
      const unsigned char* base = parts + kOrder[pi] * kPartBytes;
      const uint4 x = *reinterpret_cast<const uint4*>(base + chunk_off(j, t));
      const uint4 y =
          *reinterpret_cast<const uint4*>(base + chunk_off(j, 4 + t));
      const uint32_t b[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][nt], a[mt][0][2 * s], a[mt][1][2 * s],
                   a[mt][0][2 * s + 1], a[mt][1][2 * s + 1], b[2 * s],
                   b[2 * s + 1]);
        }
      }
    }
  }
}

// Distances of the chunk's columns into the running top-K of the lane's
// rows (mt, h), columns in increasing order.
template <int K, int CT>
__device__ __forceinline__ void select_chunk(const float (&acc)[2][CT][4],
                                             const float* esq, int cb, int t,
                                             float (&best)[2][2][K],
                                             int (&best_i)[2][2][K]) {
#pragma unroll
  for (int nt = 0; nt < CT; ++nt) {
    const int col = cb + nt * 8 + 2 * t;
    const float2 e2 = *reinterpret_cast<const float2*>(esq + col);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        insert_after<K>(best[mt][h], best_i[mt][h],
                        fmaf(-2.f, acc[mt][nt][2 * h], e2.x), col);
        insert_after<K>(best[mt][h], best_i[mt][h],
                        fmaf(-2.f, acc[mt][nt][2 * h + 1], e2.y), col + 1);
      }
    }
  }
}

// Writes the chosen codewords of tile rows [r_begin, r_end) (even bounds),
// rebuilt in f32 from the parts, two rows an instruction: lanes 0-15 row
// rr, 16-31 row rr + 1; lane `sub` stores d in [4 sub, 4 sub + 4) of each
// codeword.  Lane l's `mine` holds tile row l's indices.
template <int NE, int K>
__device__ __forceinline__ void store_rows(const int (&mine)[K], int64_t row0,
                                           int r_begin, int r_end,
                                           const unsigned char* parts,
                                           float* __restrict__ q_topk,
                                           float* __restrict__ q1, int n,
                                           int lane) {
  constexpr int kPartBytes = NE * kRowBytes;
  const int half = lane >> 4;
  const int sub = lane & 15;
#pragma unroll 4
  for (int rr = r_begin; rr < r_end; rr += 2) {
    const int r = rr + half;
    const int64_t row = row0 + r;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int j = __shfl_sync(kFull, mine[s], r);
      if (row < n) {
        const unsigned char* word =
            parts + chunk_off(j, sub >> 1) + (sub & 1) * 8;
        const uint2 h =
            *reinterpret_cast<const uint2*>(word + kHi * kPartBytes);
        const uint2 m =
            *reinterpret_cast<const uint2*>(word + kMid * kPartBytes);
        const uint2 l =
            *reinterpret_cast<const uint2*>(word + kLo * kPartBytes);
        const float4 v = make_float4(
            (lo_f32(h.x) + lo_f32(m.x)) + lo_f32(l.x),
            (hi_f32(h.x) + hi_f32(m.x)) + hi_f32(l.x),
            (lo_f32(h.y) + lo_f32(m.y)) + lo_f32(l.y),
            (hi_f32(h.y) + hi_f32(m.y)) + hi_f32(l.y));
        __stcs(reinterpret_cast<float4*>(q_topk + row * (K * kDim) + s * kDim) +
                   sub, v);
        if (s == 0) __stcs(reinterpret_cast<float4*>(q1 + row * kDim) + sub, v);
      }
    }
  }
}

// cp.async a 32-row tile of z into dst (rows >= n zero-filled): lane l
// copies chunk l % 8 of rows l / 8 + 4 i, 512 contiguous bytes a step.
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* flat, int n,
                                           int64_t tile, unsigned char* dst,
                                           int lane) {
  const int c = lane & 7;
#pragma unroll
  for (int i = 0; i < kTileRows / 4; ++i) {
    const int r = (lane >> 3) + 4 * i;
    const int64_t row = tile * kTileRows + r;
    const bool ok = row < n;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(flat + (ok ? row : 0) * kDim) +
        c * 16;
    cp_async16(dst + chunk_off(r, c), src, ok ? 16 : 0);
  }
}

template <int NE, int K>
__global__ void __launch_bounds__(Cfg<NE, K>::kThreads, 1)
quantize_topk_mma_kernel(const __nv_bfloat16* __restrict__ flat,
                         const float* __restrict__ embed,
                         float* __restrict__ q_topk, float* __restrict__ q1,
                         int* __restrict__ idx, int n) {
  using C = Cfg<NE, K>;
  constexpr int CT = C::kChunkTiles;
  constexpr int CW = C::kChunkCols;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* parts = smem;  // [part][NE][128 B], chunks swizzled
  float* esq = reinterpret_cast<float*>(smem + 3 * C::kPartBytes);  // [NE]
  unsigned char* stage = smem + 3 * C::kPartBytes + NE * 4;  // [warp][2][tile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // The first tile's z is in flight while the block splits the codebook.
  unsigned char* my_stage = stage + warp * 2 * kTileBytes;
  const int64_t tiles = (static_cast<int64_t>(n) + kTileRows - 1) / kTileRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * C::kWarps;
  int64_t tile = static_cast<int64_t>(warp) * gridDim.x + blockIdx.x;
  if (tile < tiles) stage_tile(flat, n, tile, my_stage, lane);
  cp_async_commit();

  // Split: thread i takes codeword j = i % NE, chunk c = i / NE (d in
  // [8c, 8c + 8)); its global reads are coalesced over j.
#pragma unroll 2
  for (int i = tid; i < NE * kChunks; i += C::kThreads) {
    const int j = i % NE;
    const int c = i / NE;
    uint32_t w[3][4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      __nv_bfloat16 h[2], m[2], l[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float v = embed[(8 * c + e + u) * NE + j];
        h[u] = __float2bfloat16_rn(v);
        const float r1 = v - __bfloat162float(h[u]);  // exact
        m[u] = __float2bfloat16_rn(r1);
        const float r2 = r1 - __bfloat162float(m[u]);  // exact
        l[u] = __float2bfloat16_rn(r2);
      }
      w[kHi][e / 2] = pack2(h[0], h[1]);
      w[kMid][e / 2] = pack2(m[0], m[1]);
      w[kLo][e / 2] = pack2(l[0], l[1]);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      *reinterpret_cast<uint4*>(parts + p * C::kPartBytes + chunk_off(j, c)) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
    }
  }
  for (int j = tid; j < NE; j += C::kThreads) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      const float e = embed[d * NE + j];
      s = fmaf(e, e, s);
    }
    esq[j] = s;
  }
  __syncthreads();

  const int g = lane >> 2;  // accumulator row (and row + 8), B column
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1
  int prev[K];              // the previous tile's indices (lane l: row l)
  int64_t prev_row0 = -1;
  for (int buf = 0; tile < tiles; tile += stride, buf ^= 1) {
    const int64_t next = tile + stride;
    if (next < tiles) {
      stage_tile(flat, n, next, my_stage + (buf ^ 1) * kTileBytes, lane);
    }
    cp_async_commit();
    cp_async_wait_prev();  // this tile's group has landed
    __syncwarp();

    // A fragments: row mt*16 + h*8 + g, words 2s (a0 / a1) and 2s + 1
    // (a2 / a3) of k-step s
    uint32_t a[2][2][8];
    const unsigned char* zs = my_stage + buf * kTileBytes;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + h * 8 + g;
        const uint4 x = *reinterpret_cast<const uint4*>(zs + chunk_off(r, t));
        const uint4 y =
            *reinterpret_cast<const uint4*>(zs + chunk_off(r, 4 + t));
        const uint32_t words[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
        for (int w = 0; w < 8; ++w) a[mt][h][w] = words[w];
      }
    }
    __syncwarp();  // this buffer is restaged two tiles on

    float best[2][2][K];
    int best_i[2][2][K];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int s = 0; s < K; ++s) {
          best[mt][h][s] = __int_as_float(0x7f800000);
          best_i[mt][h][s] = 0;
        }
      }
    }

    // Each column chunk's MMAs and selection, with a slice of the previous
    // tile's codeword stores between them.
#pragma unroll 1
    for (int cb = 0; cb < NE; cb += CW) {
      float acc[2][CT][4];
      mma_chunk<NE, CT>(acc, a, parts, cb, g, t);
      if (prev_row0 >= 0) {
        const int r = cb / CW * C::kSliceRows;
        store_rows<NE, K>(prev, prev_row0, r, r + C::kSliceRows, parts,
                          q_topk, q1, n, lane);
      }
      select_chunk<K, CT>(acc, esq, cb, t, best, best_i);
    }

    // merge the quad's four lists: afterwards every lane of quad g holds
    // the top-K of rows g and g + 8 of both m16 tiles
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ov[K];
          int oi[K];
#pragma unroll
          for (int s = 0; s < K; ++s) {
            ov[s] = __shfl_xor_sync(kFull, best[mt][h][s], off);
            oi[s] = __shfl_xor_sync(kFull, best_i[mt][h][s], off);
          }
#pragma unroll
          for (int s = 0; s < K; ++s) {
            insert_lex<K>(best[mt][h], best_i[mt][h], ov[s], oi[s]);
          }
        }
      }
    }

    // lane l takes the indices of tile row l (m16 tile l / 16, half
    // (l / 8) % 2, held by quad l % 8)
    const int src = 4 * (lane & 7);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int i00 = __shfl_sync(kFull, best_i[0][0][s], src);
      const int i01 = __shfl_sync(kFull, best_i[0][1][s], src);
      const int i10 = __shfl_sync(kFull, best_i[1][0][s], src);
      const int i11 = __shfl_sync(kFull, best_i[1][1][s], src);
      prev[s] = lane < 16 ? ((lane & 8) ? i01 : i00) : ((lane & 8) ? i11 : i10);
    }
    prev_row0 = tile * kTileRows;
    if (prev_row0 + lane < n) idx[prev_row0 + lane] = prev[0];
  }
  if (prev_row0 >= 0) {
    store_rows<NE, K>(prev, prev_row0, 0, kTileRows, parts, q_topk, q1, n,
                      lane);
  }
}

template <int NE, int K>
cudaError_t grid_size(int n, int* grid) {
  auto kernel = quantize_topk_mma_kernel<NE, K>;
  constexpr int smem = Cfg<NE, K>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, Cfg<NE, K>::kThreads, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (static_cast<int64_t>(n) + kTileRows - 1) / kTileRows;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  *grid = static_cast<int>(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

// Calls f(std::integral_constant<int, n_embed>) for the codebook sizes the
// kernel is instantiated for.
template <typename F>
cudaError_t with_ne(int n_embed, F&& f) {
  switch (n_embed) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    default: return cudaErrorInvalidValue;
  }
}

// Calls f(std::integral_constant<int, k>) for k in 1..4.
template <typename F>
cudaError_t with_k(int k, F&& f) {
  switch (k) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a (64, n_embed) codebook and k; 0 for
// sizes the kernel is not instantiated for.
long long ammc_quantize_topk_mma_smem_bytes(int n_embed, int k) {
  long long bytes = 0;
  with_ne(n_embed, [&](auto ne) {
    return with_k(k, [&](auto kk) {
      bytes = Cfg<decltype(ne)::value, decltype(kk)::value>::kSmem;
      return cudaSuccess;
    });
  });
  return bytes;
}

// The most dynamic shared memory a block may opt in to on the current device.
int ammc_max_optin_smem(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

const char* ammc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks a launch takes for these sizes on the current device.  It also
// raises the kernel's shared-memory limit to what the codebook needs, so
// call it once per device and sizes before the first launch; the wrapper
// caches it.
int ammc_quantize_topk_mma_grid(int n, int n_embed, int k, int* grid) {
  return with_ne(n_embed, [&](auto ne) {
    return with_k(k, [&](auto kk) {
      return grid_size<decltype(ne)::value, decltype(kk)::value>(n, grid);
    });
  });
}

// B1 for bf16 latents.  flat (n, 64) bf16, 16-byte aligned; embed (64,
// n_embed) f32; q_topk (n, k*64) f32; q1 (n, 64) f32; idx (n,) int32.  All
// contiguous and on the current device; n_embed in {32, 64, 128, 256, 512};
// k in 1..4; n > 0; `grid` from ammc_quantize_topk_mma_grid with the same
// sizes.
int ammc_quantize_topk_mma(const void* flat, const void* embed, void* q_topk,
                           void* q1, void* idx, int grid, int n, int n_embed,
                           int k, void* stream) {
  return with_ne(n_embed, [&](auto ne) {
    return with_k(k, [&](auto kk) {
      constexpr int NE = decltype(ne)::value;
      constexpr int K = decltype(kk)::value;
      quantize_topk_mma_kernel<NE, K>
          <<<grid, Cfg<NE, K>::kThreads, Cfg<NE, K>::kSmem,
             static_cast<cudaStream_t>(stream)>>>(
              static_cast<const __nv_bfloat16*>(flat),
              static_cast<const float*>(embed), static_cast<float*>(q_topk),
              static_cast<float*>(q1), static_cast<int*>(idx), n);
      return cudaGetLastError();
    });
  });
}

}  // extern "C"
