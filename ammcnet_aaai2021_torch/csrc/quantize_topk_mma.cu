// Fused top-k memory lookup for bf16 latents on Hopper's tensor cores
// (sm_90a, warp-level mma.sync): distance, top-k and gather in one pass.
//
// Kernels B1 and B2, tensor-core route.  B1 replaces the Pallas TPU kernel
// `_quantize_kernel` called by `quantize_topk_pallas`
// (ammcnet_aaai2021_tpu/ops/memory_pallas.py:48-82, :201-255); B2, this
// lookup followed by `ema_stats_kernel` (below), replaces
// `_quantize_train_kernel` called by `quantize_topk_pallas_train`
// (memory_pallas.py:84-135, :137-198).  Both take bf16 latents of width 64
// with k <= 4; float32 latents and larger k take the CUDA-core kernels in
// quantize_topk.cu.  The routing rule is `lookup_route` in
// ammcnet_aaai2021_torch/ops/memory_kernels.py.
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
// B2 adds the EMA statistics of the top-1 picks: counts (n_embed,) f32, the
// number of rows whose top-1 is j, and embed_sum (64, n_embed) f32 =
// flat^T . one_hot(top-1).  The TPU kernel summed them on its matrix unit
// across a sequential grid.  Here the lookup above runs unchanged (so B2's
// q_topk, q1 and idx are bitwise B1's) and a second kernel on the same
// stream reads idx and flat back.
//
// What bounds the statistics.  They add N*64 values: N*128 B of z and N*4 B
// of idx, already counted as B1's input and output, so the compulsory
// traffic grows only by the statistics written (66 KiB at n_embed 256).
// What costs is where the rows go: any row may belong to any codeword, and
// GPU blocks run in no order, so a plain sum per codeword across blocks
// needs float atomics (an order that changes from run to run) or partials
// and a second pass (a workspace that scales with the blocks).  And the
// rows are skewed: a fifth to a half of them may pick one codeword
// (codebooks collapse in training; random latents much smaller than the
// codewords pick the shortest ones), so a codeword's rows must not be left
// to one SM.  At the training path's N = 4,096 the work is tiny and the
// chain of dependent steps (idx, then the rows, then the partials of other
// blocks) sets the time.
//
// What the design does about it (ema_stats_kernel).
//  * A cluster of 8 blocks (Hopper's thread-block clusters) owns a group of
//    J = n_embed / 32 codewords: 32 clusters, 256 blocks of 4 warps, three
//    an SM, so all are resident at once.  Block c of a cluster sums rows
//    [c N/8, (c + 1) N/8), so a codeword's rows spread over 8 SMs, and the
//    blocks combine their partials through distributed shared memory.
//    Every (d, j) entry is summed inside one cluster: no atomics, no
//    workspace, no second pass, and n_embed 512 runs (the CUDA-core B2 keeps
//    a dim x n_embed partial in shared memory and cannot).
//  * Each warp scans a contiguous part of its block's rows in idx, four
//    indices a lane (16-byte loads, 256 a step), the next step's loads in
//    flight while it adds the current one's rows.  Ballots and popcounts
//    rank the matches in row order into a per-warp list in shared memory.
//    The warp stages the listed rows into shared memory with cp.async, 32 at
//    a time with the next 32 in flight, and adds each batch on the tensor
//    cores as partial += one_hot(code)^T . z (mma.m16n8k16, codewords as
//    the 16 rows of A, ldmatrix.trans for z): the products are exact and
//    each MMA starts from 0, so it sums at most 16 exact terms, and the
//    batch sums add into f32 registers in row order.  A column of ones
//    counts the rows, exactly.  One MMA pass costs the same for any mix of
//    codewords, where adding row by row into per-codeword sums cost a
//    dependent shared-memory round trip a row.
//  * The block adds its 4 warp partials in warp order and pushes each
//    8-d slice (float4 stores into the other blocks' shared memory) to the
//    block that writes it out; after one cluster barrier each block adds the
//    8 slices it received in block order.  No block reads another's shared
//    memory after the barrier, so none waits for the others to finish.
//  * So every entry is a fixed sum (16-row MMA sums in row order within a
//    warp's part, then the parts in order): two calls are bitwise equal.
//  * Cost.  Each cluster reads all of idx (32 x N*4 B from L2, 25 MB at
//    N = 196,608), and a cluster's time grows with its codewords' share of
//    the rows.

// Plain C interface, built with nvcc into a shared library and bound with
// ctypes (ammcnet_aaai2021_torch/ops/memory_kernels.py).  Launches go on
// the caller's stream; every entry point returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, of matrix m, the
// elements (rows 2 (l % 4), + 1; column l / 4) in r[m]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
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

constexpr uint32_t kOnes2 = 0x3f803f80u;  // two bf16 ones

// two bf16 entries of a one-hot column: 1 where the code is q, else 0
__device__ __forceinline__ uint32_t one_hot2(int code_lo, int code_hi, int q) {
  return (code_lo == q ? 0x3f80u : 0u) | (code_hi == q ? 0x3f800000u : 0u);
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

// ema_stats_kernel's shape for a codebook of NE codewords
template <int NE>
struct StatsCfg {
  static constexpr int kCluster = 8;  // blocks a cluster: row parts
  // clusters, each owning kJ codewords: at three blocks an SM an H100 holds
  // all 32 at once (45 clusters of 8)
  static constexpr int kGroups = 32;
  static constexpr int kJ = NE / kGroups;
  static constexpr int kBlocks = kGroups * kCluster;
  static constexpr int kWarps = 4;
  static constexpr int kThreads = kWarps * 32;
  // blocks an SM: 170 registers a thread, no spills (128 at four)
  static constexpr int kMinBlocks = 3;
  static constexpr int kUnroll = 2;            // 128-index chunks a step
  static constexpr int kStep = kUnroll * 128;  // indices a warp scans a step
  static constexpr int kBatch = 32;  // listed rows a warp stages at once,
                                     // one a lane; two batches in flight
  static constexpr int kD = kDim / kCluster;  // d a block writes out
  // shared memory: the warps' staged rows [warp][2][batch][128 B]; their
  // partials [warp][J][64] f32 and counts [warp][J] int32; the block
  // partials pushed to this block, [rank][J][kD] f32, and their counts
  // [rank][J] int32; the warps' lists [warp][kStep] uint16
  static constexpr int kStageBytes = kWarps * 2 * kBatch * kRowBytes;
  static constexpr int kPart = kWarps * kJ * kDim;
  static constexpr int kRecv = kCluster * kJ * kD;
  static constexpr int kSmem =
      kStageBytes + (kPart + kWarps * kJ + kRecv + kCluster * kJ) * 4 +
      kWarps * kStep * 2;
};

// idx of rows [r, r + 4) (r a multiple of 4), -1 from `end` on
__device__ __forceinline__ int4 load_idx4(const int* __restrict__ idx, int r,
                                          int end) {
  if (r + 4 <= end) return __ldg(reinterpret_cast<const int4*>(idx + r));
  int4 v = make_int4(-1, -1, -1, -1);
  if (r < end) v.x = __ldg(idx + r);
  if (r + 1 < end) v.y = __ldg(idx + r + 1);
  if (r + 2 < end) v.z = __ldg(idx + r + 2);
  return v;
}

// counts[j] and embed_sum[:, j] for the J codewords cluster blockIdx.x / 8
// owns, from the lookup's idx and the latents (see "B2" above).
// 0 < n < 2^31 - 8.
template <int NE>
__global__ void __cluster_dims__(StatsCfg<NE>::kCluster, 1, 1)
__launch_bounds__(StatsCfg<NE>::kThreads, StatsCfg<NE>::kMinBlocks)
ema_stats_kernel(const __nv_bfloat16* __restrict__ flat,
                 const int* __restrict__ idx, float* __restrict__ counts,
                 float* __restrict__ embed_sum, int n) {
  using C = StatsCfg<NE>;
  constexpr int J = C::kJ;
  static_assert(J <= 32 && C::kStep * 32 <= 65536, "list entries are 16 bits");
  static_assert(C::kBatch == 32 && J <= 16, "a lane holds a staged row's "
                "code; codewords are the 16 rows of an MMA tile");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;
  float* part = reinterpret_cast<float*>(smem + C::kStageBytes);
  int* part_n = reinterpret_cast<int*>(part + C::kPart);
  float* recv = reinterpret_cast<float*>(part_n + C::kWarps * J);
  int* recv_n = reinterpret_cast<int*>(recv + C::kRecv);
  // a warp's matches of one step: (row - step start) << 5 | (j - j0)
  unsigned short* lists =
      reinterpret_cast<unsigned short*>(recv_n + C::kCluster * J);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x / C::kCluster * J;
  const unsigned char* z = reinterpret_cast<const unsigned char*>(flat);
  const unsigned below = (1u << lane) - 1u;
  unsigned char* my_stage = stage + warp * 2 * C::kBatch * kRowBytes;
  unsigned short* my_list = lists + warp * C::kStep;

  // block `rank` sums rows [rank seg_b, (rank + 1) seg_b), its warp w the
  // w-th part of those; both lengths multiples of 4
  const int seg_b = static_cast<int>(
      ((static_cast<unsigned>(n) + C::kCluster - 1) / C::kCluster + 3) & ~3u);
  const int seg_w = ((seg_b + C::kWarps - 1) / C::kWarps + 3) & ~3;
  const int block_end = min(n, (rank + 1) * seg_b);
  const int begin = rank * seg_b + warp * seg_w;
  const int end = min(block_end, begin + seg_w);

  // The warp's partial of its J codewords, as the accumulator fragments of
  // mma.m16n8k16 (rows: codeword j0 + q, q < 16; columns: d, 8 a tile):
  // lane (g, tq) holds q = g, g + 8 and d = 8 nt + 2 tq, + 1.  cnt[h]: the
  // rows of codeword j0 + g + 8 h.
  const int g = lane >> 2;
  const int tq = lane & 3;
  float acc[kDim / 8][4];
  float cnt[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kDim / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  // Adds a staged batch of 32 rows on the tensor cores, 16 rows a k-step:
  // partial += one_hot(code)^T . z, with the code of batch row l in lane l
  // (-1: none of this cluster's).  The products are exact and each MMA
  // starts from 0, so it sums at most 16 exact terms; its sum then adds into
  // the f32 accumulators, k-steps in row order.  A column of ones counts
  // the rows.
  auto add_batch = [&](const unsigned char* st, int code) {
#pragma unroll
    for (int ks = 0; ks < C::kBatch / 16; ++ks) {
      const int r = 16 * ks + 2 * tq;
      const int k0 = __shfl_sync(kFull, code, r);
      const int k1 = __shfl_sync(kFull, code, r + 1);
      const int k8 = __shfl_sync(kFull, code, r + 8);
      const int k9 = __shfl_sync(kFull, code, r + 9);
      const uint32_t a0 = one_hot2(k0, k1, g);
      const uint32_t a1 = one_hot2(k0, k1, g + 8);
      const uint32_t a2 = one_hot2(k8, k9, g);
      const uint32_t a3 = one_hot2(k8, k9, g + 8);
      // lane l gives ldmatrix row 16 ks + 8 ((l / 8) % 2) + l % 8 of
      // chunk 2 np + l / 16: b[0], b[1] are tile 2 np's, b[2], b[3] the
      // next tile's
      const int lr = 16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int np = 0; np < kDim / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, st + lr * kRowBytes + (((2 * np + (lane >> 4)) ^ (lr & 7)) << 4));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(c, a0, a1, a2, a3, b[2 * h], b[2 * h + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * np + h][e] += c[e];
        }
      }
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(c, a0, a1, a2, a3, kOnes2, kOnes2);
      cnt[0] += c[0];
      cnt[1] += c[2];
    }
  };
  int4 cur[C::kUnroll];  // lane l: rows base + 128 u + 4 l + {0..3}
#pragma unroll
  for (int u = 0; u < C::kUnroll; ++u) {
    cur[u] = load_idx4(idx, begin + u * 128 + 4 * lane, end);
  }
  for (int base = begin; base < end; base += C::kStep) {
    // list the step's matches in row order: chunk, then lane, then s
    int listed = 0;
#pragma unroll
    for (int u = 0; u < C::kUnroll; ++u) {
      const int v[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
      unsigned m = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        m |= (static_cast<unsigned>(v[s] - j0) < static_cast<unsigned>(J))
             << s;
      }
      int at = listed;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const unsigned b = __ballot_sync(kFull, (m >> s) & 1u);
        at += __popc(b & below);  // matches of the lower lanes
        listed += __popc(b);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if ((m >> s) & 1u) {
          my_list[at++] = static_cast<unsigned short>(
              ((u * 128 + 4 * lane + s) << 5) | (v[s] - j0));
        }
      }
    }
    __syncwarp();
    // the next step's indices are in flight while this step's rows add up
#pragma unroll
    for (int u = 0; u < C::kUnroll; ++u) {
      cur[u] = load_idx4(idx, base + C::kStep + u * 128 + 4 * lane, end);
    }
    // Stage the listed rows in batches of 32, the next batch in flight
    // while the warp adds the current one: lane l copies 16-byte chunk
    // c = l % 8 of rows l / 8 + 4 t, stored at chunk c ^ (row % 8) (so
    // ldmatrix reads 8 rows of one chunk without bank conflicts); rows past
    // the list are zero-filled.
    auto stage_batch = [&](int i, int buf) {
      const int rows = min(listed - i, C::kBatch);
      unsigned char* dst = my_stage + buf * C::kBatch * kRowBytes;
      const int c = lane & 7;
#pragma unroll
      for (int t = 0; t < C::kBatch / 4; ++t) {
        const int r = (lane >> 3) + 4 * t;
        const bool ok = r < rows;
        const int64_t row = ok ? base + (my_list[i + r] >> 5) : 0;
        cp_async16(dst + r * kRowBytes + ((c ^ (r & 7)) << 4),
                   z + row * kRowBytes + c * 16, ok ? 16 : 0);
      }
      cp_async_commit();
    };
    if (listed > 0) stage_batch(0, 0);
    for (int i = 0, buf = 0; i < listed; i += C::kBatch, buf ^= 1) {
      if (i + C::kBatch < listed) {
        stage_batch(i + C::kBatch, buf ^ 1);
        cp_async_wait_prev();
      } else {
        cp_async_wait_all();
      }
      __syncwarp();
      add_batch(my_stage + buf * C::kBatch * kRowBytes,
                lane < listed - i ? my_list[i + lane] & 31 : -1);
      __syncwarp();  // this buffer is restaged two batches on
    }
    __syncwarp();  // the list is rewritten next step
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = g + 8 * h;
    if (q < J) {
#pragma unroll
      for (int nt = 0; nt < kDim / 8; ++nt) {
        reinterpret_cast<float2*>(part + (warp * J + q) * kDim + 8 * nt)[tq] =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
      if (tq == 0) part_n[warp * J + q] = static_cast<int>(cnt[h]);
    }
  }
  __syncthreads();

  // The block's partial, the warps' in warp order, four d a thread; each
  // float4 pushed to the block that writes those d out (d / kD), and the
  // counts to block 0.
  for (int t = threadIdx.x; t < J * kDim / 4; t += C::kThreads) {
    const int q = 4 * t / kDim;
    const int d = 4 * t % kDim;
    float4 s = reinterpret_cast<const float4*>(part)[t];
#pragma unroll
    for (int w = 1; w < C::kWarps; ++w) {
      const float4 o = reinterpret_cast<const float4*>(part + w * J * kDim)[t];
      s.x += o.x;
      s.y += o.y;
      s.z += o.z;
      s.w += o.w;
    }
    float* to = cluster.map_shared_rank(recv, d / C::kD);
    *reinterpret_cast<float4*>(to + (rank * J + q) * C::kD + d % C::kD) = s;
  }
  if (threadIdx.x < J) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < C::kWarps; ++w) c += part_n[w * J + threadIdx.x];
    cluster.map_shared_rank(recv_n, 0)[rank * J + threadIdx.x] = c;
  }
  cluster.sync();

  // The pushed partials of d in [kD rank, kD rank + kD), in block order;
  // thread t takes (d, j0 + q), t = (d - kD rank) J + q, so neighbours
  // write adjacent codewords.  Nothing remote is read after the sync, so
  // no block waits for the others to finish.
  for (int t = threadIdx.x; t < C::kD * J; t += C::kThreads) {
    const int dl = t / J;
    const int q = t % J;
    float s = recv[q * C::kD + dl];
#pragma unroll
    for (int r = 1; r < C::kCluster; ++r) s += recv[(r * J + q) * C::kD + dl];
    embed_sum[(rank * C::kD + dl) * NE + j0 + q] = s;
  }
  if (rank == 0 && threadIdx.x < J) {
    int c = 0;
#pragma unroll
    for (int r = 0; r < C::kCluster; ++r) c += recv_n[r * J + threadIdx.x];
    counts[j0 + threadIdx.x] = static_cast<float>(c);
  }
}

template <int NE, int K>
cudaError_t launch_lookup(const void* flat, const void* embed, void* q_topk,
                          void* q1, void* idx, int grid, int n,
                          cudaStream_t stream) {
  quantize_topk_mma_kernel<NE, K>
      <<<grid, Cfg<NE, K>::kThreads, Cfg<NE, K>::kSmem, stream>>>(
          static_cast<const __nv_bfloat16*>(flat),
          static_cast<const float*>(embed), static_cast<float*>(q_topk),
          static_cast<float*>(q1), static_cast<int*>(idx), n);
  return cudaGetLastError();
}

template <int NE, int K>
cudaError_t grid_size(int n, int* grid) {
  auto kernel = quantize_topk_mma_kernel<NE, K>;
  constexpr int smem = Cfg<NE, K>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // B2's statistics kernel, launched after the lookup: its grid is fixed
  if ((err = cudaFuncSetAttribute(ema_stats_kernel<NE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  StatsCfg<NE>::kSmem)) != cudaSuccess) {
    return err;
  }
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

// Blocks a lookup launch takes for these sizes on the current device.  It
// also raises the shared-memory limits of the lookup kernel and of B2's
// statistics kernel to what they need, so call it once per device and
// sizes before the first launch of B1 or B2; the wrappers cache it.
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
      return launch_lookup<decltype(ne)::value, decltype(kk)::value>(
          flat, embed, q_topk, q1, idx, grid, n,
          static_cast<cudaStream_t>(stream));
    });
  });
}

// B2 for bf16 latents: B1's launch, then the statistics on the same
// stream.  B1's arguments plus counts (n_embed,) f32 and embed_sum
// (64, n_embed) f32, contiguous; idx is read back, so it must be 16-byte
// aligned; `grid` from ammc_quantize_topk_mma_grid with the same sizes.
int ammc_quantize_topk_mma_train(const void* flat, const void* embed,
                                 void* q_topk, void* q1, void* idx,
                                 void* counts, void* embed_sum, int grid,
                                 int n, int n_embed, int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return with_ne(n_embed, [&](auto ne) {
    constexpr int NE = decltype(ne)::value;
    cudaError_t err = with_k(k, [&](auto kk) {
      return launch_lookup<decltype(ne)::value, decltype(kk)::value>(
          flat, embed, q_topk, q1, idx, grid, n, s);
    });
    if (err != cudaSuccess) return err;
    using SC = StatsCfg<NE>;
    ema_stats_kernel<NE><<<SC::kBlocks, SC::kThreads, SC::kSmem, s>>>(
            static_cast<const __nv_bfloat16*>(flat),
            static_cast<const int*>(idx), static_cast<float*>(counts),
            static_cast<float*>(embed_sum), n);
    return cudaGetLastError();
  });
}

}  // extern "C"
