// Fused top-k memory lookup for Hopper (sm_90a), the general route: any
// latent type (float32 or bf16), any width, any codebook size, any k.
// Distance, top-k and gather in one kernel on the bf16 tensor cores
// (mma.sync) at float32 accuracy, and (training variant) the EMA codebook
// statistics in a second kernel of thread-block clusters.  The route for
// every input the specialised tensor-core kernels (quantize_topk_mma.cu:
// bf16 latents of width 64, k <= 4, n_embed in {32, ..., 512}) do not take.
//
// Kernel B1 replaces the Pallas TPU kernel `_quantize_kernel` called by
// `quantize_topk_pallas` (ammcnet_aaai2021_tpu/ops/memory_pallas.py:48-82,
// :201-255); kernel B2 (B1's kernel, then `ema_stats_kernel`) replaces
// `_quantize_train_kernel` called by `quantize_topk_pallas_train`
// (memory_pallas.py:84-135, :137-198).  Like the TPU kernels they take any
// n_embed and any 1 <= k <= n_embed.
//
// For each latent row z (dim values, bf16 or f32) against the codebook
// E (dim, n_embed) f32 it computes the ranking distance
//     dist[j] = fmaf(-2, z.E[:, j], ||E[:, j]||^2)   (f32; ||z||^2 dropped)
// with ||E_j||^2 summed in f32 by sequential fmaf from the f32 codebook,
// takes the k smallest (distance, index) pairs in lexicographic order (the
// lowest index wins ties, memory_pallas.py:64-72; a NaN distance ranks as
// +inf), and writes the chosen codewords: q_topk (N, k*dim) f32, q1 (N, dim)
// f32 (the top-1 codeword) and idx (N,) int32 (the top-1 index).  Rows past
// N are neither read nor written.
//
// What bounds it on this card.  At N = 196,608, dim 64, n_embed 256, k 2 and
// float32 latents the compulsory traffic is 202 MB (0.060 ms at 3.35 TB/s),
// 151 MB of it the f32 outputs; the products are 6.4 GFLOP, which the CUDA
// cores (67 TFLOP/s) need 0.096 ms for and the bf16 tensor cores, six
// passes at float32 accuracy, 0.039 ms.  At k 16 the 805 MB of q_topk bound
// it; at n_embed 1024 the products do.
//
// What the design does about it.
//  * Products at float32 accuracy on the bf16 tensor cores.  Every f32 value
//    x splits into hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
//    (each subtraction exact in f32; hi + mid + lo == x for 0 and |x| in
//    [2^-110, 3.39e38]).  The codebook is split once per call by the
//    prologue; float32 latents are split in registers as a warp loads its A
//    fragments.  bf16 latents are exact, so z.E = z.lo + z.mid + z.hi (three
//    mma.sync.m16n8k16 passes); float32 latents keep the six cross products
//    lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi (smallest first): the three
//    dropped ones are below 2^-24 of |z||E| and so below the f32 rounding of
//    the sum.  Every product is exact in the f32 accumulator.
//  * Scales.  Each codeword j is split as E[:, j] / 2^b_j and each row as
//    z / 2^a_r (powers of two, exact), 2^b_j and 2^a_r bringing their
//    largest entry into [1, 2): the tensor cores then never see a subnormal
//    product, whatever the data's exponents, and the distance takes them
//    back exactly in its fma: fmaf(acc, -2 * 2^(a_r + b_j), ||E_j||^2).
//  * Any codebook size and width.  The prologue (`prep_codebook_kernel`)
//    writes the parts in "stages" of kCW = 64 codewords by kDS = 64 latent
//    dims (rows of 72 bf16: the pad makes each row 9 16-byte chunks, so
//    ldmatrix reads 8 rows without bank conflicts), each stage followed by
//    its codewords' ||E_j||^2 and 2^b_j; past n_embed and dim the parts are
//    zero, and zeros add exactly 0.  A block streams the stages through
//    shared memory with cp.async, double-buffered: the next stage lands
//    while the warps score this one, one __syncthreads pair a stage (one
//    stage only is loaded once).  A width over 64 takes several stages a
//    chunk (k-steps of 16, the accumulators kept across them); a stage
//    serves all of a block's rows, so the codebook's L2 traffic is paid
//    once per block of 256 rows.
//  * Rows.  A warp owns 32 rows (two m16 tiles): their latents, staged raw
//    by cp.async (16-byte chunks; element loads where rows are not 16-byte
//    aligned) into a buffer of its own with a padded pitch, loaded per
//    k-step by ldmatrix (bf16) or by float2 loads and split in registers
//    (f32).  For a width up to 64 the tile is staged once, with the first
//    stage of its row tile (two buffers: the next tile lands while the last
//    stage of this one is scored); wider rows are restaged per stage, 64
//    dims at a time.  Warp-tiles go to blocks round robin (tile T to block T
//    % grid).
//  * A small N (a tile a block at most, width up to 64) would leave all but
//    one warp of a block idle, that warp walking every stage alone.  There
//    the block's last warp turns producer: one thread feeds the two stage
//    buffers as a ring, a bulk copy (cp.async.bulk) a stage on an mbarrier
//    pair, and the other warps all take the block's one tile, warp w the
//    chunks c with c % warps == w, each at its own pace (lockstep stages
//    would keep all but the chunk's owner waiting); warp 0 then merges
//    their lists.  At a large N the stages stay in lockstep: a producer
//    warp there cost more (a scoring warp and registers) than it gained.
//  * Selection.  For k <= 8 each lane keeps a running top-K list per row it
//    holds in the accumulator layout (rows g and g + 8 of both m16 tiles,
//    columns 2t, 2t + 1 of each n8 tile), K in {2, 4, 8} the smallest that
//    holds k, compared (distance, index) lexicographically; after the last
//    chunk the four lanes of a quad merge their lists by shuffles.  No
//    distance goes to shared memory.  For k > 8 each chunk's 32 x 64
//    distance tile goes to shared memory and lane r takes row r's
//    candidates into a list of its own, inserting one only if it beats the
//    list's last entry: a row costs n_embed compares and a few inserts,
//    not k scans of n_embed distances.  The list sits in registers for
//    k <= 16 (a full list takes the chunk's candidates that beat its last
//    entry in rounds of one insert a lane, so that the warp runs as many
//    inserts as its busiest row needs, not one a column); past that in
//    shared memory where it fits, else in a device scratch the wrapper
//    allocates, so k is bounded by n_embed only.
//  * Stores.  The chosen codewords are copied from a codeword-major f32
//    copy of E (the prologue writes it; L2-resident) by 16-byte streaming
//    stores where the width allows (4 | dim), q1 beside q_topk's first
//    block, the indices read from a table in shared memory: a warp takes
//    the (row, rank) pairs in order, a narrow codeword's lanes sharing the
//    warp with the next pair's, and keeps the loads of 8 pairs a lane in
//    flight before their stores (one load, then its store, waited out the
//    L2's latency once a codeword).  For k <= 16 a tile's stores are spread
//    over the next tile's chunks (rows 32c/C to 32(c+1)/C after chunk c is
//    scored), so the store queue drains under the MMAs.
//
// B2 adds the EMA statistics of the top-1 picks: counts (n_embed,) f32 and
// embed_sum (dim, n_embed) f32 = flat^T . one_hot(top-1).  The lookup above
// runs unchanged (so B2's q_topk, q1 and idx are bitwise B1's), then
// `ema_stats_kernel` on the same stream reads idx and flat back.
//
// What bounds the statistics: they add N*dim values, whose bytes B1 already
// counted, into n_embed*dim sums.  What costs is the skew: a fifth to a half
// of the rows may pick one codeword, so its rows must spread over SMs, and
// GPU blocks run in no order, so a plain sum across blocks needs float
// atomics (an order that changes from run to run) or a second pass.
//
// What `ema_stats_kernel` does about it (the design of the tensor-core
// route's statistics, quantize_topk_mma.cu):
//  * A cluster of 8 blocks owns a group of J codewords (J sized to shared
//    memory; more clusters for a larger codebook or width).  Block c of a
//    cluster sums rows [c N/8, (c + 1) N/8), so a hot codeword's rows spread
//    over 8 SMs, and each block reads idx for its share once.
//  * Each of a block's 4 warps scans a contiguous part of those rows, 256
//    indices a step (16-byte loads, the next step's in flight), and lists
//    the matches in row order by ballots.  It stages the listed rows' latents
//    by cp.async in batches of 32 rows (64 dims a pass), two batches in
//    flight while it adds the third on the CUDA cores in row order, lane l
//    dims l and l + 32: a run of rows of one codeword in registers, each run
//    added into the warp's partial in shared memory.  Counts are the runs'
//    lengths (exact).
//  * The block adds its warps' partials in warp order and pushes each d-slice
//    to the block of the cluster that writes it (distributed shared memory);
//    after one cluster barrier each block adds the 8 partials it received in
//    block order and writes them.  No float atomics and no workspace: every
//    entry is a fixed sum, so two calls are bitwise equal.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes (ammcnet_aaai2021_torch/ops/memory_kernels.py).  Launches go on
// the caller's stream; every entry point returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCW = 64;        // codewords a stage holds (8 n8 tiles)
constexpr int kDS = 64;        // latent dims a stage holds (4 k-steps)
constexpr int kPitch = kDS + 8;  // elements a staged row takes
constexpr int kRowB = kPitch * 2;  // bytes of a staged bf16 row: 144
constexpr int kPartB = kCW * kRowB;  // one part of a stage: 9,216 B
constexpr int kEsqOff = 3 * kPartB;  // the stage's ||E_j||^2, 64 f32
constexpr int kScaleOff = kEsqOff + kCW * 4;  // its codewords' 2^b_j, 64 f32
constexpr int kStageB = kScaleOff + kCW * 4;  // 28,160 B
constexpr int kTileRows = 32;  // rows a warp owns
constexpr int kMaxK = 8;       // the longest top-k list in the MMA layout
constexpr int kLaneK = 16;     // the longest list a lane keeps for its row
constexpr int kStaged = 0;     // KMAX of the instantiation for k > kLaneK
constexpr int kDistPitch = kCW + 1;  // k > 8: a row of the distance tile
constexpr int kHi = 0, kMid = 1, kLo = 2;  // the codebook's bf16 parts

// The lookup kernel's selection for k <= KMAX (kStaged: any k): top-k
// lists in the MMA accumulator layout (KMAX <= kMaxK), or a distance tile a
// chunk in shared memory and a list a row, in registers (KMAX = kLaneK) or
// in shared or device memory (kStaged); warps a block: 8, or where each
// warp also keeps a distance tile 6 (KMAX = kLaneK) or 4 (its lists too), as
// shared memory allows.
template <int KMAX>
struct Lk {
  static constexpr bool kQuad = KMAX != kStaged && KMAX <= kMaxK;
  static constexpr bool kTable = KMAX != kStaged;  // index table, stores
                                                   // spread over the next tile
  static constexpr int kWarps = kQuad ? 8 : (KMAX == kLaneK ? 6 : 4);
  static constexpr int kThreads = kWarps * 32;
};
constexpr int kBarBytes = 64;  // split mode's mbarriers: full[2], empty[2]

// statistics kernel
constexpr int kCluster = 8;      // blocks a cluster: row shares
constexpr int kStatWarps = 4;
constexpr int kStatThreads = kStatWarps * 32;
constexpr int kStatStep = 256;   // indices a warp scans a step
constexpr int kStatBatch = 32;   // listed rows a warp stages at once
constexpr int kStatBufs = 3;     // its staging buffers: two batches in flight
constexpr int kStatDims = 64;    // dims a pass over the list adds
constexpr int kStatGroups = 32;  // clusters aimed at
constexpr size_t kStatBudget = 113 * 1024;  // shared memory aimed at: two
                                            // blocks an SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

__device__ __forceinline__ void cp_async_wait_2() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one bulk copy (TMA, no tensor map) of `bytes` from global to shared
// memory, its completion counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a named barrier for `threads` threads (a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += A (16x16 bf16, row) * B (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// a bf16 pair times a power of two held in f32 (exact)
__device__ __forceinline__ uint32_t scale2(uint32_t w, float f) {
  return bits(__hmul2(*reinterpret_cast<__nv_bfloat162*>(&w),
                      __float2bfloat162_rn(f)));
}

// The split of two f32 values (x the lower half of each word) into three
// bf16 pairs: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid).
__device__ __forceinline__ void split2(float x, float y, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hb);
  const float rx = x - hf.x, ry = y - hf.y;  // exact
  const __nv_bfloat162 mb = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(mb);
  const __nv_bfloat162 lb = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  h = bits(hb);
  m = bits(mb);
  l = bits(lb);
}

// (d, j) before (bd, bi): the smaller distance, the lower index on ties.
__device__ __forceinline__ bool before(float d, int j, float bd, int bi) {
  return d < bd || (d == bd && j < bi);
}

// Insert (d, j) into a sorted top-KMAX list held in registers.
template <int KMAX>
__device__ __forceinline__ void insert(float (&bd)[KMAX], int (&bi)[KMAX],
                                       float d, int j) {
  if (!before(d, j, bd[KMAX - 1], bi[KMAX - 1])) return;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    const bool b = before(d, j, bd[i], bi[i]);
    const float td = bd[i];
    const int ti = bi[i];
    bd[i] = b ? d : td;
    bi[i] = b ? j : ti;
    d = b ? td : d;
    j = b ? ti : j;
  }
}

// The power-of-two exponent that brings m's magnitude into [1, 2), clamped
// to [-126, 126] (0 for 0, inf and NaN): the scale of a row or codeword.
__device__ __forceinline__ int scale_exp(float m) {
  if (!(m > 0.f) || !(m < __int_as_float(0x7f800000))) return 0;
  return max(-126, min(126, ilogbf(m)));
}

// 2^e as f32, e in [-126, 127]
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

// The prologue, one block a chunk of kCW codewords, a slice of kDS dims of
// them in shared memory at a time (one coalesced load each, 256 B a dim):
// each codeword's scale 2^b_j (its largest |E[d][j]| in [2^b_j,
// 2^(b_j + 1))) and ||E_j||^2 (four sequential fmaf sums over d = 4i + u,
// added in u order); then every stage (c, q) of the chunk: the split of
// E[:, j] / 2^b_j (exact), the norms and the scales; and the chunk's
// codewords in the codeword-major f32 copy E^T that the gather reads.  A
// width over kDS loads its slices twice (the scales first).
__global__ void __launch_bounds__(256)
prep_codebook_kernel(const float* __restrict__ embed,
                     unsigned char* __restrict__ stages,
                     float* __restrict__ embed_t, int dim, int n_embed,
                     int slices) {
  __shared__ float tile[kDS][kCW + 1];  // [d - q kDS][j - c kCW]
  __shared__ float part_sq[4][kCW];
  __shared__ float part_max[4][kCW];
  __shared__ float down[kCW];  // 2^-b_j
  const int c = blockIdx.x;
  const int jj = threadIdx.x % kCW;
  const int u = threadIdx.x / kCW;  // 0..3
  const int j = c * kCW + jj;
  auto load = [&](int q) {  // slice q of the chunk into tile, zero-padded
    for (int dd = u; dd < kDS; dd += 4) {
      const int d = q * kDS + dd;
      tile[dd][jj] = (d < dim && j < n_embed)
                         ? embed[static_cast<int64_t>(d) * n_embed + j]
                         : 0.f;
    }
  };
  float sq = 0.f, mx = 0.f;
  for (int q = 0; q < slices; ++q) {
    if (q > 0) __syncthreads();  // the previous slice is read
    load(q);
    __syncthreads();
    for (int dd = u; dd < kDS; dd += 4) {  // this thread's d = 4i + u
      const float e = tile[dd][jj];
      sq = fmaf(e, e, sq);
      mx = fmaxf(mx, fabsf(e));
    }
    // E^T rows of the slice: consecutive threads write consecutive d
    for (int t = threadIdx.x; t < kCW * kDS; t += blockDim.x) {
      const int tj = t / kDS;
      const int dd = t % kDS;
      const int d = q * kDS + dd;
      if (c * kCW + tj < n_embed && d < dim) {
        embed_t[static_cast<int64_t>(c * kCW + tj) * dim + d] = tile[dd][tj];
      }
    }
  }
  part_sq[u][jj] = sq;
  part_max[u][jj] = mx;
  __syncthreads();
  if (u == 0) {
    const float s2 = ((part_sq[0][jj] + part_sq[1][jj]) + part_sq[2][jj]) +
                     part_sq[3][jj];
    const int b = scale_exp(fmaxf(fmaxf(part_max[0][jj], part_max[1][jj]),
                                  fmaxf(part_max[2][jj], part_max[3][jj])));
    down[jj] = pow2(-b);
    for (int q = 0; q < slices; ++q) {
      unsigned char* st = stages + (static_cast<int64_t>(c) * slices + q) *
                                       kStageB;
      reinterpret_cast<float*>(st + kEsqOff)[jj] = s2;
      reinterpret_cast<float*>(st + kScaleOff)[jj] = pow2(b);
    }
  }
  // the parts of every slice: thread t takes 8 dims (chunk ch of 9, the last
  // the pad) of codeword tj; tj varies fastest
  for (int q = 0; q < slices; ++q) {
    __syncthreads();  // down[] written; the tile is free to reload
    if (slices > 1) {
      load(q);
      __syncthreads();
    }
    unsigned char* st = stages + (static_cast<int64_t>(c) * slices + q) *
                                     kStageB;
    for (int t = threadIdx.x; t < 9 * kCW; t += blockDim.x) {
      const int tj = t % kCW;
      const int ch = t / kCW;
      uint32_t w[3][4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float v0 = ch < 8 ? tile[ch * 8 + e][tj] * down[tj] : 0.f;
        const float v1 = ch < 8 ? tile[ch * 8 + e + 1][tj] * down[tj] : 0.f;
        split2(v0, v1, w[kHi][e / 2], w[kMid][e / 2], w[kLo][e / 2]);
      }
      unsigned char* row = st + tj * kRowB + ch * 16;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        *reinterpret_cast<uint4*>(row + p * kPartB) =
            make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
      }
    }
  }
}

// Writes the chosen codewords of tile rows [r0, r1) (the tile's first row
// row0): for each rank s < k codeword tab[s * 32 + r] from E^T to q_topk,
// and rank 0 to q1.  The (row, rank) pairs go in order, `lpp` lanes a pair
// (a power of two, so a narrow codeword shares the warp with others), the
// loads of kStoreBatch pairs a lane in flight before their stores: 16-byte
// streaming stores where rows are 16-byte aligned (4 | dim), else 4-byte.
constexpr int kStoreBatch = 8;

template <typename V>
__device__ __forceinline__ void store_rows_v(
    const float* __restrict__ embed_t, const int* tab, int64_t row0, int r0,
    int r1, int k, int n, int dim, float* __restrict__ q_topk,
    float* __restrict__ q1, int lane) {
  constexpr int kPer = sizeof(V) / 4;  // floats a unit
  const int units = dim / kPer;
  int lpp = 1;
  while (lpp < units && lpp < 32) lpp <<= 1;
  const int step = 32 / lpp;  // pairs an instruction
  const int sub = lane / lpp;
  const int pairs = (r1 - r0) * k;
  for (int ub = lane % lpp; ub - lane % lpp < units; ub += lpp) {
    for (int p0 = 0; p0 < pairs; p0 += kStoreBatch * step) {
      V x[kStoreBatch];
      int rs[kStoreBatch];  // (rank << 5) | tile row, -1: none
      int r = r0 + (p0 + sub) / k;  // this lane's pair: row r, rank s
      int s = (p0 + sub) % k;
#pragma unroll
      for (int b = 0; b < kStoreBatch; ++b) {
        const int p = p0 + b * step + sub;
        const bool ok = p < pairs && ub < units && row0 + r < n;
        rs[b] = ok ? (s << 5) | r : -1;
        const int j = ok ? tab[s * 32 + r] : 0;
        x[b] = ok ? __ldg(reinterpret_cast<const V*>(
                            embed_t + static_cast<int64_t>(j) * dim) + ub)
                  : V{};
        for (s += step; s >= k; s -= k) ++r;  // the pair `step` on
      }
#pragma unroll
      for (int b = 0; b < kStoreBatch; ++b) {
        if (rs[b] >= 0) {
          const int r = rs[b] & 31, s = rs[b] >> 5;
          const int64_t row = row0 + r;
          __stcs(reinterpret_cast<V*>(q_topk) + (row * k + s) * units + ub,
                 x[b]);
          if (s == 0) __stcs(reinterpret_cast<V*>(q1) + row * units + ub, x[b]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store_rows(const float* __restrict__ embed_t,
                                           const int* tab, int64_t row0,
                                           int r0, int r1, int k, int n,
                                           int dim, bool vec4,
                                           float* __restrict__ q_topk,
                                           float* __restrict__ q1, int lane) {
  if (vec4) {
    store_rows_v<float4>(embed_t, tab, row0, r0, r1, k, n, dim, q_topk, q1,
                         lane);
  } else {
    store_rows_v<float>(embed_t, tab, row0, r0, r1, k, n, dim, q_topk, q1,
                        lane);
  }
}

// Stage a warp's 32 rows, dims [d0, d0 + 16 ksteps), into its buffer (pitch
// kPitch elements of T); rows >= n and dims >= dim are zero.  cp.async by
// 16-byte chunks when rows are 16-byte aligned, else element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ flat, int n,
                                           int dim, int64_t row0, int d0,
                                           int ksteps, bool vec, T* dst,
                                           int lane) {
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte chunk
  const int cols = ksteps * 16;
  if (vec) {
    const int per_row = cols / kVec;
    for (int i = lane; i < kTileRows * per_row; i += 32) {
      const int r = i / per_row;
      const int ch = i - r * per_row;
      const int64_t row = row0 + r;
      const int d = d0 + ch * kVec;
      const bool ok = row < n && d < dim;  // dim % kVec == 0: whole chunks
      const T* src = flat + (ok ? row * dim + d : 0);
      cp_async16(dst + r * kPitch + ch * kVec, src, ok ? 16 : 0);
    }
  } else {
    for (int i = lane; i < kTileRows * cols; i += 32) {
      const int r = i / cols;
      const int dd = i - r * cols;
      const int64_t row = row0 + r;
      const int d = d0 + dd;
      dst[r * kPitch + dd] =
          (row < n && d < dim) ? flat[row * dim + d] : static_cast<T>(0.f);
    }
  }
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(Lk<KMAX>::kThreads, 1)
quantize_topk_kernel(const T* __restrict__ flat,
                     const unsigned char* __restrict__ stages,
                     const float* __restrict__ embed_t,
                     unsigned char* __restrict__ list_scratch,
                     float* __restrict__ q_topk, float* __restrict__ q1,
                     int* __restrict__ idx, int n, int dim, int n_embed,
                     int k, int lists_in_smem) {
  constexpr bool kStage = KMAX == kStaged;
  constexpr bool kQuad = Lk<KMAX>::kQuad;
  constexpr bool kTable = Lk<KMAX>::kTable;
  constexpr bool kLane = KMAX == kLaneK;
  constexpr int kList = kQuad ? KMAX : 1;   // MMA-layout list length
  constexpr int kLL = kLane ? kLaneK : 1;   // a lane's row list length
  constexpr int W = Lk<KMAX>::kWarps;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);  // split: full[2], then empty[2]
  unsigned char* bbuf = smem + kBarBytes;  // [2][kStageB]
  T* abuf = reinterpret_cast<T*>(bbuf + 2 * kStageB);  // [W][2][32][kPitch]
  // after the row buffers: unless kQuad, each warp's distance tile
  // [32][kDistPitch]; then unless kStage each warp's index table
  // [KMAX][32], else (where they fit) its lanes' lists
  float* dist = reinterpret_cast<float*>(
      bbuf + 2 * kStageB + W * 2 * kTileRows * kPitch * sizeof(T));
  float* after_dist = dist + (kQuad ? 0 : W * kTileRows * kDistPitch);
  int* my_tab = reinterpret_cast<int*>(after_dist) +
                (threadIdx.x >> 5) * (kStage ? 1 : KMAX) * 32;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // accumulator row (and row + 8), B column
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1

  const int chunks = (n_embed + kCW - 1) / kCW;
  const int slices = (dim + kDS - 1) / kDS;
  const bool resident = slices == 1;  // a tile's rows staged once
  const bool b_const = chunks * slices == 1;  // one stage: loaded once
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = dim % kVec == 0;
  const bool vec4 = (dim & 3) == 0;
  const int64_t warp_tiles = (static_cast<int64_t>(n) + kTileRows - 1) /
                             kTileRows;
  // A small N (a tile a block at most): the block's last warp feeds the
  // stage buffers as a ring (a bulk copy a stage on an mbarrier pair), and
  // the other Wc warps all take the block's tile, warp w the chunks c with
  // c % Wc == w, each at its own pace; warp 0 merges their lists.  Else
  // all W warps score stages in lockstep, each a tile of its own.
  const bool split = !kStage && resident && chunks > 1 &&
                     warp_tiles <= static_cast<int64_t>(gridDim.x);
  const int Wc = split ? W - 1 : W;  // the warps that score
  const int64_t per_iter = static_cast<int64_t>(gridDim.x) * (split ? 1 : W);
  const int64_t iters = (warp_tiles + per_iter - 1) / per_iter;
  const int per_tile = chunks * slices;
  const int64_t total = iters * per_tile;
  T* my_a = abuf + warp * 2 * kTileRows * kPitch;

  // this warp's distance tile and (kStage) its lanes' lists [k][32]
  // (distances, then indices)
  float* my_dist = dist + warp * kTileRows * kDistPitch;
  float* ld = nullptr;
  int* li = nullptr;
  if constexpr (kStage) {
    float* base = lists_in_smem
                      ? after_dist
                      : reinterpret_cast<float*>(list_scratch) +
                            static_cast<int64_t>(blockIdx.x) * W * 64 * k;
    ld = base + warp * 64 * k;
    li = reinterpret_cast<int*>(ld + 32 * k);
  }

  auto tile_of = [&](int64_t it) {
    return it * per_iter +
           (split ? 0 : static_cast<int64_t>(warp) * gridDim.x) + blockIdx.x;
  };
  // the table the stores read: warp 0's when split
  const int* store_tab =
      split ? reinterpret_cast<const int*>(after_dist) : my_tab;
  // this warp's share of tile rows [r0, r1) when split
  auto share = [&](int r0, int r1, int& a, int& b) {
    a = split ? r0 + (r1 - r0) * warp / Wc : r0;
    b = split ? r0 + (r1 - r0) * (warp + 1) / Wc : r1;
  };
  auto full = [&](int slot) { return bars + 8u * slot; };
  auto empty = [&](int slot) { return bars + 8u * (2 + slot); };
  if (split) {
    if (threadIdx.x == 0) {
      for (int slot = 0; slot < 2; ++slot) {
        mbar_init(full(slot), 1);
        mbar_init(empty(slot), Wc);  // one arrival a scoring warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == Wc) {  // the producer
      if (lane == 0) {
        for (int64_t s = 0; s < total; ++s) {
          const int slot = static_cast<int>(s & 1);
          mbar_wait(empty(slot), static_cast<uint32_t>((s >> 1) & 1) ^ 1u);
          mbar_expect_tx(full(slot), kStageB);
          bulk_load(smem_u32(bbuf + slot * kStageB),
                    stages + (s % per_tile) * kStageB, kStageB, full(slot));
        }
      }
      return;
    }
  }
  auto ksteps_of = [&](int q) { return min(4, (dim - q * kDS + 15) / 16); };

  // Issue the copies of stage s: the block's codebook stage (c, q), and the
  // warp's rows where they change.
  auto load_stage = [&](int64_t s) {
    const int64_t it = s / per_tile;
    const int rem = static_cast<int>(s - it * per_tile);
    const int c = rem / slices;
    const int q = rem - c * slices;
    if (!split && (!b_const || s == 0)) {
      const unsigned char* src = stages + static_cast<int64_t>(rem) * kStageB;
      unsigned char* dst = bbuf + (b_const ? 0 : (s & 1)) * kStageB;
      for (int i = threadIdx.x; i < kStageB / 16; i += Lk<KMAX>::kThreads) {
        cp_async16(dst + i * 16, src + i * 16, 16);
      }
    }
    const int64_t tile = tile_of(it);
    if (tile < warp_tiles && (!resident || c == 0)) {
      const int buf = static_cast<int>(resident ? (it & 1) : (s & 1));
      stage_rows<T>(flat, n, dim, tile * kTileRows, q * kDS, ksteps_of(q),
                    vec, my_a + buf * kTileRows * kPitch, lane);
    }
  };

  float acc[2][8][4];
  // the scales of the lane's accumulator rows 16 mt + 8 h + g: 2^-a_r for
  // their latents, -2 * 2^a_r for their distances
  float fa[2][2], fd[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      fa[mt][h] = 1.f;
      fd[mt][h] = -2.f;
    }
  }
  float bd[2][2][kList];
  int bi[2][2][kList];
  float rd[kLL];  // kLane: lane r's list for tile row r
  int ri[kLL];
  auto reset_lists = [&]() {
#pragma unroll
    for (int i = 0; i < kLL; ++i) {
      rd[i] = __int_as_float(0x7f800000);
      ri[i] = INT_MAX;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < kList; ++i) {
          bd[mt][h][i] = __int_as_float(0x7f800000);
          bi[mt][h][i] = INT_MAX;
        }
      }
    }
    if constexpr (kStage) {
      for (int i = 0; i < k; ++i) {
        ld[i * 32 + lane] = __int_as_float(0x7f800000);
        li[i * 32 + lane] = INT_MAX;
      }
    }
  };
  reset_lists();
  float thr_d = __int_as_float(0x7f800000);  // k > 16: its list's last entry
  int thr_i = INT_MAX;

  // k <= 16: the previous tile's first row (its indices in a table), stored
  // in slices while this tile is scored
  int64_t prev_row0 = -1;

  load_stage(0);
  cp_async_commit();
  for (int64_t s = 0; s < total; ++s) {
    if (s + 1 < total) load_stage(s + 1);
    cp_async_commit();
    cp_async_wait_prev();  // stage s has landed (split: this warp's rows)
    if (split) {
      __syncwarp();
      mbar_wait(full(static_cast<int>(s & 1)),
                static_cast<uint32_t>((s >> 1) & 1));
    } else {
      __syncthreads();
    }

    const int64_t it = s / per_tile;
    const int rem = static_cast<int>(s - it * per_tile);
    const int c = rem / slices;
    const int q = rem - c * slices;
    const int64_t tile = tile_of(it);
    const bool active = tile < warp_tiles;  // warp-uniform
    const bool mine = !split || c % Wc == warp;  // this warp scores chunk c
    const unsigned char* bst = bbuf + (b_const ? 0 : (s & 1)) * kStageB;
    const T* a = my_a + (resident ? (it & 1) : (s & 1)) * kTileRows * kPitch;

    if (q == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        }
      }
    }
    if (active && c == 0 && q == 0) {
      // the tile's row scales: lane r finds its row's largest |z|
      float mx = 0.f;
      if (resident) {
        const T* ar = a + lane * kPitch;
        for (int d = 0; d < dim; ++d) mx = fmaxf(mx, fabsf(to_f32(ar[d])));
      } else if (tile * kTileRows + lane < n) {
        const T* zr = flat + (tile * kTileRows + lane) * dim;
        for (int d = 0; d < dim; ++d) mx = fmaxf(mx, fabsf(to_f32(zr[d])));
      }
      const int ea = scale_exp(mx);
      const float up = pow2(-ea), dn = -pow2(ea + 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          fa[mt][h] = __shfl_sync(kFull, up, 16 * mt + 8 * h + g);
          fd[mt][h] = __shfl_sync(kFull, dn, 16 * mt + 8 * h + g);
        }
      }
    }
    if (active && mine) {
      const int ks_n = ksteps_of(q);
      for (int ks = 0; ks < ks_n; ++ks) {
        // A fragments of both m16 tiles: rows 16 mt + g (+ 8), k 2t, 2t + 1
        // (+ 8), scaled by their rows' 2^-a_r; float32 latents split into
        // three parts
        uint32_t ah[2][4], am[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if constexpr (kF32) {
            const float* ar = reinterpret_cast<const float*>(a) +
                              (16 * mt + g) * kPitch + 16 * ks + 2 * t;
            const float2 x0 = *reinterpret_cast<const float2*>(ar);
            const float2 x1 = *reinterpret_cast<const float2*>(ar + 8 * kPitch);
            const float2 x2 = *reinterpret_cast<const float2*>(ar + 8);
            const float2 x3 =
                *reinterpret_cast<const float2*>(ar + 8 * kPitch + 8);
            const float s0 = fa[mt][0], s1 = fa[mt][1];
            split2(x0.x * s0, x0.y * s0, ah[mt][0], am[mt][0], al[mt][0]);
            split2(x1.x * s1, x1.y * s1, ah[mt][1], am[mt][1], al[mt][1]);
            split2(x2.x * s0, x2.y * s0, ah[mt][2], am[mt][2], al[mt][2]);
            split2(x3.x * s1, x3.y * s1, ah[mt][3], am[mt][3], al[mt][3]);
          } else {
            const int r = 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
            ldmatrix_x4(ah[mt], a + r * kPitch + 16 * ks + 8 * (lane >> 4));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[mt][i] = scale2(ah[mt][i], fa[mt][i & 1]);
            }
          }
        }
        // B fragments, two n8 tiles an ldmatrix: codewords 16 np + 8 (l/16)
        // + l % 8, k chunk 8 ((l / 8) % 2) of the k-step
        const unsigned char* brow =
            bst + (8 * (lane >> 4) + (lane & 7)) * kRowB +
            (16 * ks + 8 * ((lane >> 3) & 1)) * 2;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bh[4], bm[4], bl[4];
          ldmatrix_x4(bh, brow + kHi * kPartB + 16 * np * kRowB);
          ldmatrix_x4(bm, brow + kMid * kPartB + 16 * np * kRowB);
          ldmatrix_x4(bl, brow + kLo * kPartB + 16 * np * kRowB);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int nt = 2 * np + h2;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              // the smallest terms first
              if constexpr (kF32) {
                mma_bf16(acc[mt][nt], al[mt], bh[2 * h2], bh[2 * h2 + 1]);
                mma_bf16(acc[mt][nt], ah[mt], bl[2 * h2], bl[2 * h2 + 1]);
                mma_bf16(acc[mt][nt], am[mt], bm[2 * h2], bm[2 * h2 + 1]);
                mma_bf16(acc[mt][nt], am[mt], bh[2 * h2], bh[2 * h2 + 1]);
                mma_bf16(acc[mt][nt], ah[mt], bm[2 * h2], bm[2 * h2 + 1]);
              } else {
                mma_bf16(acc[mt][nt], ah[mt], bl[2 * h2], bl[2 * h2 + 1]);
                mma_bf16(acc[mt][nt], ah[mt], bm[2 * h2], bm[2 * h2 + 1]);
              }
              mma_bf16(acc[mt][nt], ah[mt], bh[2 * h2], bh[2 * h2 + 1]);
            }
          }
        }
      }
    }

    if (q == slices - 1) {  // chunk c scored: its distances
      const float* esq = reinterpret_cast<const float*>(bst + kEsqOff);
      const float* fb = reinterpret_cast<const float*>(bst + kScaleOff);
      const int j0 = c * kCW;
      if constexpr (kQuad) {
        if (active && mine) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = 8 * nt + 2 * t;
            const float2 e2 = *reinterpret_cast<const float2*>(esq + col);
            const float2 f2 = *reinterpret_cast<const float2*>(fb + col);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + col + e;
              if (j < n_embed) {  // a ragged chunk's gap is never ranked
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    // -2 z.E = acc * -2 * 2^(a_r + b_j), exact in the fma
                    float d = fmaf(acc[mt][nt][2 * h + e],
                                   fd[mt][h] * (e ? f2.y : f2.x),
                                   e ? e2.y : e2.x);
                    d = d == d ? d : __int_as_float(0x7f800000);
                    insert<KMAX>(bd[mt][h], bi[mt][h], d, j);
                  }
                }
              }
            }
          }
        }
      } else if (active && mine) {
        // the chunk's distance tile, then lane r takes row r's candidates
        // in increasing index order into its list
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = 8 * nt + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float d = fmaf(acc[mt][nt][2 * h + e],
                               fd[mt][h] * fb[col + e], esq[col + e]);
                d = d == d ? d : __int_as_float(0x7f800000);
                my_dist[(16 * mt + 8 * h + g) * kDistPitch + col + e] = d;
              }
            }
          }
        }
        __syncwarp();
        const int cols = min(kCW, n_embed - j0);
        const float* drow = my_dist + lane * kDistPitch;
        if constexpr (kLane) {
          if (!__all_sync(kFull, ri[kLaneK - 1] != INT_MAX)) {
            // a list still filling takes every column
            for (int cc = 0; cc < cols; ++cc) {
              insert<kLaneK>(rd, ri, drow[cc], j0 + cc);
            }
          } else {
            // the columns that beat the list's last entry before the chunk,
            // then rounds of one insert a lane: the warp runs as many
            // inserts as its busiest row needs, not one a column
            unsigned long long pass = 0;
            for (int cc = 0; cc < cols; ++cc) {
              if (before(drow[cc], j0 + cc, rd[kLaneK - 1], ri[kLaneK - 1])) {
                pass |= 1ull << cc;
              }
            }
            while (__any_sync(kFull, pass != 0)) {
              if (pass != 0) {
                const int cc = __ffsll(static_cast<long long>(pass)) - 1;
                pass &= pass - 1;
                insert<kLaneK>(rd, ri, drow[cc], j0 + cc);
              }
            }
          }
        } else {
          for (int cc = 0; cc < cols; ++cc) {
            const float d = drow[cc];
            const int j = j0 + cc;
            if (before(d, j, thr_d, thr_i)) {
              int i = k - 1;
              for (; i > 0; --i) {
                const float pd = ld[(i - 1) * 32 + lane];
                const int pi = li[(i - 1) * 32 + lane];
                if (!before(d, j, pd, pi)) break;
                ld[i * 32 + lane] = pd;
                li[i * 32 + lane] = pi;
              }
              ld[i * 32 + lane] = d;
              li[i * 32 + lane] = j;
              thr_d = ld[(k - 1) * 32 + lane];
              thr_i = li[(k - 1) * 32 + lane];
            }
          }
        }
        __syncwarp();
      }
      if constexpr (kTable) {
        if (prev_row0 >= 0) {
          int ra, rb;
          share(kTileRows * c / chunks, kTileRows * (c + 1) / chunks, ra, rb);
          store_rows(embed_t, store_tab, prev_row0, ra, rb, k, n, dim, vec4,
                     q_topk, q1, lane);
        }
        if (c == chunks - 1) {  // the tile's lists are complete
          __syncwarp();  // the previous tile's rows are stored
          if constexpr (kQuad) {
            // merge the quad's four lists: afterwards every lane of quad g
            // holds the top-K of rows g and g + 8 of both m16 tiles
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  float ov[kList];
                  int oi[kList];
#pragma unroll
                  for (int i = 0; i < kList; ++i) {
                    ov[i] = __shfl_xor_sync(kFull, bd[mt][h][i], off);
                    oi[i] = __shfl_xor_sync(kFull, bi[mt][h][i], off);
                  }
#pragma unroll
                  for (int i = 0; i < kList; ++i) {
                    insert<kList>(bd[mt][h], bi[mt][h], ov[i], oi[i]);
                  }
                }
              }
            }
            if (!split) {
              // lane l takes tile row l's indices (m16 tile l / 16, half
              // (l / 8) % 2, held by quad l % 8) into the table
              const int src = 4 * (lane & 7);
#pragma unroll
              for (int i = 0; i < kList; ++i) {
                const int i00 = __shfl_sync(kFull, bi[0][0][i], src);
                const int i01 = __shfl_sync(kFull, bi[0][1][i], src);
                const int i10 = __shfl_sync(kFull, bi[1][0][i], src);
                const int i11 = __shfl_sync(kFull, bi[1][1][i], src);
                my_tab[i * 32 + lane] = lane < 16 ? ((lane & 8) ? i01 : i00)
                                                  : ((lane & 8) ? i11 : i10);
              }
            }
          } else if (!split) {
#pragma unroll
            for (int i = 0; i < kLL; ++i) my_tab[i * 32 + lane] = ri[i];
          }
          if (split) {
            // Each warp's lists of its chunks go to its row buffer (free
            // now: the next tile lands in the other), [i][row] distances
            // then indices; warp 0's lane r merges row r's in warp order.
            constexpr int KM = kQuad ? kList : kLaneK;
            float* md = reinterpret_cast<float*>(
                my_a + (it & 1) * kTileRows * kPitch);
            int* mi = reinterpret_cast<int*>(md + KM * 32);
            if constexpr (kQuad) {
              if (t == 0) {  // quad g's lists are its rows' merged lists
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
#pragma unroll
                    for (int i = 0; i < kList; ++i) {
                      md[i * 32 + 16 * mt + 8 * h + g] = bd[mt][h][i];
                      mi[i * 32 + 16 * mt + 8 * h + g] = bi[mt][h][i];
                    }
                  }
                }
              }
            } else {
#pragma unroll
              for (int i = 0; i < kLL; ++i) {
                md[i * 32 + lane] = rd[i];
                mi[i * 32 + lane] = ri[i];
              }
            }
            bar_sync(1, Wc * 32);
            if (warp == 0) {
              float od[KM];
              int oi[KM];
#pragma unroll
              for (int i = 0; i < KM; ++i) {
                od[i] = md[i * 32 + lane];
                oi[i] = mi[i * 32 + lane];
              }
              for (int w = 1; w < Wc; ++w) {
                const float* wd = reinterpret_cast<const float*>(
                    abuf + (w * 2 + (it & 1)) * kTileRows * kPitch);
                const int* wi = reinterpret_cast<const int*>(wd + KM * 32);
#pragma unroll
                for (int i = 0; i < KM; ++i) {
                  insert<KM>(od, oi, wd[i * 32 + lane], wi[i * 32 + lane]);
                }
              }
#pragma unroll
              for (int i = 0; i < KM; ++i) my_tab[i * 32 + lane] = oi[i];
            }
            bar_sync(1, Wc * 32);
          }
          __syncwarp();
          prev_row0 = active ? tile * kTileRows : -1;
          if (active && (!split || warp == 0) && prev_row0 + lane < n) {
            idx[prev_row0 + lane] = my_tab[lane];
          }
          reset_lists();
        }
      } else if (active && c == chunks - 1) {
        // k > kLaneK: the tile's lists are complete: store them
        const int64_t row0 = tile * kTileRows;
        if (row0 + lane < n) idx[row0 + lane] = li[lane];
        store_rows(embed_t, li, row0, 0, kTileRows, k, n, dim, vec4, q_topk,
                   q1, lane);
        __syncwarp();
        reset_lists();
        thr_d = __int_as_float(0x7f800000);
        thr_i = INT_MAX;
      }
    }
    if (split) {
      __syncwarp();  // this warp is done with stage s's buffer
      if (lane == 0) mbar_arrive(empty(static_cast<int>(s & 1)));
    } else {
      __syncthreads();  // every warp is done with stage s's buffers
    }
  }
  if constexpr (kTable) {
    if (prev_row0 >= 0) {
      int ra, rb;
      share(0, kTileRows, ra, rb);
      store_rows(embed_t, store_tab, prev_row0, ra, rb, k, n, dim, vec4,
                 q_topk, q1, lane);
    }
  }
}

// The lookup kernel's dynamic shared memory: split mode's mbarriers, the
// codebook stages, each warp's two row buffers, for k > 8 its distance
// tile, and its index table (k <= 16) or, where they fit, its lanes' lists.
template <typename T, int KMAX>
size_t lookup_smem(int k, bool lists) {
  constexpr int W = Lk<KMAX>::kWarps;
  size_t bytes = kBarBytes + 2 * kStageB +
                 static_cast<size_t>(W) * 2 * kTileRows * kPitch * sizeof(T);
  if (!Lk<KMAX>::kQuad) {
    bytes += static_cast<size_t>(W) * kTileRows * kDistPitch * 4;
  }
  if (KMAX == kStaged) {
    if (lists) bytes += static_cast<size_t>(W) * 64 * k * 4;
  } else {
    bytes += static_cast<size_t>(W) * KMAX * 32 * 4;  // index tables
  }
  return bytes;
}

int optin_smem() {
  int dev = 0;
  int optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return optin;
}

// k > 16: whether the lanes' lists fit shared memory beside the rest
template <typename T>
bool lists_fit(int k) {
  return lookup_smem<T, kStaged>(k, true) <=
         static_cast<size_t>(optin_smem());
}

// The statistics kernel's codewords a cluster and shared memory.
struct StatShape {
  int j;        // codewords a cluster
  int groups;   // clusters
  size_t smem;  // dynamic shared memory a block
};

size_t stat_smem(int dim, int j, int esize) {
  const int dsl = (dim + kCluster - 1) / kCluster;  // d a block writes out
  return static_cast<size_t>(kStatWarps) * kStatBufs * kStatBatch * kStatDims *
             esize +
         static_cast<size_t>(kStatWarps) * kStatStep * 4 +
         static_cast<size_t>(j) *
             (static_cast<size_t>(kStatWarps) * dim * 4 + kStatWarps * 4 +
              static_cast<size_t>(kCluster) * dsl * 4 + kCluster * 4);
}

StatShape stat_shape(int dim, int n_embed, int esize) {
  int j = (n_embed + kStatGroups - 1) / kStatGroups;
  while (j > 1 && stat_smem(dim, j, esize) > kStatBudget) --j;
  return StatShape{j, (n_embed + j - 1) / j, stat_smem(dim, j, esize)};
}

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

// counts[j] and embed_sum[:, j] for the J codewords of cluster blockIdx.x / 8
// (see "B2" above).  0 < n < 2^31 - 8; idx 16-byte aligned.
template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kStatThreads)
ema_stats_kernel(const T* __restrict__ flat, const int* __restrict__ idx,
                 float* __restrict__ counts, float* __restrict__ embed_sum,
                 int n, int dim, int n_embed, int J) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte chunk
  const int dsl = (dim + kCluster - 1) / kCluster;
  T* stage = reinterpret_cast<T*>(smem);  // [warp][buf][batch][kStatDims]
  int* lists = reinterpret_cast<int*>(
      smem + kStatWarps * kStatBufs * kStatBatch * kStatDims * sizeof(T));
  float* part = reinterpret_cast<float*>(lists + kStatWarps * kStatStep);
  int* part_n = reinterpret_cast<int*>(part + kStatWarps * J * dim);  // [w][J]
  float* recv = reinterpret_cast<float*>(part_n + kStatWarps * J);  // [8][J][dsl]
  int* recv_n = reinterpret_cast<int*>(recv + kCluster * J * dsl);  // [8][J]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x / kCluster * J;
  const unsigned below = (1u << lane) - 1u;
  const bool vec = dim % kVec == 0;
  float* my_part = part + warp * J * dim;
  int* my_list = lists + warp * kStatStep;
  T* my_stage = stage + warp * kStatBufs * kStatBatch * kStatDims;

  for (int i = threadIdx.x; i < kStatWarps * J * dim; i += kStatThreads) {
    part[i] = 0.f;
  }
  for (int i = threadIdx.x; i < kStatWarps * J; i += kStatThreads) {
    part_n[i] = 0;
  }
  cluster.sync();  // every block of the cluster runs before any pushes

  // block `rank` sums rows [rank seg_b, (rank + 1) seg_b), its warp w the
  // w-th part of those; both lengths multiples of 4
  const int seg_b = static_cast<int>(
      ((static_cast<unsigned>(n) + kCluster - 1) / kCluster + 3) & ~3u);
  const int seg_w = ((seg_b + kStatWarps - 1) / kStatWarps + 3) & ~3;
  const int block_end = min(n, (rank + 1) * seg_b);
  const int begin = rank * seg_b + warp * seg_w;
  const int end = min(block_end, begin + seg_w);

  int4 cur[kStatStep / 128];  // lane l: rows base + 128 u + 4 l + {0..3}
#pragma unroll
  for (int u = 0; u < kStatStep / 128; ++u) {
    cur[u] = load_idx4(idx, begin + u * 128 + 4 * lane, end);
  }
  for (int base = begin; base < end; base += kStatStep) {
    // list the step's matches in row order: (row - base) << 16 | (j - j0)
    int listed = 0;
#pragma unroll
    for (int u = 0; u < kStatStep / 128; ++u) {
      const int v[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
      unsigned m = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m |= (static_cast<unsigned>(v[e] - j0) < static_cast<unsigned>(J)) << e;
      }
      int at = listed;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned b = __ballot_sync(kFull, (m >> e) & 1u);
        at += __popc(b & below);  // matches of the lower lanes
        listed += __popc(b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if ((m >> e) & 1u) {
          my_list[at++] = ((u * 128 + 4 * lane + e) << 16) | (v[e] - j0);
        }
      }
    }
    __syncwarp();
    // the next step's indices are in flight while this step's rows add up
#pragma unroll
    for (int u = 0; u < kStatStep / 128; ++u) {
      cur[u] = load_idx4(idx, base + kStatStep + u * 128 + 4 * lane, end);
    }
    for (int dc = 0; dc < dim; dc += kStatDims) {
      // Stage the listed rows' dims [dc, dc + kStatDims) in batches of 32,
      // the next two batches in flight while the warp adds one: 16-byte
      // cp.async chunks where rows are 16-byte aligned, else element loads;
      // dims past the width and rows past the list are zero.  A group is
      // committed for every batch, empty past the list.
      const int width = min(kStatDims, dim - dc);
      auto stage_batch = [&](int i, int buf) {
        T* dst = my_stage + buf * kStatBatch * kStatDims;
        const int rows = max(0, min(listed - i, kStatBatch));
        if (rows == 0) {
          // nothing to stage: the group stays empty
        } else if (vec) {
          constexpr int kPerRow = kStatDims / kVec;
          for (int e = lane; e < kStatBatch * kPerRow; e += 32) {
            const int r = e / kPerRow;
            const int ch = e - r * kPerRow;
            const bool ok = r < rows && ch * kVec < width;
            const int64_t row = ok ? base + (my_list[i + r] >> 16) : 0;
            cp_async16(dst + r * kStatDims + ch * kVec,
                       flat + row * dim + dc + (ok ? ch * kVec : 0),
                       ok ? 16 : 0);
          }
        } else {
          for (int e = lane; e < kStatBatch * kStatDims; e += 32) {
            const int r = e / kStatDims;
            const int dd = e - r * kStatDims;
            dst[e] = (r < rows && dd < width)
                         ? flat[(base + (my_list[i + r] >> 16)) *
                                    static_cast<int64_t>(dim) + dc + dd]
                         : static_cast<T>(0.f);
          }
        }
        cp_async_commit();
      };
      const bool d0 = lane < width, d1 = lane + 32 < width;
      float run0 = 0.f, run1 = 0.f;
      int cur_q = -1;
      int run_n = 0;
      auto flush = [&]() {
        if (cur_q >= 0) {
          float* p = my_part + cur_q * dim + dc + lane;
          if (d0) p[0] += run0;
          if (d1) p[32] += run1;
          if (dc == 0 && lane == 0) part_n[warp * J + cur_q] += run_n;
        }
        run0 = run1 = 0.f;
        run_n = 0;
      };
      if (listed > 0) {
        stage_batch(0, 0);
        stage_batch(kStatBatch, 1);
      }
      for (int i = 0, buf = 0; i < listed;
           i += kStatBatch, buf = buf == kStatBufs - 1 ? 0 : buf + 1) {
        stage_batch(i + 2 * kStatBatch,
                    buf >= kStatBufs - 2 ? buf + 2 - kStatBufs : buf + 2);
        cp_async_wait_2();  // batch i has landed
        __syncwarp();
        const T* src = my_stage + buf * kStatBatch * kStatDims;
        const int rows = min(listed - i, kStatBatch);
        const int mine = lane < rows ? my_list[i + lane] & 0xffff : -1;
        for (int b = 0; b < rows; ++b) {  // the batch's rows in order
          const int q = __shfl_sync(kFull, mine, b);
          if (q != cur_q) {
            flush();
            cur_q = q;
          }
          run0 += to_f32(src[b * kStatDims + lane]);
          run1 += to_f32(src[b * kStatDims + lane + 32]);
          ++run_n;
        }
        __syncwarp();  // this buffer is restaged three batches on
      }
      flush();
      __syncwarp();
    }
    __syncwarp();  // the list is rewritten next step
  }
  __syncthreads();

  // The block's partial, the warps' in warp order; each entry pushed to the
  // block that writes its d out (d / dsl), the counts to block 0.
  for (int i = threadIdx.x; i < J * dim; i += kStatThreads) {
    const int q = i / dim;
    const int d = i - q * dim;
    float s = part[i];
#pragma unroll
    for (int w = 1; w < kStatWarps; ++w) s += part[w * J * dim + i];
    const int owner = d / dsl;
    float* to = cluster.map_shared_rank(recv, owner);
    to[(rank * J + q) * dsl + d - owner * dsl] = s;
  }
  for (int q = threadIdx.x; q < J; q += kStatThreads) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kStatWarps; ++w) c += part_n[w * J + q];
    cluster.map_shared_rank(recv_n, 0)[rank * J + q] = c;
  }
  cluster.sync();

  // the pushed partials of d in [dsl rank, dsl (rank + 1)), in block order;
  // nothing remote is read after the sync
  for (int i = threadIdx.x; i < dsl * J; i += kStatThreads) {
    const int dl = i / J;
    const int q = i - dl * J;
    const int d = rank * dsl + dl;
    if (d < dim && j0 + q < n_embed) {
      float s = recv[q * dsl + dl];
#pragma unroll
      for (int r = 1; r < kCluster; ++r) s += recv[(r * J + q) * dsl + dl];
      embed_sum[static_cast<int64_t>(d) * n_embed + j0 + q] = s;
    }
  }
  if (rank == 0) {
    for (int q = threadIdx.x; q < J; q += kStatThreads) {
      if (j0 + q < n_embed) {
        int c = 0;
#pragma unroll
        for (int r = 0; r < kCluster; ++r) c += recv_n[r * J + q];
        counts[j0 + q] = static_cast<float>(c);
      }
    }
  }
}

// Calls f(KMax<KMAX>{}) with the smallest list length that holds k.
template <int KMAX>
struct KMax {
  static constexpr int value = KMAX;
};

template <typename F>
cudaError_t with_kmax(int k, F&& f) {
  if (k < 1) return cudaErrorInvalidValue;
  if (k <= 2) return f(KMax<2>{});
  if (k <= 4) return f(KMax<4>{});
  if (k <= kMaxK) return f(KMax<8>{});
  if (k <= kLaneK) return f(KMax<kLaneK>{});
  return f(KMax<kStaged>{});
}

template <typename F>
cudaError_t with_type(int flat_bf16, F&& f) {
  if (flat_bf16) return f(__nv_bfloat16{});
  return f(float{});
}

// Blocks a launch uses: one wave of persistent blocks (the occupancy
// calculator's count per SM times the SMs), or one a warp-tile when N is
// small.  Also raises both kernels' shared-memory limits.
template <typename T, int KMAX>
cudaError_t grid_size(int n, int dim, int n_embed, int k, int* grid) {
  auto kernel = quantize_topk_kernel<T, KMAX>;
  const size_t smem =
      lookup_smem<T, KMAX>(k, KMAX == kStaged && lists_fit<T>(k));
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  const int optin = optin_smem();
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // the opt-in maximum, not these sizes' need: one instantiation serves
  // every size, and a later call for a smaller one must not lower it
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(ema_stats_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, Lk<KMAX>::kThreads, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t warp_tiles = (static_cast<int64_t>(n) + kTileRows - 1) /
                             kTileRows;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  *grid = static_cast<int>(warp_tiles < resident ? warp_tiles : resident);
  return cudaSuccess;
}

int64_t stage_bytes(int dim, int n_embed) {
  const int64_t chunks = (n_embed + kCW - 1) / kCW;
  const int64_t slices = (dim + kDS - 1) / kDS;
  return chunks * slices * kStageB;
}

// scratch: the stages, then E^T (n_embed * dim f32), then for k > 16 lists
// that do not fit shared memory (grid * warps * 64 k f32)
int64_t scratch_bytes(int flat_bf16, int dim, int n_embed, int k, int grid) {
  int64_t bytes = stage_bytes(dim, n_embed) +
                  static_cast<int64_t>(n_embed) * dim * 4;
  bytes = (bytes + 15) & ~int64_t{15};
  if (k > kLaneK && !(flat_bf16 ? lists_fit<__nv_bfloat16>(k)
                                : lists_fit<float>(k))) {
    bytes += static_cast<int64_t>(grid) * Lk<kStaged>::kWarps * 64 * k * 4;
  }
  return bytes;
}

// The prologue, then B1's kernel.
cudaError_t launch_lookup(const void* flat, int flat_bf16, const float* embed,
                          unsigned char* scratch, float* q_topk, float* q1,
                          int* idx, int grid, int n, int dim, int n_embed,
                          int k, cudaStream_t stream) {
  const int chunks = (n_embed + kCW - 1) / kCW;
  const int slices = (dim + kDS - 1) / kDS;
  unsigned char* stages = scratch;
  float* embed_t = reinterpret_cast<float*>(scratch + stage_bytes(dim, n_embed));
  unsigned char* lists = reinterpret_cast<unsigned char*>(embed_t) +
                         ((static_cast<int64_t>(n_embed) * dim * 4 + 15) &
                          ~int64_t{15});
  prep_codebook_kernel<<<chunks, 256, 0, stream>>>(embed, stages, embed_t,
                                                   dim, n_embed, slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return with_type(flat_bf16, [&](auto tv) {
    using T = decltype(tv);
    return with_kmax(k, [&](auto km) {
      constexpr int KMAX = decltype(km)::value;
      const bool fit = KMAX == kStaged && lists_fit<T>(k);
      quantize_topk_kernel<T, KMAX>
          <<<grid, Lk<KMAX>::kThreads, lookup_smem<T, KMAX>(k, fit),
             stream>>>(static_cast<const T*>(flat), stages, embed_t, lists,
                       q_topk, q1, idx, n, dim, n_embed, k, fit ? 1 : 0);
      return cudaGetLastError();
    });
  });
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the lookup kernel needs for these
// sizes (k > 16: its lists in shared memory where they fit).
long long ammc_quantize_topk_smem_bytes(int flat_bf16, int dim, int n_embed,
                                        int k) {
  (void)dim;
  (void)n_embed;
  long long bytes = 0;
  with_type(flat_bf16, [&](auto tv) {
    using T = decltype(tv);
    return with_kmax(k, [&](auto km) {
      constexpr int KMAX = decltype(km)::value;
      bytes = static_cast<long long>(
          lookup_smem<T, KMAX>(k, KMAX == kStaged && lists_fit<T>(k)));
      return cudaSuccess;
    });
  });
  return bytes;
}

// Dynamic shared memory one block of the statistics kernel needs at the
// least (one codeword a cluster) for this width.
long long ammc_ema_stats_smem_bytes(int flat_bf16, int dim) {
  return static_cast<long long>(stat_smem(dim, 1, flat_bf16 ? 2 : 4));
}

// Bytes of the scratch buffer the lookup takes for these sizes and grid.
long long ammc_quantize_topk_scratch_bytes(int flat_bf16, int dim, int n_embed,
                                           int k, int grid) {
  return static_cast<long long>(
      scratch_bytes(flat_bf16, dim, n_embed, k, grid));
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

// Blocks a launch of the lookup kernel (B1, and B2's lookup) takes for
// these sizes on the current device.  It also raises the lookup's and the
// statistics kernel's shared-memory limits to the card's opt-in maximum, so
// call it once per device and sizes before the first launch; the wrapper
// caches it.
int ammc_quantize_topk_grid(int flat_bf16, int n, int dim, int n_embed,
                            int k, int* grid) {
  return with_type(flat_bf16, [&](auto tv) {
    using T = decltype(tv);
    return with_kmax(k, [&](auto km) {
      return grid_size<T, decltype(km)::value>(n, dim, n_embed, k, grid);
    });
  });
}

// B1.  flat (n, dim) bf16 if flat_bf16 else f32; embed (dim, n_embed) f32;
// scratch of ammc_quantize_topk_scratch_bytes, 16-byte aligned; q_topk
// (n, k*dim) f32; q1 (n, dim) f32; idx (n,) int32.  All contiguous and on
// the current device; 1 <= k <= n_embed; n > 0; `grid` from
// ammc_quantize_topk_grid with the same sizes.
int ammc_quantize_topk(const void* flat, int flat_bf16, const void* embed,
                       void* scratch, void* q_topk, void* q1, void* idx,
                       int grid, int n, int dim, int n_embed, int k,
                       void* stream) {
  return launch_lookup(flat, flat_bf16, static_cast<const float*>(embed),
                       static_cast<unsigned char*>(scratch),
                       static_cast<float*>(q_topk), static_cast<float*>(q1),
                       static_cast<int*>(idx), grid, n, dim, n_embed, k,
                       static_cast<cudaStream_t>(stream));
}

// B2.  B1's arguments plus counts (n_embed,) f32 and embed_sum
// (dim, n_embed) f32: B1's kernels, then ema_stats_kernel; idx is read back,
// so it must be 16-byte aligned.
int ammc_quantize_topk_train(const void* flat, int flat_bf16,
                             const void* embed, void* scratch, void* q_topk,
                             void* q1, void* idx, void* counts,
                             void* embed_sum, int grid, int n, int dim,
                             int n_embed, int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_lookup(
      flat, flat_bf16, static_cast<const float*>(embed),
      static_cast<unsigned char*>(scratch), static_cast<float*>(q_topk),
      static_cast<float*>(q1), static_cast<int*>(idx), grid, n, dim, n_embed,
      k, s);
  if (err != cudaSuccess) return err;
  const StatShape sh = stat_shape(dim, n_embed, flat_bf16 ? 2 : 4);
  return with_type(flat_bf16, [&](auto tv) {
    using T = decltype(tv);
    ema_stats_kernel<T><<<sh.groups * kCluster, kStatThreads, sh.smem, s>>>(
        static_cast<const T*>(flat), static_cast<const int*>(idx),
        static_cast<float*>(counts), static_cast<float*>(embed_sum), n, dim,
        n_embed, sh.j);
    return cudaGetLastError();
  });
}

}  // extern "C"
