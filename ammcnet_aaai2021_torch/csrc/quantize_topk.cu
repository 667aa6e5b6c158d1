// Fused top-k memory lookup for Hopper (sm_90a) on the CUDA cores: distance,
// top-k, gather, and (training variant) the EMA codebook statistics.  The
// route for every input the tensor-core kernels (quantize_topk_mma.cu) do not
// take: float32 latents, other latent widths, k > 4, any codebook size.
//
// Kernel B1 replaces the Pallas TPU kernel `_quantize_kernel` called by
// `quantize_topk_pallas` (ammcnet_aaai2021_tpu/ops/memory_pallas.py:48-82,
// :201-255); kernel B2 (B1's kernel, then `ema_stats_kernel`) replaces
// `_quantize_train_kernel` called by `quantize_topk_pallas_train`
// (memory_pallas.py:84-135, :137-198).  Like the TPU kernels they take any
// n_embed and any 1 <= k <= n_embed; the limit is shared memory
// (`smem_bytes`): a width whose staged rows fit, and for k > kMaxK the
// block's 32 rows of n_embed staged distances beside them (n_embed up to
// about 1,490 at width 64).
//
// For each latent row z (dim values, bf16 or f32) against the
// codebook E (dim, n_embed) f32 it computes the ranking distance
//     dist[j] = -2 * z.E[:, j] + ||E[:, j]||^2      (fp32; ||z||^2 dropped)
// takes k rounds of "row minimum, lowest index on ties, mask the winner",
// and writes the chosen codewords: q_topk (N, k*dim) f32, q1 (N, dim) f32
// (the top-1 codeword) and idx (N,) int32 (the top-1 index).
//
// What bounds it on this card.  At N = 196,608, dim 64, n_embed 256, k 2
// the distances are 2*N*dim*n_embed = 6.4 GFLOP of fp32 FMA outside the
// tensor cores (67 TFLOP/s: about 0.1 ms), against about 177 MB of
// compulsory traffic (about 0.05 ms at 3.35 TB/s): the FMA issue rate, and
// the shared-memory loads that feed it.
//
// What the design does about that, for any codebook size.
//  * A prologue kernel (`prep_codebook_kernel`) writes ||E_j||^2 and a
//    codeword-major copy of E into a scratch buffer the wrapper allocates.
//  * The codebook streams through shared memory in chunks of kChunk = 128
//    codewords by kSlice = 64 latent dims (33 KiB whatever n_embed and dim),
//    beside the block's staged rows; the last chunk is ragged and its
//    missing codewords are never ranked.  So several blocks fit an SM, and
//    any n_embed runs; the price is that each tile of 32 rows streams the
//    whole codebook from L2 (n_embed * dim * 4 bytes a tile).
//  * A chunk is stored es[d][j] with a row pitch of kChunk + 1: lanes
//    reading consecutive codewords at one d hit consecutive banks, and the
//    staging stores (consecutive j at one d) do too.
//  * One warp scores kRows = 4 rows at once: lane l owns codewords l, l+32,
//    l+64, l+96 of each chunk; each step of the dim loop is one broadcast
//    float4 load of the 4 rows' z[d], 4 codebook loads and 16 FMAs.  The
//    dot products are sequential fmaf over d ascending, and ||E||^2 too, as
//    in the kernel this one replaced, so the distances are bitwise its.
//  * Each lane keeps, per row, its own running top-KMAX (distance, index)
//    list in registers across chunks (KMAX in {2, 4, 8}, the smallest that
//    holds k), sorted, lower index first on equal distances.  At the end
//    k rounds of a 5-step xor-shuffle reduction on (distance, index) pick
//    the row's winner, lowest index on ties (the TPU kernel's tie-break,
//    memory_pallas.py:64-72), and the lane that owns it drops it.
//  * For k > kMaxK (KMAX = kStaged) the lists would spill: 32 floats and
//    32 indices a lane per row.  That instantiation instead stages each
//    row's n_embed distances in shared memory (the same fmaf order, so the
//    same distances and top-1) and takes the TPU kernel's own k rounds
//    (memory_pallas.py:62-81): a warp-wide (minimum, lowest index) over the
//    row, the winner masked as NaN (a real NaN distance ranks as +inf).
//  * The gather reads the k winners from the codeword-major copy (L2):
//    lanes read and write consecutive d, so both are coalesced.
//  * A ragged N is masked: rows past N are staged as zeros and not written.
//
// B2, the training variant, also returns the EMA statistics of the top-1
// picks: counts (n_embed,) = sum of one-hot(top-1) and embed_sum
// (dim, n_embed) = flat^T . one-hot(top-1), both f32.  The TPU kernel summed
// them across its sequential grid into revisited output blocks.
//
// `ema_stats_kernel` (after B1's kernel on the same stream): each (codeword,
// 128-dim slice) has one owner block, and each (codeword, d) entry one owner
// thread.  The block scans idx in chunks of 1,024 rows, lists the chunk's
// rows of its codeword in row order (warp ballots), and each owner adds
// those rows into a chunk partial, then the partial into its total: a fixed
// order, so two calls give bitwise equal statistics, with no float atomics
// and no workspace.  Counts are the lists' lengths (exact).  Every block
// reads all of idx (N * 4 bytes from L2), and a codeword picked by many rows
// is summed by one block: simple, not fast; this route serves float32
// latents and odd shapes, not the released bf16 path.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes (ammcnet_aaai2021_torch/ops/memory_kernels.py).  Launches go on
// the caller's stream; every entry point returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                 // rows one warp scores at once
constexpr int kChunk = 128;              // codewords a staged chunk holds
constexpr int kPerLane = kChunk / 32;    // of them, each lane's
constexpr int kSlice = 64;               // latent dims a staged chunk holds
constexpr int kPitch = kChunk + 1;
constexpr int kMaxK = 8;  // the longest per-lane top-k list
constexpr int kStaged = 0;  // KMAX of the instantiation that stages distances
constexpr int kStatThreads = 128;        // ema_stats_kernel: 4 warps
constexpr int kStatRowsPerWarp = 256;    // rows a warp scans per chunk
constexpr int kStatRows = 4 * kStatRowsPerWarp;
constexpr int kStatLoads = 32;           // a thread's row loads in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Dynamic shared memory of one block: the codebook chunk, the staged rows
// and, for k > kMaxK, the rows' staged distances.
size_t smem_bytes(int dim, int n_embed, int k) {
  const size_t dists = k > kMaxK ? static_cast<size_t>(kWarps) * kRows * n_embed
                                 : 0;
  return sizeof(float) * (static_cast<size_t>(kSlice) * kPitch  // chunk
                          + static_cast<size_t>(kWarps) * dim * kRows  // z
                          + dists);
}

// ||E_j||^2 (sequential fmaf over d) and the codeword-major copy E^T.
__global__ void prep_codebook_kernel(const float* __restrict__ embed,
                                     float* __restrict__ embed_t,
                                     float* __restrict__ esq, int dim,
                                     int n_embed) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_embed) return;
  float s = 0.f;
  for (int d = 0; d < dim; ++d) {
    const float e = embed[static_cast<int64_t>(d) * n_embed + j];
    s = fmaf(e, e, s);
    embed_t[static_cast<int64_t>(j) * dim + d] = e;
  }
  esq[j] = s;
}

// (d, j) before (bd, bi): the smaller distance, the lower index on ties.
__device__ __forceinline__ bool before(float d, int j, float bd, int bi) {
  return d < bd || (d == bd && j < bi);
}

// Insert (d, j) into a sorted top-KMAX list (all indices compile-time, so
// the list stays in registers).
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

template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads)
quantize_topk_kernel(const T* __restrict__ flat,
                     const float* __restrict__ embed,
                     const float* __restrict__ embed_t,
                     const float* __restrict__ esq,
                     float* __restrict__ q_topk, float* __restrict__ q1,
                     int* __restrict__ idx, int n, int dim, int n_embed,
                     int k) {
  // KMAX = kStaged: distances staged in shared memory, k rounds over them
  constexpr bool kStage = KMAX == kStaged;
  constexpr int kList = kStage ? 1 : KMAX;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* es = smem;                        // [kSlice][kPitch]
  float* zs = es + kSlice * kPitch;        // [warp][d][kRows]
  const float inf = __int_as_float(0x7f800000);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* z = zs + warp * dim * kRows;
  // kStage: this warp's rows' distances, [r][n_embed]
  float* dw = zs + kWarps * dim * kRows + warp * kRows * n_embed;
  const int chunks = (n_embed + kChunk - 1) / kChunk;

  // A tile is kWarps row groups of kRows rows; warp w scores group
  // tile * kWarps + w.  Blocks are persistent and walk over tiles; every
  // warp takes part in the chunk staging, active or not.
  const int64_t groups = (static_cast<int64_t>(n) + kRows - 1) / kRows;
  const int64_t tiles = (groups + kWarps - 1) / kWarps;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t g = tile * kWarps + warp;
    const bool active = g < groups;  // warp-uniform
    const int64_t row0 = g * kRows;
    if (active) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int64_t row = row0 + r;
        for (int d = lane; d < dim; d += 32) {
          z[d * kRows + r] = row < n ? to_f32(flat[row * dim + d]) : 0.f;
        }
      }
    }
    __syncwarp();

    float bd[kRows][kList];
    int bi[kRows][kList];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int i = 0; i < kList; ++i) {
        bd[r][i] = inf;
        bi[r][i] = INT_MAX;
      }
    }

    for (int c = 0; c < chunks; ++c) {
      const int j0 = c * kChunk;
      float acc[kRows][kPerLane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int p = 0; p < kPerLane; ++p) acc[r][p] = 0.f;
      }
      for (int d0 = 0; d0 < dim; d0 += kSlice) {
        const int ds = min(kSlice, dim - d0);
        __syncthreads();  // every warp is done with the previous slice
        for (int i = tid; i < ds * kChunk; i += kThreads) {
          const int dd = i / kChunk;
          const int jj = i - dd * kChunk;
          const int j = j0 + jj;
          es[dd * kPitch + jj] =
              j < n_embed ? embed[static_cast<int64_t>(d0 + dd) * n_embed + j]
                          : 0.f;
        }
        __syncthreads();
        if (active) {
          for (int dd = 0; dd < ds; ++dd) {
            const float4 zv =
                *reinterpret_cast<const float4*>(z + (d0 + dd) * kRows);
            const float* erow = es + dd * kPitch + lane;
#pragma unroll
            for (int p = 0; p < kPerLane; ++p) {
              const float e = erow[p * 32];
              acc[0][p] = fmaf(zv.x, e, acc[0][p]);
              acc[1][p] = fmaf(zv.y, e, acc[1][p]);
              acc[2][p] = fmaf(zv.z, e, acc[2][p]);
              acc[3][p] = fmaf(zv.w, e, acc[3][p]);
            }
          }
        }
      }
      if (active) {
#pragma unroll
        for (int p = 0; p < kPerLane; ++p) {
          const int j = j0 + lane + 32 * p;
          if (j < n_embed) {  // the ragged last chunk's gap is never ranked
            const float e2 = esq[j];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float dist = fmaf(-2.f, acc[r][p], e2);
              dist = dist == dist ? dist : inf;  // NaN ranks last
              if constexpr (kStage) {
                dw[r * n_embed + j] = dist;
              } else {
                insert<KMAX>(bd[r], bi[r], dist, j);
              }
            }
          }
        }
      }
    }

    if constexpr (kStage) __syncwarp();  // every lane's distances staged
    if (active) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int64_t row = row0 + r;
        if (row < n) {  // warp-uniform
          float* out = q_topk + row * k * dim;
          float* drow = dw + r * n_embed;
          for (int j = 0; j < k; ++j) {
            float best = bd[r][0];
            int best_i = bi[r][0];
            if constexpr (kStage) {
              // this lane's codewords lane, lane + 32, ...: the first
              // minimum not yet taken (NaN marks a taken one)
              best = inf;
              best_i = INT_MAX;
              for (int c = lane; c < n_embed; c += 32) {
                const float d = drow[c];
                if (d == d && before(d, c, best, best_i)) {
                  best = d;
                  best_i = c;
                }
              }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              const float o = __shfl_xor_sync(0xffffffffu, best, off);
              const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
              if (before(o, oi, best, best_i)) {
                best = o;
                best_i = oi;
              }
            }
            const float* word = embed_t + static_cast<int64_t>(best_i) * dim;
            for (int d = lane; d < dim; d += 32) {
              const float v = word[d];
              out[j * dim + d] = v;
              if (j == 0) q1[row * dim + d] = v;
            }
            if (j == 0 && lane == 0) idx[row] = best_i;
            if constexpr (kStage) {
              // the owner masks its winner before the next round's scan
              if ((best_i & 31) == lane) drow[best_i] = __int_as_float(0x7fffffff);
              __syncwarp();
            } else if (bi[r][0] == best_i) {  // the owner drops its winner
#pragma unroll
              for (int i = 0; i + 1 < KMAX; ++i) {
                bd[r][i] = bd[r][i + 1];
                bi[r][i] = bi[r][i + 1];
              }
              bd[r][KMAX - 1] = inf;
              bi[r][KMAX - 1] = INT_MAX;
            }
          }
        }
      }
    }
  }
}

// B2's statistics: block (j, s) owns codeword j's entries d in
// [s * kStatThreads, (s + 1) * kStatThreads); thread t owns one of them.
template <typename T>
__global__ void __launch_bounds__(kStatThreads)
ema_stats_kernel(const T* __restrict__ flat, const int* __restrict__ idx,
                 float* __restrict__ counts, float* __restrict__ embed_sum,
                 int n, int dim, int n_embed) {
  __shared__ int rows[kStatRows];  // warp w's list at w * kStatRowsPerWarp
  __shared__ int listed[4];
  const int j = blockIdx.x;
  const int d = blockIdx.y * kStatThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float total = 0.f;
  int count = 0;
  for (int64_t base = 0; base < n; base += kStatRows) {
    // warp w lists its 256 rows of the chunk that picked j, in row order
    const int64_t first = base + warp * kStatRowsPerWarp + lane;
    int picked[kStatRowsPerWarp / 32];
#pragma unroll
    for (int s = 0; s < kStatRowsPerWarp / 32; ++s) {
      const int64_t r = first + 32 * s;
      picked[s] = r < n ? idx[r] : -1;
    }
    int* list = rows + warp * kStatRowsPerWarp;
    int found = 0;
#pragma unroll
    for (int s = 0; s < kStatRowsPerWarp / 32; ++s) {
      const bool hit = picked[s] == j;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        list[found + __popc(mask & ((1u << lane) - 1u))] =
            static_cast<int>(first + 32 * s);
      }
      found += __popc(mask);
    }
    if (lane == 0) listed[warp] = found;
    __syncthreads();
    if (d < dim) {
      float part = 0.f;  // this chunk's rows, in row order
      for (int w = 0; w < 4; ++w) {
        const int* lw = rows + w * kStatRowsPerWarp;
        const int m = listed[w];
        int i = 0;
        for (; i + kStatLoads <= m; i += kStatLoads) {
          float v[kStatLoads];  // loads in flight before the in-order adds
#pragma unroll
          for (int u = 0; u < kStatLoads; ++u) {
            v[u] = to_f32(flat[static_cast<int64_t>(lw[i + u]) * dim + d]);
          }
#pragma unroll
          for (int u = 0; u < kStatLoads; ++u) part += v[u];
        }
        for (; i < m; ++i) {
          part += to_f32(flat[static_cast<int64_t>(lw[i]) * dim + d]);
        }
      }
      total += part;
    }
    count += listed[0] + listed[1] + listed[2] + listed[3];
    __syncthreads();  // before the next chunk overwrites the lists
  }
  if (d < dim) embed_sum[static_cast<int64_t>(d) * n_embed + j] = total;
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    counts[j] = static_cast<float>(count);
  }
}

// Blocks a launch uses: one wave of persistent blocks (the occupancy
// calculator's count per SM times the SMs), or fewer when N is small.
template <typename T, int KMAX>
cudaError_t grid_size(int n, int dim, int n_embed, int k, int* grid) {
  auto kernel = quantize_topk_kernel<T, KMAX>;
  const size_t smem = smem_bytes(dim, n_embed, k);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // the opt-in maximum, not this width's need: one instantiation serves
  // every width, and a later call for a narrower one must not lower it
  if ((err = cudaDeviceGetAttribute(&optin,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
          cudaSuccess) {
    return err;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t groups = (static_cast<int64_t>(n) + kRows - 1) / kRows;
  const int64_t tiles = (groups + kWarps - 1) / kWarps;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  *grid = static_cast<int>(tiles < resident ? tiles : resident);
  return cudaSuccess;
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
  return f(KMax<kStaged>{});
}

template <typename F>
cudaError_t with_type(int flat_bf16, F&& f) {
  if (flat_bf16) return f(__nv_bfloat16{});
  return f(float{});
}

template <typename T, int KMAX>
cudaError_t launch(const void* flat, const float* embed, const float* embed_t,
                   const float* esq, float* q_topk, float* q1, int* idx,
                   int grid, int n, int dim, int n_embed, int k,
                   cudaStream_t stream) {
  quantize_topk_kernel<T, KMAX>
      <<<grid, kThreads, smem_bytes(dim, n_embed, k), stream>>>(
      static_cast<const T*>(flat), embed, embed_t, esq, q_topk, q1, idx, n,
      dim, n_embed, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stats(const void* flat, const int* idx, float* counts,
                         float* embed_sum, int n, int dim, int n_embed,
                         cudaStream_t stream) {
  const dim3 blocks(n_embed, (dim + kStatThreads - 1) / kStatThreads);
  ema_stats_kernel<T><<<blocks, kStatThreads, 0, stream>>>(
      static_cast<const T*>(flat), idx, counts, embed_sum, n, dim, n_embed);
  return cudaGetLastError();
}

// The prologue, then B1's kernel.  scratch holds n_embed * (dim + 1) f32.
cudaError_t launch_lookup(const void* flat, int flat_bf16, const float* embed,
                          float* scratch, float* q_topk, float* q1, int* idx,
                          int grid, int n, int dim, int n_embed, int k,
                          cudaStream_t stream) {
  float* embed_t = scratch;
  float* esq = scratch + static_cast<int64_t>(n_embed) * dim;
  prep_codebook_kernel<<<(n_embed + 127) / 128, 128, 0, stream>>>(
      embed, embed_t, esq, dim, n_embed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return with_type(flat_bf16, [&](auto t) {
    using T = decltype(t);
    return with_kmax(k, [&](auto km) {
      return launch<T, decltype(km)::value>(flat, embed, embed_t, esq, q_topk,
                                            q1, idx, grid, n, dim, n_embed, k,
                                            stream);
    });
  });
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the lookup kernel needs for these
// sizes (for k <= 8 it depends on the latent width only).
long long ammc_quantize_topk_smem_bytes(int dim, int n_embed, int k) {
  return static_cast<long long>(smem_bytes(dim, n_embed, k));
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
// these sizes on the current device.  It also raises the kernel's
// shared-memory limit to the card's opt-in maximum, so call it once per
// device and sizes before the first launch; the wrapper caches it.
int ammc_quantize_topk_grid(int flat_bf16, int n, int dim, int n_embed,
                            int k, int* grid) {
  return with_type(flat_bf16, [&](auto t) {
    using T = decltype(t);
    return with_kmax(k, [&](auto km) {
      return grid_size<T, decltype(km)::value>(n, dim, n_embed, k, grid);
    });
  });
}

// B1.  flat (n, dim) bf16 if flat_bf16 else f32; embed (dim, n_embed) f32;
// scratch n_embed * (dim + 1) f32; q_topk (n, k*dim) f32; q1 (n, dim) f32;
// idx (n,) int32.  All contiguous and on the current device; 1 <= k <=
// n_embed; n > 0; `grid` from ammc_quantize_topk_grid with the
// same sizes.
int ammc_quantize_topk(const void* flat, int flat_bf16, const void* embed,
                       void* scratch, void* q_topk, void* q1, void* idx,
                       int grid, int n, int dim, int n_embed, int k,
                       void* stream) {
  return launch_lookup(flat, flat_bf16, static_cast<const float*>(embed),
                       static_cast<float*>(scratch),
                       static_cast<float*>(q_topk), static_cast<float*>(q1),
                       static_cast<int*>(idx), grid, n, dim, n_embed, k,
                       static_cast<cudaStream_t>(stream));
}

// B2.  B1's arguments plus counts (n_embed,) f32 and embed_sum
// (dim, n_embed) f32: B1's kernels, then ema_stats_kernel.
int ammc_quantize_topk_train(const void* flat, int flat_bf16,
                             const void* embed, void* scratch, void* q_topk,
                             void* q1, void* idx, void* counts,
                             void* embed_sum, int grid, int n, int dim,
                             int n_embed, int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_lookup(
      flat, flat_bf16, static_cast<const float*>(embed),
      static_cast<float*>(scratch), static_cast<float*>(q_topk),
      static_cast<float*>(q1), static_cast<int*>(idx), grid, n, dim, n_embed,
      k, s);
  if (err != cudaSuccess) return err;
  return with_type(flat_bf16, [&](auto t) {
    return launch_stats<decltype(t)>(
        flat, static_cast<const int*>(idx), static_cast<float*>(counts),
        static_cast<float*>(embed_sum), n, dim, n_embed, s);
  });
}

}  // extern "C"
