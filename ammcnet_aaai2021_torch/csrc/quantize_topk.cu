// Fused top-k memory lookup for Hopper (sm_90a): distance, top-k, gather,
// and (training variant) the EMA codebook statistics.
//
// Kernel B1 replaces the Pallas TPU kernel `_quantize_kernel` called by
// `quantize_topk_pallas` (ammcnet_aaai2021_tpu/ops/memory_pallas.py:48-82,
// :201-255); kernel B2 (the same kernel with kStats = true, plus a reduction
// pass) replaces `_quantize_train_kernel` called by
// `quantize_topk_pallas_train` (memory_pallas.py:84-135, :137-198).
//
// For each latent row z (dim values, bf16 or f32) against the
// codebook E (dim, n_embed) f32 it computes the ranking distance
//     dist[j] = -2 * z.E[:, j] + ||E[:, j]||^2      (fp32; ||z||^2 dropped)
// takes k rounds of "row minimum, lowest index on ties, mask the winner",
// and writes the chosen codewords: q_topk (N, k*dim) f32, q1 (N, dim) f32
// (the top-1 codeword) and idx (N,) int32 (the top-1 index).
//
// What bounds it on this card.  At the main path's shape (N = 196,608,
// dim 64, n_embed 256, k 2) the distances are 2*N*dim*n_embed = 6.4 GFLOP
// of fp32 FMA outside the tensor cores (67 TFLOP/s: about 0.1 ms), against
// about 177 MB of compulsory traffic (bf16 rows in, f32 codewords out:
// about 0.05 ms at 3.35 TB/s).  So the FMA issue rate is the bound, and the
// risk is that shared-memory loads, not FMAs, set the pace.
//
// What the design does about that.
//  * The whole codebook lives in dynamic shared memory (64 KiB at
//    n_embed 256, 128 KiB at 512), loaded once per block; blocks are
//    persistent (one wave, sized by the occupancy calculator) and walk over
//    row groups, so the codebook crosses L2 once per block, not per row.
//  * The codebook is stored as es[d][j] with a row pitch of n_embed + 1:
//    lanes reading consecutive codewords j at one d hit consecutive banks
//    (the distance loop), and lanes reading consecutive d of one codeword
//    hit distinct banks too (the gather), so neither access conflicts.
//  * One warp scores kRows = 4 rows at once: lane l owns codewords
//    l, l+32, ... (n_embed/32 of them).  Each step of the dim loop is one
//    broadcast float4 load of the 4 rows' z[d], n_embed/32 codebook loads,
//    and 4 * n_embed/32 FMAs, so each shared load feeds about 3.5 FMAs.
//  * Top-k is a per-lane scan (strict <, so the lowest index wins among a
//    lane's own codewords) and a 5-step xor-shuffle reduction on
//    (distance, index) that keeps the lower index on equal distances, the
//    tie-break of the TPU kernel (memory_pallas.py:64-72).  The winner is
//    masked with +inf by the lane that owns it.
//  * The gather is a direct row copy out of shared memory: lanes write
//    consecutive d, so each store is coalesced.  (The TPU kernel used a
//    one-hot matmul on its matrix unit instead of a dynamic gather.)
//  * A ragged N is masked: rows past N are staged as zeros and not written.
//    The TPU version zero-padded N to a multiple of its tile instead.
//
// B2, the training variant, also returns the EMA statistics of the top-1
// picks: counts (n_embed,) = sum of one-hot(top-1) and embed_sum
// (dim, n_embed) = flat^T . one-hot(top-1), both f32.  The TPU kernel summed
// them across its sequential grid into revisited output blocks.
//
// What bounds B2.  At the training path's shape (N = 4 * 32 * 32 = 4,096,
// dim 64, n_embed 256, k 2) the distances are 134 MFLOP (2.0 us at
// 67 TFLOP/s) and the compulsory bytes about 3.8 MB (1.1 us at 3.35 TB/s):
// a few microseconds of work, so launch latency and the number of blocks
// set the time.  At B1's N = 196,608 it is FMA-bound like B1.
//
// What the design does about it.
//  * GPU blocks run in parallel and in no order, so each block keeps one
//    partial counts / embed_sum in shared memory and writes it to its own
//    slice of a workspace; a second small kernel adds the partials up in
//    block order.  No float atomics: two calls on the same input give
//    bitwise equal statistics, as the TPU kernel's sequential sum does.
//  * Inside a block, warps score row groups as in B1, the block then
//    synchronises, and each entry (d, j) of the partial embed_sum is owned
//    by one thread, which adds the tile's rows into it in row order.  Counts
//    are integers (shared-memory integer atomics: exact in any order).
//  * The partial (dim x n_embed f32) sits beside the codebook in shared
//    memory: 138.6 KiB at dim 64, n_embed 256, which leaves one block per
//    SM.  At n_embed 512 it would not fit; the wrapper raises for that size.
//  * Rows >= N add nothing: no padding, so no count correction.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes (ammcnet_aaai2021_torch/ops/memory_kernels.py).  Launches go on
// the caller's stream; every entry point returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // rows one warp scores at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

size_t smem_bytes(int dim, int n_embed, bool stats) {
  size_t words = static_cast<size_t>(kWarps) * dim * kRows  // z
                 + n_embed                                  // ||E||^2
                 + static_cast<size_t>(dim) * (n_embed + 1);  // E
  if (stats) {
    words += static_cast<size_t>(dim) * (n_embed + 1)  // partial embed_sum
             + n_embed                                 // partial counts
             + kWarps * kRows;                         // the tile's top-1
  }
  return sizeof(float) * words;
}

template <typename T, int CPL, bool kStats>
__global__ void __launch_bounds__(kThreads)
quantize_topk_kernel(const T* __restrict__ flat,
                     const float* __restrict__ embed,
                     float* __restrict__ q_topk, float* __restrict__ q1,
                     int* __restrict__ idx, float* __restrict__ part_sum,
                     int* __restrict__ part_counts, int n, int dim, int k) {
  constexpr int n_embed = CPL * 32;
  constexpr int pitch = n_embed + 1;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* zs = smem;                          // [warp][d][kRows]
  float* esq = zs + kWarps * dim * kRows;    // [n_embed]
  float* es = esq + n_embed;                 // [d][pitch]
  // kStats only: the block's partial statistics and the tile's top-1 picks
  float* psum = es + dim * pitch;                          // [d][pitch]
  int* pcount = reinterpret_cast<int*>(psum + dim * pitch);  // [n_embed]
  int* tile_idx = pcount + n_embed;                        // [kWarps*kRows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < dim * n_embed; i += kThreads) {
    const int d = i / n_embed;
    const int j = i - d * n_embed;
    es[d * pitch + j] = embed[i];
  }
  if constexpr (kStats) {
    for (int i = tid; i < dim * pitch; i += kThreads) psum[i] = 0.f;
    for (int j = tid; j < n_embed; j += kThreads) pcount[j] = 0;
  }
  __syncthreads();
  for (int j = tid; j < n_embed; j += kThreads) {
    float s = 0.f;
    for (int d = 0; d < dim; ++d) {
      const float e = es[d * pitch + j];
      s = fmaf(e, e, s);
    }
    esq[j] = s;
  }
  __syncthreads();

  // A tile is kWarps row groups of kRows rows; warp w scores group
  // tile * kWarps + w.  Blocks are persistent and walk over tiles.
  float* z = zs + warp * dim * kRows;
  const int64_t groups = (static_cast<int64_t>(n) + kRows - 1) / kRows;
  const int64_t tiles = (groups + kWarps - 1) / kWarps;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t g = tile * kWarps + warp;
    if (kStats && lane < kRows) tile_idx[warp * kRows + lane] = -1;
    if (g < groups) {  // warp-uniform
      const int64_t row0 = g * kRows;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int64_t row = row0 + r;
        for (int d = lane; d < dim; d += 32) {
          z[d * kRows + r] = row < n ? to_f32(flat[row * dim + d]) : 0.f;
        }
      }
      __syncwarp();

      float acc[kRows][CPL];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
      }
      for (int d = 0; d < dim; ++d) {
        const float4 zv = *reinterpret_cast<const float4*>(z + d * kRows);
        const float* erow = es + d * pitch + lane;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const float e = erow[c * 32];
          acc[0][c] = fmaf(zv.x, e, acc[0][c]);
          acc[1][c] = fmaf(zv.y, e, acc[1][c]);
          acc[2][c] = fmaf(zv.z, e, acc[2][c]);
          acc[3][c] = fmaf(zv.w, e, acc[3][c]);
        }
      }
      __syncwarp();  // z is restaged by the next group (B1)

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int64_t row = row0 + r;
        if (row >= n) continue;  // warp-uniform
        float dist[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          dist[c] = fmaf(-2.f, acc[r][c], esq[lane + 32 * c]);
        }
        float* out = q_topk + row * k * dim;
        for (int j = 0; j < k; ++j) {
          float best = dist[0];
          int best_i = lane;
#pragma unroll
          for (int c = 1; c < CPL; ++c) {
            if (dist[c] < best) {
              best = dist[c];
              best_i = lane + 32 * c;
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float o = __shfl_xor_sync(0xffffffffu, best, off);
            const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
            if (o < best || (o == best && oi < best_i)) {
              best = o;
              best_i = oi;
            }
          }
          for (int d = lane; d < dim; d += 32) {
            const float v = es[d * pitch + best_i];
            out[j * dim + d] = v;
            if (j == 0) q1[row * dim + d] = v;
          }
          if (j == 0 && lane == 0) {
            idx[row] = best_i;
            if (kStats) tile_idx[warp * kRows + r] = best_i;
          }
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            if (lane + 32 * c == best_i) dist[c] = __int_as_float(0x7f800000);
          }
        }
      }
    }

    if constexpr (kStats) {
      // every warp's z and top-1 picks of this tile are staged
      __syncthreads();
      if (tid < kWarps * kRows && tile_idx[tid] >= 0) {
        atomicAdd(&pcount[tile_idx[tid]], 1);  // integer: exact in any order
      }
      // entry (d, j) belongs to thread (j % owners) * dim + d, which adds the
      // tile's rows into it in row order
      const int owners = dim < kThreads ? kThreads / dim : 1;
      for (int s = tid; s < dim * owners; s += kThreads) {
        const int d = s % dim;
        const int q = s / dim;
        float* col = psum + d * pitch;
        for (int rr = 0; rr < kWarps * kRows; ++rr) {
          const int j = tile_idx[rr];
          if (j >= 0 && j % owners == q) {
            col[j] += zs[((rr / kRows) * dim + d) * kRows + rr % kRows];
          }
        }
      }
      __syncthreads();  // before the next tile restages z and tile_idx
    }
  }

  if constexpr (kStats) {
    float* my_sum = part_sum + static_cast<int64_t>(blockIdx.x) * dim * n_embed;
    for (int i = tid; i < dim * n_embed; i += kThreads) {
      const int d = i / n_embed;
      my_sum[i] = psum[d * pitch + (i - d * n_embed)];
    }
    int* my_count = part_counts + static_cast<int64_t>(blockIdx.x) * n_embed;
    for (int j = tid; j < n_embed; j += kThreads) my_count[j] = pcount[j];
  }
}

// B2's second pass: embed_sum and counts are the block partials added up in
// block order, one thread per output entry (a fixed order: deterministic).
__global__ void reduce_stats_kernel(const float* __restrict__ part_sum,
                                    const int* __restrict__ part_counts,
                                    float* __restrict__ embed_sum,
                                    float* __restrict__ counts, int blocks,
                                    int sum_size, int n_embed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < sum_size) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) {
      s += part_sum[static_cast<int64_t>(b) * sum_size + i];
    }
    embed_sum[i] = s;
  } else if (i < sum_size + n_embed) {
    const int j = i - sum_size;
    int c = 0;
    for (int b = 0; b < blocks; ++b) {
      c += part_counts[static_cast<int64_t>(b) * n_embed + j];
    }
    counts[j] = static_cast<float>(c);
  }
}

// Blocks a launch uses: one wave of persistent blocks (the occupancy
// calculator's count per SM times the SMs), or fewer when N is small.
template <typename T, int CPL, bool kStats>
cudaError_t grid_size(int n, int dim, int* grid) {
  auto kernel = quantize_topk_kernel<T, CPL, kStats>;
  const size_t smem = smem_bytes(dim, CPL * 32, kStats);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
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

template <typename T, int CPL, bool kStats>
cudaError_t launch(const void* flat, const float* embed, float* q_topk,
                   float* q1, int* idx, float* part_sum, int* part_counts,
                   int grid, int n, int dim, int k, cudaStream_t stream) {
  const size_t smem = smem_bytes(dim, CPL * 32, kStats);
  quantize_topk_kernel<T, CPL, kStats><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(flat), embed, q_topk, q1, idx, part_sum,
      part_counts, n, dim, k);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, n_embed / 32>) for the codebook sizes
// the kernel is instantiated for.
template <typename F>
cudaError_t with_cpl(int n_embed, F&& f) {
  switch (n_embed) {
    case 32: return f(std::integral_constant<int, 1>{});
    case 64: return f(std::integral_constant<int, 2>{});
    case 128: return f(std::integral_constant<int, 4>{});
    case 256: return f(std::integral_constant<int, 8>{});
    case 512: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_type(int flat_bf16, F&& f) {
  if (flat_bf16) return f(__nv_bfloat16{});
  return f(float{});
}

}  // namespace

extern "C" {

// Shared memory one block needs for a (dim, n_embed) codebook; stats != 0
// for the training variant (B2).
long long ammc_quantize_topk_smem_bytes(int dim, int n_embed, int stats) {
  return static_cast<long long>(smem_bytes(dim, n_embed, stats != 0));
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

// Blocks a launch of B1 (stats == 0) or B2 (stats != 0) takes for these
// sizes on the current device.  It also raises the kernel's shared-memory
// limit to what the codebook needs, so call it once per device and sizes
// before the first launch; the wrappers cache it.  B2's workspace holds
// `grid` partials (grid * dim * n_embed f32 and grid * n_embed int32).
int ammc_quantize_topk_grid(int flat_bf16, int n, int dim, int n_embed,
                            int stats, int* grid) {
  return with_type(flat_bf16, [&](auto t) {
    using T = decltype(t);
    return with_cpl(n_embed, [&](auto cpl) {
      constexpr int CPL = decltype(cpl)::value;
      return stats ? grid_size<T, CPL, true>(n, dim, grid)
                   : grid_size<T, CPL, false>(n, dim, grid);
    });
  });
}

// B1.  flat (n, dim) bf16 if flat_bf16 else f32; embed (dim, n_embed) f32;
// q_topk (n, k*dim) f32; q1 (n, dim) f32; idx (n,) int32.  All contiguous
// and on the current device; n_embed in {32, 64, 128, 256, 512}; n > 0;
// `grid` from ammc_quantize_topk_grid(..., stats = 0) with the same sizes.
int ammc_quantize_topk(const void* flat, int flat_bf16, const void* embed,
                       void* q_topk, void* q1, void* idx, int grid, int n,
                       int dim, int n_embed, int k, void* stream) {
  return with_type(flat_bf16, [&](auto t) {
    using T = decltype(t);
    return with_cpl(n_embed, [&](auto cpl) {
      return launch<T, decltype(cpl)::value, false>(
          flat, static_cast<const float*>(embed), static_cast<float*>(q_topk),
          static_cast<float*>(q1), static_cast<int*>(idx), nullptr, nullptr,
          grid, n, dim, k, static_cast<cudaStream_t>(stream));
    });
  });
}

// B2.  B1's arguments plus counts (n_embed,) f32, embed_sum (dim, n_embed)
// f32, and the workspace part_sum / part_counts for `grid` blocks (from
// ammc_quantize_topk_grid(..., stats = 1) with the same sizes).
int ammc_quantize_topk_train(const void* flat, int flat_bf16,
                             const void* embed, void* q_topk, void* q1,
                             void* idx, void* counts, void* embed_sum,
                             void* part_sum, void* part_counts, int grid,
                             int n, int dim, int n_embed, int k,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_type(flat_bf16, [&](auto t) {
    using T = decltype(t);
    return with_cpl(n_embed, [&](auto cpl) {
      return launch<T, decltype(cpl)::value, true>(
          flat, static_cast<const float*>(embed), static_cast<float*>(q_topk),
          static_cast<float*>(q1), static_cast<int*>(idx),
          static_cast<float*>(part_sum), static_cast<int*>(part_counts), grid,
          n, dim, k, s);
    });
  });
  if (err != cudaSuccess) return err;
  const int sum_size = dim * n_embed;
  const int threads = 256;
  const int blocks = (sum_size + n_embed + threads - 1) / threads;
  reduce_stats_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const float*>(part_sum),
      static_cast<const int*>(part_counts), static_cast<float*>(embed_sum),
      static_cast<float*>(counts), grid, sum_size, n_embed);
  return cudaGetLastError();
}

}  // extern "C"
