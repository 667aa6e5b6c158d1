// Fused top-k memory lookup for Hopper (sm_90a): distance, top-k, gather.
//
// Replaces the Pallas TPU kernel `_quantize_kernel` called by
// `quantize_topk_pallas` (ammcnet_aaai2021_tpu/ops/memory_pallas.py:48-82,
// :201-255).  For each latent row z (dim values, bf16 or f32) against the
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
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes (ammcnet_aaai2021_torch/ops/memory_kernels.py).  Launches go on
// the caller's stream; every entry point returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // rows one warp scores at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

size_t smem_bytes(int dim, int n_embed) {
  return sizeof(float) * (static_cast<size_t>(kWarps) * dim * kRows  // z
                          + n_embed                                  // ||E||^2
                          + static_cast<size_t>(dim) * (n_embed + 1));  // E
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
quantize_topk_kernel(const T* __restrict__ flat,
                     const float* __restrict__ embed,
                     float* __restrict__ q_topk, float* __restrict__ q1,
                     int* __restrict__ idx, int n, int dim, int k) {
  constexpr int n_embed = CPL * 32;
  constexpr int pitch = n_embed + 1;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* zs = smem;                          // [warp][d][kRows]
  float* esq = zs + kWarps * dim * kRows;    // [n_embed]
  float* es = esq + n_embed;                 // [d][pitch]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < dim * n_embed; i += kThreads) {
    const int d = i / n_embed;
    const int j = i - d * n_embed;
    es[d * pitch + j] = embed[i];
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

  float* z = zs + warp * dim * kRows;
  const int64_t groups = (static_cast<int64_t>(n) + kRows - 1) / kRows;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       g < groups; g += step) {
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
    __syncwarp();  // z is restaged by the next group

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
        if (j == 0 && lane == 0) idx[row] = best_i;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          if (lane + 32 * c == best_i) dist[c] = __int_as_float(0x7f800000);
        }
      }
    }
  }
}

template <typename T, int CPL>
cudaError_t launch(const void* flat, const float* embed, float* q_topk,
                   float* q1, int* idx, int n, int dim, int k,
                   cudaStream_t stream) {
  auto kernel = quantize_topk_kernel<T, CPL>;
  const size_t smem = smem_bytes(dim, CPL * 32);
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
  const int64_t wanted = (groups + kWarps - 1) / kWarps;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int grid = static_cast<int>(wanted < resident ? wanted : resident);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(flat), embed,
                                           q_topk, q1, idx, n, dim, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* flat, const float* embed, float* q_topk,
                     float* q1, int* idx, int n, int dim, int n_embed, int k,
                     cudaStream_t stream) {
  switch (n_embed) {
    case 32: return launch<T, 1>(flat, embed, q_topk, q1, idx, n, dim, k, stream);
    case 64: return launch<T, 2>(flat, embed, q_topk, q1, idx, n, dim, k, stream);
    case 128: return launch<T, 4>(flat, embed, q_topk, q1, idx, n, dim, k, stream);
    case 256: return launch<T, 8>(flat, embed, q_topk, q1, idx, n, dim, k, stream);
    case 512: return launch<T, 16>(flat, embed, q_topk, q1, idx, n, dim, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a (dim, n_embed) codebook.
long long ammc_quantize_topk_smem_bytes(int dim, int n_embed) {
  return static_cast<long long>(smem_bytes(dim, n_embed));
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

// flat (n, dim) bf16 if flat_bf16 else f32; embed (dim, n_embed) f32;
// q_topk (n, k*dim) f32; q1 (n, dim) f32; idx (n,) int32.  All contiguous
// and on the current device; n_embed in {32, 64, 128, 256, 512}; n > 0.
int ammc_quantize_topk(const void* flat, int flat_bf16, const void* embed,
                       void* q_topk, void* q1, void* idx, int n, int dim,
                       int n_embed, int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto e = static_cast<const float*>(embed);
  auto qt = static_cast<float*>(q_topk);
  auto q = static_cast<float*>(q1);
  auto ix = static_cast<int*>(idx);
  if (flat_bf16) {
    return dispatch<__nv_bfloat16>(flat, e, qt, q, ix, n, dim, n_embed, k, s);
  }
  return dispatch<float>(flat, e, qt, q, ix, n, dim, n_embed, k, s);
}

}  // extern "C"
