// Hand-written Hopper (sm_90a) bounded-range segment sum.
//
// Replaces (embeddingtables_tpu/ops/pallas/segsum.py):
//   et_hot_accumulate <- hot_accumulate: _segsum_kernel (pl.pallas_call at
//                        :135).
//   out[s, :] = sum_{j : rows[j] == s} vals[j, :]   for 0 <= s < S,
// f32 result; ids outside [0, S) are dropped. With bf16 compute each value is
// first rounded to bf16 (what the TPU kernel's bf16 one-hot matmul sees),
// then accumulated in f32; f32 compute accumulates the values as they are.
//
// The TPU kernel builds a (tile, S) one-hot matrix and multiplies it on the
// MXU, because a TPU core has no cheap per-occurrence control flow. That
// product costs 2 * n * S * D operations to add n * D values; a GPU has
// per-element atomics in shared memory, so this kernel adds each value once.
//
// What bounds it: bytes. The values are read once and the (S, D) result
// written once; the adds are far below the card's ridge point.
//
// What the design does about it:
//  - Each block owns a column slice of D (DS columns) and a contiguous range
//    of occurrences, and keeps an f32 (S, DS) accumulator in shared memory.
//    DS is the widest power of two up to 128 for which S * DS * 4 bytes fits
//    the 96 KB budget the wrapper passes (S = 512 takes DS = 32, 64 KB), so
//    two blocks fit on an SM; above 48 KB the launch raises the kernel's
//    dynamic shared memory limit.
//  - Threads take (occurrence slot, column) pairs: the lanes of a column
//    slice read neighbouring values of one occurrence (coalesced), slots
//    take successive occurrences, and shared-memory atomics combine them.
//    Each thread loads eight occurrences before it adds any, so its loop
//    is not bound by one load's latency per occurrence.
//  - At the end each block adds its nonzero partial sums into the output
//    with global atomics; the wrapper allocates the output as zeros.
//  - The atomics make the order of the f32 additions vary from run to run:
//    the result varies at the level of f32 rounding of the summed magnitude.
//
// The entry point launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int32_t* __restrict__ rows, const float* __restrict__ vals,
              float* __restrict__ out, int64_t n, int64_t d, int s, int ds,
              int64_t per_block) {
  extern __shared__ float sacc[];
  const int cells = s * ds;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sacc[i] = 0.0f;
  __syncthreads();

  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * ds;
  const int col = threadIdx.x % ds;
  const int slot = threadIdx.x / ds;
  const int slots = blockDim.x / ds;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = begin + per_block < n ? begin + per_block : n;
  // kUnroll occurrences per pass: their loads are all in flight before the
  // first atomic, so a thread does not wait out one load per occurrence.
  for (int64_t j0 = begin + slot; j0 < end; j0 += slots * kUnroll) {
    int32_t r[kUnroll];
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + static_cast<int64_t>(u) * slots;
      r[u] = -1;
      x[u] = 0.0f;
      if (j < end) {
        r[u] = rows[j];
        x[u] = vals[j * d + c0 + col];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] >= 0 && r[u] < s)
        atomicAdd(&sacc[r[u] * ds + col], kBf16 ? round_bf16(x[u]) : x[u]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float x = sacc[i];
    if (x != 0.0f) atomicAdd(&out[(i / ds) * d + c0 + (i % ds)], x);
  }
}

}  // namespace

// rows: (n,) int32; vals: (n, d) f32; out: (s, d) f32, zero on entry.
// n > 0, d % ds == 0, ds a power of two <= 128 with s * ds * 4 <= smem_bytes;
// compute: 0 = f32, 1 = bf16-rounded values; blocks_x occurrence ranges.
extern "C" int et_hot_accumulate(const void* rows, const void* vals, void* out,
                                 int64_t n, int64_t d, int s, int ds,
                                 int compute, int blocks_x, void* stream) {
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* x = static_cast<const float*>(vals);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t per_block = (n + blocks_x - 1) / blocks_x;
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(d / ds));
  const size_t smem = static_cast<size_t>(s) * ds * sizeof(float);
  cudaError_t err;
  if (compute == 1) {
    err = cudaFuncSetAttribute(segsum_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    segsum_kernel<true><<<grid, kThreads, smem, st>>>(r, x, o, n, d, s, ds,
                                                      per_block);
  } else {
    err = cudaFuncSetAttribute(segsum_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    segsum_kernel<false><<<grid, kThreads, smem, st>>>(r, x, o, n, d, s, ds,
                                                       per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
