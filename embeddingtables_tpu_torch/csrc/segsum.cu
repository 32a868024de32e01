// Hand-written Hopper (sm_90a) bounded-range segment sum.
//
// Replaces (embeddingtables_tpu/ops/pallas/segsum.py):
//   et_hot_accumulate <- hot_accumulate (:105): _segsum_kernel (:74),
//                        pl.pallas_call at :135.
//   out[s, :] = sum_{j : rows[j] == s} vals[j, :]   for 0 <= s < S,
// f32 result; ids outside [0, S) are dropped. With bf16 compute each value is
// first rounded to bf16 (what the TPU kernel's bf16 one-hot matmul sees),
// then accumulated in f32; f32 compute accumulates the values as they are.
//
// The TPU kernel builds a (tile, S) one-hot matrix and multiplies it on the
// MXU, because a TPU core has no cheap per-occurrence control flow. That
// product costs 2 * n * S * D operations to add n * D values; a GPU adds
// each value once.
//
// What bounds it: bytes. The values are read once and the (S, D) result
// written once; the adds are far below the card's ridge point. At the
// training shape (n = 65,536, D = 128) that is 33.8 MB, 10 us at 3.35 TB/s.
// The first version reached 16 % of that: 4-byte loads, one 64 KB
// accumulator and 8 warps per SM, and a flush of every block's partial sums
// with global atomics (128 x 16K onto 16K addresses). On the card the work
// is small enough that latency chains set the time: a warp's serial walk
// (load, then shared atomics, then the next load) and the kernel's fixed
// cost (launch, zeroing, the cluster reduction, the second pass).
//
// What the design does about it:
//  - Loads of 16 bytes. A lane holds 4 consecutive columns; a group of
//    DS / 4 lanes covers one occurrence's DS-column slice (DS = 128: a warp
//    per occurrence). Each group walks a contiguous stretch of occurrences
//    kUnroll = 2 at a time and loads the next batch before it adds the
//    current one, so loads stay in flight while the atomics run: one block
//    of 1024 threads per SM keeps 1024 x 2 x 16 B = 32 KB in flight, against
//    the ~25 KB per SM that Little's law asks for (3.35 TB/s x ~1 us of
//    latency / 132 SMs). Deeper batches (4, 8) and smaller blocks (256, 512
//    threads) were slower on the card: more registers, fewer warps.
//  - A register run-combine: consecutive equal ids add up in registers;
//    only an id change sends the sum to shared memory. That eases the
//    pile-up of Zipf ids on the few rows of a tiny table.
//  - One f32 (S, DS) accumulator per block in shared memory, of which
//    exactly S * DS floats are zeroed; the wrapper takes the widest DS up to
//    128 whose accumulator fits 96 KB. Its columns are permuted (column
//    4g + k at k * DS/4 + g) so that each of a group's four atomics touches
//    consecutive words, and the groups of one warp take the four in turned
//    orders, so they hit different banks. The atomics are the compiler's
//    compare-and-swap loops, one word at a time: issuing all of a batch's
//    swaps at once was several times slower under Zipf ids, where they kept
//    losing races on the hot rows.
//  - No global atomics. Blocks form thread-block clusters of 8 along the
//    occurrences. After the walk, block rank q reads rows [qS/8, (q+1)S/8)
//    of all 8 accumulators through distributed shared memory, 16 bytes a
//    load (four words, four columns 4 apart) where DS >= 16, adds them in
//    rank order and writes them once: straight to out when one cluster
//    covers a column slice, else to a (C, S, D) f32 scratch that a second
//    kernel sums in cluster order, one float a thread. The wrapper takes C
//    from cudaOccupancyMaxActiveClusters, so every cluster runs in the first
//    wave (15 clusters of one-block-per-SM blocks on a 132-SM H100; a 16th
//    would run alone in a second wave), and keeps the scratch under 1/8 of
//    the value bytes.
//  - Determinism: the order across blocks and clusters is fixed, but shared
//    atomics from different warps of a block land in a varying order, so
//    the result still varies from run to run at f32 rounding of the summed
//    magnitude.
//
// The entry point launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bits.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;      // one block per SM
constexpr int kCluster = 8;
constexpr int kUnroll = 2;          // occurrences a group loads at once
constexpr int kMaxClusters = 32;    // the combine's unroll

__device__ __forceinline__ float4 maybe_round(float4 x, bool bf16) {
  if (bf16) {
    x.x = round_bf16(x.x);
    x.y = round_bf16(x.y);
    x.z = round_bf16(x.z);
    x.w = round_bf16(x.w);
  }
  return x;
}

__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ float component(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Ids and values of occurrences [j0, j0 + kUnroll) (id -1 past j_end).
__device__ __forceinline__ void load_batch(const int32_t* __restrict__ rows,
                                           const float* __restrict__ vals,
                                           int64_t j0, int64_t j_end,
                                           int64_t d, int64_t c0,
                                           int32_t (&id)[kUnroll],
                                           float4 (&x)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t j = j0 + u;
    id[u] = -1;
    x[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < j_end) {
      id[u] = rows[j];
      x[u] = *reinterpret_cast<const float4*>(vals + j * d + c0);
    }
  }
}

// Adds run sum v[e] to the accumulator row id[e], for each e with
// 0 <= id[e] < s, with shared-memory atomics. Lane g of a group holds
// columns 4g ... 4g + 3, stored at k * kLanes + g; `rot` (the group's place
// in its warp) turns the order of k so the groups of a warp hit different
// banks.
template <int DS, int E>
__device__ __forceinline__ void add_runs(float* sacc, const int32_t (&id)[E],
                                         const float4 (&v)[E], int s, int g,
                                         int rot) {
  constexpr int kLanes = DS / 4;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (id[e] < 0 || id[e] >= s) continue;
    float* p = sacc + id[e] * DS + g;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kk = (k + rot) & 3;
      atomicAdd(p + kk * kLanes, component(v[e], kk));
    }
  }
}

// DS: columns per block (a multiple of 4, at most 128); the block takes
// columns [blockIdx.y * DS, +DS) and the blockIdx.x-th of gridDim.x equal
// ranges of occurrences. dst: out (s, d) when gridDim.x == kCluster, else
// the (gridDim.x / kCluster, s, d) scratch.
template <int DS, bool kBf16>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, 1)
segsum_kernel(const int32_t* __restrict__ rows, const float* __restrict__ vals,
              float* __restrict__ dst, int64_t n, int64_t d, int s) {
  constexpr int kLanes = DS / 4;              // lanes per occurrence
  constexpr int kGroups = kThreads / kLanes;  // occurrences per block step
  extern __shared__ __align__(16) float sacc[];
  cg::cluster_group cluster = cg::this_cluster();

  float4* sacc4 = reinterpret_cast<float4*>(sacc);
  for (int i = threadIdx.x; i < s * DS / 4; i += kThreads)
    sacc4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  const int g = threadIdx.x % kLanes;         // lane in the group
  const int group = threadIdx.x / kLanes;
  const int rot = (threadIdx.x & 31) / kLanes;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * DS + 4 * g;
  const int64_t per_block = (n + gridDim.x - 1) / gridDim.x;
  const int64_t b0 = blockIdx.x * per_block;
  const int64_t b1 = b0 + per_block < n ? b0 + per_block : n;
  const int64_t per_group = (per_block + kGroups - 1) / kGroups;
  const int64_t j_begin = b0 + group * per_group;
  const int64_t j_end = j_begin + per_group < b1 ? j_begin + per_group : b1;

  // The group walks its stretch a batch at a time, the next batch's loads
  // in flight while this batch's sums go to shared memory. Equal
  // consecutive ids add up in registers (`run`, id `cur`); each id change
  // sends the finished run on.
  int32_t id[kUnroll];
  float4 x[kUnroll];
  load_batch(rows, vals, j_begin, j_end, d, c0, id, x);
  int32_t cur = -1;
  float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t j0 = j_begin; j0 < j_end; j0 += kUnroll) {
    int32_t next_id[kUnroll];
    float4 next_x[kUnroll];
    load_batch(rows, vals, j0 + kUnroll, j_end, d, c0, next_id, next_x);
    int32_t done_id[kUnroll];
    float4 done[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float4 y = maybe_round(x[u], kBf16);
      done_id[u] = id[u] == cur ? -1 : cur;
      done[u] = run;
      if (id[u] == cur) {
        add_to(run, y);
      } else {
        cur = id[u];
        run = y;
      }
    }
    add_runs<DS>(sacc, done_id, done, s, g, rot);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      id[u] = next_id[u];
      x[u] = next_x[u];
    }
  }
  {
    const int32_t last_id[1] = {cur};
    const float4 last[1] = {run};
    add_runs<DS>(sacc, last_id, last, s, g, rot);
  }

  // Every block of the cluster has finished its atomics (release/acquire).
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  const int rows_per_rank = s / kCluster;
  float* out = dst + static_cast<int64_t>(blockIdx.x / kCluster) * s * d +
               static_cast<int64_t>(blockIdx.y) * DS;
  if constexpr (kLanes % 4 == 0) {
    // Four consecutive words a thread: word k * kLanes + g holds column
    // 4g + k, so words w ... w + 3 hold columns 4g + k, 4g + 4 + k, ...
    for (int i = threadIdx.x; i < rows_per_rank * DS / 4; i += kThreads) {
      const int row = rank * rows_per_rank + i / (DS / 4);
      const int w = 4 * (i % (DS / 4));
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        add_to(sum, *reinterpret_cast<const float4*>(
                        cluster.map_shared_rank(sacc, r) + row * DS + w));
      float* o = out + static_cast<int64_t>(row) * d + 4 * (w % kLanes) +
                 w / kLanes;
      o[0] = sum.x;
      o[4] = sum.y;
      o[8] = sum.z;
      o[12] = sum.w;
    }
  } else {
    for (int i = threadIdx.x; i < rows_per_rank * kLanes; i += kThreads) {
      const int row = rank * rows_per_rank + i / kLanes;
      const int gg = i % kLanes;
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const float* src = cluster.map_shared_rank(sacc, r) + row * DS + gg;
        sum.x += src[0];
        sum.y += src[kLanes];
        sum.z += src[2 * kLanes];
        sum.w += src[3 * kLanes];
      }
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * d +
                                 4 * gg) = sum;
    }
  }
  // No block may exit while another still reads its shared memory.
  cluster.sync();
}

// out[i] = sum over c in order of scratch[c][i], over s * d floats, one a
// thread so that the partials' few megabytes spread over the whole card;
// every partial is loaded before the first add.
constexpr int kCombineThreads = 128;
__global__ void __launch_bounds__(kCombineThreads)
segsum_combine_kernel(const float* __restrict__ scratch,
                      float* __restrict__ out, int64_t count, int clusters) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float x[kMaxClusters];
#pragma unroll
  for (int c = 0; c < kMaxClusters; ++c)
    if (c < clusters) x[c] = scratch[c * count + i];
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxClusters; ++c)
    if (c < clusters) sum += x[c];
  out[i] = sum;
}

// Raises the kernel's dynamic shared-memory limit to its (s, DS)
// accumulator; returns the bytes, or 0 if the card refuses.
template <int DS, bool kBf16>
size_t prepare(int s) {
  const size_t smem = static_cast<size_t>(s) * DS * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      segsum_kernel<DS, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  return err == cudaSuccess ? smem : 0;
}

template <int DS, bool kBf16>
cudaError_t launch(const int32_t* rows, const float* vals, float* dst,
                   int64_t n, int64_t d, int s, int clusters, cudaStream_t st) {
  const size_t smem = prepare<DS, kBf16>(s);
  if (smem == 0) return cudaGetLastError();
  const dim3 grid(static_cast<unsigned>(kCluster * clusters),
                  static_cast<unsigned>(d / DS));
  segsum_kernel<DS, kBf16><<<grid, kThreads, smem, st>>>(rows, vals, dst, n, d, s);
  return cudaSuccess;
}

template <int DS, bool kBf16>
cudaError_t clusters_that_fit(int64_t d, int s, int* fit) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, static_cast<unsigned>(d / DS));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = prepare<DS, kBf16>(s);
  if (cfg.dynamicSmemBytes == 0) return cudaGetLastError();
  return cudaOccupancyMaxActiveClusters(fit, segsum_kernel<DS, kBf16>, &cfg);
}

// f(std::integral_constant<int, DS>{}) for the column slice ds.
template <typename F>
cudaError_t with_slice(int ds, F f) {
  switch (ds) {
    case 128: return f(std::integral_constant<int, 128>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// rows: (n,) int32; vals: (n, d) f32, 16-byte aligned; out: (s, d) f32,
// every element written; scratch: (clusters, s, d) f32 when clusters > 1
// (contents ignored), else unused. n > 0, d % 128 == 0, s % 128 == 0,
// ds in {128, 64, 32, 16, 8, 4} with s * ds * 4 <= 227 KB; compute: 0 = f32,
// 1 = bf16-rounded values; clusters: 1 ... 32 clusters of 8 blocks per
// column slice, no more than et_hot_accumulate_clusters_that_fit allows.
extern "C" int et_hot_accumulate(const void* rows, const void* vals, void* out,
                                 void* scratch, int64_t n, int64_t d, int s,
                                 int ds, int compute, int clusters,
                                 void* stream) {
  if (clusters < 1 || clusters > kMaxClusters) return cudaErrorInvalidValue;
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* x = static_cast<const float*>(vals);
  auto* o = static_cast<float*>(out);
  auto* dst = clusters > 1 ? static_cast<float*>(scratch) : o;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_slice(ds, [&](auto slice) {
    constexpr int DS = decltype(slice)::value;
    return compute == 1 ? launch<DS, true>(r, x, dst, n, d, s, clusters, st)
                        : launch<DS, false>(r, x, dst, n, d, s, clusters, st);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters > 1) {
    const int64_t count = static_cast<int64_t>(s) * d;
    segsum_combine_kernel<<<static_cast<unsigned>(
                                (count + kCombineThreads - 1) / kCombineThreads),
                            kCombineThreads, 0, st>>>(dst, o, count, clusters);
  }
  return static_cast<int>(cudaGetLastError());
}

// *fit = how many clusters of the kernel for (d, s, ds, compute) the card
// runs at once (cudaOccupancyMaxActiveClusters). Launches nothing.
extern "C" int et_hot_accumulate_clusters_that_fit(int64_t d, int s, int ds,
                                                   int compute, int* fit) {
  return static_cast<int>(with_slice(ds, [&](auto slice) {
    constexpr int DS = decltype(slice)::value;
    return compute == 1 ? clusters_that_fit<DS, true>(d, s, fit)
                        : clusters_that_fit<DS, false>(d, s, fit);
  }));
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
