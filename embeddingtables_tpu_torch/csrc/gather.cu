// Hand-written Hopper (sm_90a) gathers for the embedding lookup.
//
// Replaces (embeddingtables_tpu/ops/pallas/gather.py):
//   et_gather_rows  <- gather_rows: _gather_rows_kernel / _gather_rows_call
//                      (pl.pallas_call at :116) and _gather_rows_kernel_v2 /
//                      _gather_rows_v2 (pl.pallas_call at :169).
//                      O[i, :] = T[idx[i], :]
//   et_gather_bags  <- gather_bags: _gather_bags_kernel / _gather_bags_call
//                      (pl.pallas_call at :258).
//                      O[i, :] = sum_k T[idx[i, k], :]
//
// What bounds them: bytes. A gather does no arithmetic and a bag-sum one add
// per element read, far below the card's ridge point, so the least time is
// (rows read + ids read + output written) over device memory bandwidth.
//
// What the design does about it:
//  - A group of lanes (blockDim.x, up to a warp) owns one output row. When
//    the row pitch and both base pointers are 16-byte aligned every lane
//    moves 16 bytes per access, so a group's accesses to one row coalesce
//    into whole 32-byte sectors; otherwise a scalar path moves one element
//    per lane (any feature size is served, as the JAX lookup serves any).
//  - Rows are walked with a grid-stride loop sized to fill the SMs, so one
//    launch covers any n. Each lane reads its row's id itself: the TPU
//    kernels' scalar-prefetch chunks, (V, 1, D) row views and VMEM tile
//    budgets have no counterpart here.
//  - gather_bags accumulates each bag in f32 registers, in bag order, and
//    stores once (the Pallas kernel sums in the table dtype).
//  - Row offsets are 64-bit: 6.5M rows x 512 B is more than 2^31 bytes.
//  - Id contract of the JAX lookup (jnp.take on the stacked table): an id in
//    [-V, 0) wraps to id + V; any other out-of-range id gives a row of NaN,
//    and a bag that holds one sums to NaN. No read ever leaves the table.
//
// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

constexpr int kThreads = 256;       // threads per block
constexpr int kBlocksPerSm = 8;     // 8 x 256 = the 2048 threads an SM holds

// The JAX id contract: wrap [-v, 0), reject the rest.
__device__ __forceinline__ bool resolve(int32_t raw, int64_t v, int64_t* row) {
  int64_t id = raw;
  if (id < 0) id += v;
  *row = id;
  return id >= 0 && id < v;
}

// U is the unit one lane moves: a uint4 (16 bytes) or one element.
template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const U* __restrict__ table, const int32_t* __restrict__ idx,
                   U* __restrict__ out, int64_t n, int64_t v, int64_t units,
                   U nan) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.y;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
       i < n; i += stride) {
    int64_t row;
    U* dst = out + i * units;
    if (resolve(idx[i], v, &row)) {
      const U* src = table + row * units;
      for (int64_t c = threadIdx.x; c < units; c += blockDim.x) dst[c] = src[c];
    } else {
      for (int64_t c = threadIdx.x; c < units; c += blockDim.x) dst[c] = nan;
    }
  }
}

// Each lane sums N consecutive elements of the row (one 16-byte pack when
// N * sizeof(E) == 16, else N == 1).
template <typename E, int N>
__global__ void __launch_bounds__(kThreads)
gather_bags_kernel(const E* __restrict__ table, const int32_t* __restrict__ idx,
                   E* __restrict__ out, int64_t n, int64_t bag, int64_t v,
                   int64_t d) {
  using P = Pack<E, N>;
  const int64_t packs = d / N;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.y;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
       i < n; i += stride) {
    const int32_t* ids = idx + i * bag;
    for (int64_t c = threadIdx.x; c < packs; c += blockDim.x) {
      float acc[N];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = 0.0f;
      bool ok = true;
      for (int64_t k = 0; k < bag; ++k) {
        int64_t row;
        if (!resolve(ids[k], v, &row)) {
          ok = false;
          break;
        }
        const P p = *reinterpret_cast<const P*>(table + row * d + c * N);
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] += Elem<E>::to_f32(p.e[j]);
      }
      P o;
#pragma unroll
      for (int j = 0; j < N; ++j)
        o.e[j] = ok ? Elem<E>::from_f32(acc[j]) : Elem<E>::kNan;
      *reinterpret_cast<P*>(out + i * d + c * N) = o;
    }
  }
}

// Lanes per row: the units of one row rounded up to a power of two, at most a
// warp; the rest of the block's 256 threads take further rows.
struct Plan {
  dim3 grid, block;
};

Plan plan(int64_t n, int64_t units, int sms) {
  int tx = 1;
  while (tx < units && tx < 32) tx <<= 1;
  const int ty = kThreads / tx;
  int64_t blocks = (n + ty - 1) / ty;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  Plan p;
  p.grid = dim3(static_cast<unsigned>(blocks));
  p.block = dim3(tx, ty);
  return p;
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15u) == 0;
}

template <typename E>
void launch_rows(const void* table, const int32_t* idx, void* out, int64_t n,
                 int64_t v, int64_t d, int sms, cudaStream_t stream) {
  if ((d * sizeof(E)) % 16 == 0 && aligned16(table, out)) {
    const int64_t units = d * sizeof(E) / 16;
    const uint32_t w = sizeof(E) == 4 ? Elem<uint32_t>::kNan
                                      : (uint32_t(Elem<uint16_t>::kNan) << 16) | Elem<uint16_t>::kNan;
    const Plan p = plan(n, units, sms);
    gather_rows_kernel<uint4><<<p.grid, p.block, 0, stream>>>(
        static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), n, v,
        units, make_uint4(w, w, w, w));
  } else {
    const Plan p = plan(n, d, sms);
    gather_rows_kernel<E><<<p.grid, p.block, 0, stream>>>(
        static_cast<const E*>(table), idx, static_cast<E*>(out), n, v, d,
        Elem<E>::kNan);
  }
}

template <typename E>
void launch_bags(const void* table, const int32_t* idx, void* out, int64_t n,
                 int64_t bag, int64_t v, int64_t d, int sms,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(E);
  if (d % kVec == 0 && aligned16(table, out)) {
    const Plan p = plan(n, d / kVec, sms);
    gather_bags_kernel<E, kVec><<<p.grid, p.block, 0, stream>>>(
        static_cast<const E*>(table), idx, static_cast<E*>(out), n, bag, v, d);
  } else {
    const Plan p = plan(n, d, sms);
    gather_bags_kernel<E, 1><<<p.grid, p.block, 0, stream>>>(
        static_cast<const E*>(table), idx, static_cast<E*>(out), n, bag, v, d);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. n, d > 0; every pointer is a device
// pointer to a contiguous array; sms is the card's SM count.
extern "C" int et_gather_rows(const void* table, const void* idx, void* out,
                              int64_t n, int64_t v, int64_t d, int dtype,
                              int sms, void* stream) {
  const auto* ids = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_rows<uint32_t>(table, ids, out, n, v, d, sms, s);
  else
    launch_rows<uint16_t>(table, ids, out, n, v, d, sms, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int et_gather_bags(const void* table, const void* idx, void* out,
                              int64_t n, int64_t bag, int64_t v, int64_t d,
                              int dtype, int sms, void* stream) {
  const auto* ids = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_bags<uint32_t>(table, ids, out, n, bag, v, d, sms, s);
  else
    launch_bags<uint16_t>(table, ids, out, n, bag, v, d, sms, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
