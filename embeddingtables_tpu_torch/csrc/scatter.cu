// Hand-written Hopper (sm_90a) run-scatter: the fused sparse embedding update.
//
// Replaces (embeddingtables_tpu/ops/pallas/scatter.py):
//   et_scatter_add_rows_sorted <- scatter_add_rows_sorted: _runscatter_kernel
//                                 / _runscatter_call (pl.pallas_call at :144).
//
// Over rows sorted ascending, for each run of equal rows r with 0 <= r < V,
// with acc = the f32 sum of the run's values in stream order:
//   SGD epilogue:      table[r] = table[r] + scale * acc
//   AdaGrad epilogue:  accum[r] += mean_d(acc^2)
//                      table[r] = table[r] + (scale * acc)
//                                 * rsqrt(max(accum[r] + eps, 1e-30))
// (row-wise AdaGrad with scale = -lr, the arithmetic of optim.py's indexer
// and dense bodies, with the dense body's clamp). Each row is read once and
// written once, rounded once to the table dtype (round to nearest even,
// canonical NaN). Rows < 0 are padding; rows >= V are dropped.
//
// What bounds it: bytes. One add per value element read and a handful of
// operations per unique row, far below the card's ridge point: the least
// time is (values + rows + two passes over the unique rows) over device
// memory bandwidth.
//
// What the design does about it:
//  - One launch for any n, a grid-stride loop over 32-position windows: the
//    TPU kernel's 64Ki-id chunks (SMEM) and (V, 1, D) row views do not carry
//    over. In each window every lane tests one position for a run start
//    (valid row, and the first position or a row change) and a ballot gives
//    the warp its runs.
//  - The warp that finds a run start owns the whole run: it finds the run's
//    end with ballots over 32 rows at a time, then walks the values in
//    stream order. Each lane holds VEC consecutive elements of a CPL-slot
//    slice of D in registers (16-byte value loads when D and the pointers
//    allow), so the sum is the sequential f32 sum, bit for bit what the
//    plain version computes. Runs are disjoint: no atomics, no races.
//  - The epilogue reads the row once, combines in f32 without FMA
//    contraction (__fmul_rn / __fadd_rn, as PyTorch's separate ops round),
//    and writes the row once. AdaGrad reduces sum(acc^2) over the warp.
//  - Row offsets are 64-bit: 6.5M rows x 512 B is more than 2^31 bytes.
//  - A hot row under Zipf traffic is walked serially by its one warp; the
//    values of one walk are loaded eight at a time (unrolled loop).
//
// The entry point launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

constexpr int kThreads = 256;       // threads per block
constexpr int kBlocksPerSm = 8;     // 8 x 256 = the 2048 threads an SM holds
constexpr int kMaxCpl = 8;          // register slots per lane

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// E: table element bits (uint32_t f32, uint16_t bf16); VEC: elements per
// lane access; CPL: VEC-wide slots per lane, units = d / VEC <= 32 * CPL.
template <typename E, int VEC, int CPL>
__global__ void __launch_bounds__(kThreads)
runscatter_kernel(E* __restrict__ table, const int32_t* __restrict__ rows,
                  const float* __restrict__ vals, float* __restrict__ accum,
                  int64_t n, int64_t v, int64_t d, float scale, float eps) {
  using TP = Pack<E, VEC>;
  using VP = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const int64_t units = d / VEC;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;

  for (int64_t base = warp * 32; base < n; base += nwarps * 32) {
    const int64_t k = base + lane;
    int32_t r = -1;
    bool start = false;
    if (k < n) {
      r = rows[k];
      start = r >= 0 && r < v && (k == 0 || rows[k - 1] != r);
    }
    unsigned starts = __ballot_sync(0xffffffffu, start);
    while (starts) {
      const int src = __ffs(starts) - 1;
      starts &= starts - 1;
      const int32_t row = __shfl_sync(0xffffffffu, r, src);
      const int64_t k0 = base + src;

      // The run's end: the first position past k0 whose row differs.
      int64_t k1 = k0 + 1;
      for (;;) {
        const int64_t kk = k1 + lane;
        const bool other = kk >= n || rows[kk] != row;
        const unsigned m = __ballot_sync(0xffffffffu, other);
        if (m) {
          k1 += __ffs(m) - 1;
          break;
        }
        k1 += 32;
      }

      float acc[CPL][VEC];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;

#pragma unroll 8
      for (int64_t kk = k0; kk < k1; ++kk) {
        const float* vr = vals + kk * d;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int64_t c = lane + 32 * j;
          if (c < units) {
            const VP p = *reinterpret_cast<const VP*>(vr + c * VEC);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[j][e] += p.e[e];
          }
        }
      }

      if (accum != nullptr) {
        float ss = 0.0f;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (lane + 32 * j < units)
#pragma unroll
            for (int e = 0; e < VEC; ++e) ss += acc[j][e] * acc[j][e];
        ss = warp_sum(ss);
        const float a = accum[row] + ss / static_cast<float>(d);
        __syncwarp();
        if (lane == 0) accum[row] = a;
        const float rs = rsqrtf(fmaxf(a + eps, 1e-30f));
#pragma unroll
        for (int j = 0; j < CPL; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[j][e] = __fmul_rn(__fmul_rn(scale, acc[j][e]), rs);
      }

      E* tr = table + static_cast<int64_t>(row) * d;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int64_t c = lane + 32 * j;
        if (c < units) {
          TP p = *reinterpret_cast<const TP*>(tr + c * VEC);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float s =
                accum != nullptr ? acc[j][e] : __fmul_rn(scale, acc[j][e]);
            p.e[e] = Elem<E>::from_f32(__fadd_rn(Elem<E>::to_f32(p.e[e]), s));
          }
          *reinterpret_cast<TP*>(tr + c * VEC) = p;
        }
      }
    }
  }
}

template <typename E, int VEC>
cudaError_t launch_vec(void* table, const int32_t* rows, const float* vals,
                       float* accum, int64_t n, int64_t v, int64_t d,
                       float scale, float eps, int sms, cudaStream_t s) {
  const int64_t units = d / VEC;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks)), block(kThreads);
  E* t = static_cast<E*>(table);
  if (units <= 32)
    runscatter_kernel<E, VEC, 1><<<grid, block, 0, s>>>(t, rows, vals, accum, n, v, d, scale, eps);
  else if (units <= 64)
    runscatter_kernel<E, VEC, 2><<<grid, block, 0, s>>>(t, rows, vals, accum, n, v, d, scale, eps);
  else if (units <= 128)
    runscatter_kernel<E, VEC, 4><<<grid, block, 0, s>>>(t, rows, vals, accum, n, v, d, scale, eps);
  else if (units <= 32 * kMaxCpl)
    runscatter_kernel<E, VEC, kMaxCpl><<<grid, block, 0, s>>>(t, rows, vals, accum, n, v, d, scale, eps);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename E>
cudaError_t launch(void* table, const int32_t* rows, const float* vals,
                   float* accum, int64_t n, int64_t v, int64_t d, float scale,
                   float eps, int sms, cudaStream_t s) {
  // Four elements a lane: a 16-byte value load and a 16- (f32) or 8-byte
  // (bf16) table access, when D and both base pointers allow it.
  if (d % 4 == 0 && aligned_to(vals, 16) && aligned_to(table, 4 * sizeof(E)))
    return launch_vec<E, 4>(table, rows, vals, accum, n, v, d, scale, eps, sms, s);
  return launch_vec<E, 1>(table, rows, vals, accum, n, v, d, scale, eps, sms, s);
}

}  // namespace

// table: (v, d) f32 (dtype 0) or bf16 (dtype 1), updated in place; rows: (n,)
// int32 ascending; vals: (n, d) f32; accum: (v,) f32 for the AdaGrad
// epilogue, or null for SGD. n, d > 0; every pointer is a device pointer to
// a contiguous array; sms is the card's SM count. Returns
// cudaErrorInvalidValue, launching nothing, for rows wider than the registers
// hold: d > 1024 (d % 4 == 0 and 16-byte aligned values), else d > 256.
extern "C" int et_scatter_add_rows_sorted(void* table, const void* rows,
                                          const void* vals, void* accum,
                                          int64_t n, int64_t v, int64_t d,
                                          int dtype, float scale, float eps,
                                          int sms, void* stream) {
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* x = static_cast<const float*>(vals);
  auto* a = static_cast<float*>(accum);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<uint32_t>(table, r, x, a, n, v, d, scale, eps, sms, s)
                 : launch<uint16_t>(table, r, x, a, n, v, d, scale, eps, sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
