// Hand-written Hopper (sm_90a) run-scatter: the fused sparse embedding update.
//
// Replaces (embeddingtables_tpu/ops/pallas/scatter.py):
//   et_scatter_add_rows_sorted <- scatter_add_rows_sorted (:159):
//                                 _runscatter_kernel (:60) /
//                                 _runscatter_call (pl.pallas_call at :144).
//
// Over rows sorted ascending, for each run of equal rows r with 0 <= r < V,
// with acc = the f32 sum of the run's values:
//   SGD epilogue:      table[r] = table[r] + scale * acc
//   AdaGrad epilogue:  accum[r] += mean_d(acc^2)
//                      table[r] = table[r] + (scale * acc)
//                                 * rsqrt(max(accum[r] + eps, 1e-30))
// (row-wise AdaGrad with scale = -lr, the arithmetic of optim.py's indexer
// and dense bodies, with the dense body's clamp). Each row is read once and
// written once, rounded once to the table dtype (round to nearest even,
// canonical NaN). Rows < 0 are padding; rows >= V are dropped.
//
// The order of the f32 additions: the stream is cut into windows of
// kRunWindow (L = 128) positions at absolute multiples of L, and each window
// at run starts into pieces. A piece is a run, or the part of a run inside
// one window. Each piece is summed from zero in stream order; a run's pieces
// are folded left to right, ((p0 + p1) + p2) + ... A run inside one window
// is one piece: its sum is the plain stream-order sum. The plain version in
// ops/cuda/scatter.py makes the same additions in the same order, so the SGD
// epilogue agrees with it bit for bit.
//
// What bounds it: bytes. One add per value element read and a handful of
// operations per unique row, far below the card's ridge point: the least
// time is (values + rows + two passes over the unique rows) over device
// memory bandwidth. The first version (one warp walked a whole run) was
// instead bound by the serial walk of the hottest run under Zipf traffic:
// 8,696 positions at about 6 per microsecond.
//
// What the design does about it:
//  - Pass 1 (runscatter_pieces_kernel): one warp per window, so no warp
//    walks more than L positions, whatever the longest run. L = 128 was
//    chosen on the card from 128, 256, 512 and 1024 (`chip_smoke.py
//    --run-window-sweep`): the smallest was fastest on every stream.
//  - The warp walks its window in batches of 8 positions (8 / CPL for wider
//    rows). It issues every load of a batch before the first add: the
//    values, and the table row (and accum) of each run that ends in the
//    batch. A batch then costs one memory round trip, where walking run by
//    run cost one per run. Each lane holds VEC consecutive elements of a
//    CPL-slot slice of D in registers (16-byte value loads when D and the
//    pointers allow). A piece starts where the row changes and is summed
//    from zero; a piece that is a whole run runs the epilogue where it ends.
//  - A piece of a run that crosses a window edge goes to an f32 scratch of
//    two slots per window (2 * ceil(n / L) * D * 4 bytes, allocated by the
//    wrapper): slot 0 holds the window's first piece if it continues a run
//    from the window before, slot 1 the last piece if it starts a run that
//    continues into the next window.
//  - Pass 2 (runscatter_combine_kernel): one warp per window; the window
//    that holds a crossing run's start owns it. It finds the run's last
//    window with ballots over the windows' first rows, folds slot 1 of its
//    own window and slot 0 of each later window left to right, and runs the
//    epilogue. Runs are disjoint: no atomics, no races. Only crossing
//    pieces touch the scratch: at most 2 * 2 * ceil(n / L) * D * 4 bytes
//    written and read, 2 % of the Zipf stream's bound at n = 1.70M.
//  - The epilogue combines in f32 without FMA contraction (__fmul_rn /
//    __fadd_rn, as PyTorch's separate ops round) and writes the row once.
//    AdaGrad reduces sum(acc^2) over the warp.
//  - Row and position offsets are 64-bit: 6.5M rows x 512 B is more than
//    2^31 bytes.
//
// The entry point launches both passes on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

constexpr int kRunWindow = 128;     // L: positions per window (see above)
constexpr int kThreads = 256;       // threads per block: one warp a window
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxCpl = 8;          // register slots per lane
constexpr int kMaxBatch = 8;        // positions a warp loads at once
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// One lane's slice of a row: CPL slots of VEC consecutive elements, slot j
// at element offset (lane + 32 * j) * VEC.
template <typename E, int VEC, int CPL>
struct Slice {
  Pack<E, VEC> t[CPL];   // the table row, loaded ahead of the epilogue
  float a_old;           // accum[row] (AdaGrad)

  __device__ __forceinline__ void load(const E* table, const float* accum,
                                       int32_t row, int64_t d, int64_t units,
                                       int lane) {
    const E* tr = table + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int64_t c = lane + 32 * j;
      if (c < units) t[j] = *reinterpret_cast<const Pack<E, VEC>*>(tr + c * VEC);
    }
    a_old = accum != nullptr ? accum[row] : 0.0f;
  }

  // Writes table[row] (and accum[row]) from the run sum acc.
  __device__ __forceinline__ void epilogue(E* table, float* accum, int32_t row,
                                           int64_t d, int64_t units, int lane,
                                           float (&acc)[CPL][VEC], float scale,
                                           float eps) {
    if (accum != nullptr) {
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (lane + 32 * j < units)
#pragma unroll
          for (int e = 0; e < VEC; ++e) ss += acc[j][e] * acc[j][e];
      ss = warp_sum(ss);
      const float a = a_old + ss / static_cast<float>(d);
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
        Pack<E, VEC> p = t[j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float s =
              accum != nullptr ? acc[j][e] : __fmul_rn(scale, acc[j][e]);
          p.e[e] = Elem<E>::from_f32(__fadd_rn(Elem<E>::to_f32(p.e[e]), s));
        }
        *reinterpret_cast<Pack<E, VEC>*>(tr + c * VEC) = p;
      }
    }
  }
};

template <int VEC, int CPL>
__device__ __forceinline__ void zero(float (&acc)[CPL][VEC]) {
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;
}

// acc += the lane's slice of the f32 row at src.
template <int VEC, int CPL>
__device__ __forceinline__ void add_row(float (&acc)[CPL][VEC],
                                        const float* src, int64_t units,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int64_t c = lane + 32 * j;
    if (c < units) {
      const Pack<float, VEC> p = *reinterpret_cast<const Pack<float, VEC>*>(src + c * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] += p.e[e];
    }
  }
}

// E: table element bits (uint32_t f32, uint16_t bf16); VEC: elements per
// lane access; CPL: VEC-wide slots per lane, units = d / VEC <= 32 * CPL.
template <typename E, int VEC, int CPL>
__global__ void __launch_bounds__(kThreads)
runscatter_pieces_kernel(E* __restrict__ table,
                         const int32_t* __restrict__ rows,
                         const float* __restrict__ vals,
                         float* __restrict__ accum,
                         float* __restrict__ scratch, int64_t n, int64_t v,
                         int64_t d, float scale, float eps) {
  constexpr int kBatch = CPL >= kMaxBatch ? 1 : kMaxBatch / CPL;
  const int lane = threadIdx.x & 31;
  const int64_t units = d / VEC;
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t w0 = w * kRunWindow;
  if (w0 >= n) return;
  const int64_t w1 = w0 + kRunWindow < n ? w0 + kRunWindow : n;
  // The rows just outside the window (-1: none). A piece whose row is one
  // of them belongs to a run that crosses the window's edge.
  const int32_t before = w0 > 0 ? rows[w0 - 1] : -1;
  const int32_t after = w1 < n ? rows[w1] : -1;

  // The window's rows, staged in shared memory in one round trip (-1 past
  // its end), so no value load waits on a load of rows.
  __shared__ int32_t staged[kWarpsPerBlock][kRunWindow + kMaxBatch];
  int32_t* wrows = staged[threadIdx.x >> 5];
#pragma unroll
  for (int i = lane; i < kRunWindow + kMaxBatch; i += 32)
    wrows[i] = w0 + i < w1 ? rows[w0 + i] : -1;
  __syncwarp();

  float acc[CPL][VEC];
  zero(acc);
  int32_t prev = -1;                 // the row of the position before
  for (int64_t kb = w0; kb < w1; kb += kBatch) {
    int32_t row[kBatch];
    bool valid[kBatch], end[kBatch], whole[kBatch];
    Pack<float, VEC> x[kBatch][CPL];
    Slice<E, VEC, CPL> sl[kBatch];
    // Every load of the batch is issued before the first add: the values,
    // and the table row (and accum) of each run that ends here.
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t k = kb + u;
      row[u] = wrows[k - w0];
      const int32_t next = wrows[k - w0 + 1];
      valid[u] = k < w1 && row[u] >= 0 && row[u] < v;
      end[u] = valid[u] && (k == w1 - 1 || next != row[u]);
      whole[u] = row[u] != before && row[u] != after;
      if (valid[u]) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int64_t c = lane + 32 * j;
          if (c < units)
            x[u][j] = *reinterpret_cast<const Pack<float, VEC>*>(vals + k * d + c * VEC);
        }
      }
      if (end[u] && whole[u]) sl[u].load(table, accum, row[u], d, units, lane);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!valid[u]) continue;
      if (row[u] != prev) zero(acc);   // a piece starts: sum from zero
      prev = row[u];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (lane + 32 * j < units)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] += x[u][j].e[e];
      if (!end[u]) continue;
      if (whole[u]) {
        sl[u].epilogue(table, accum, row[u], d, units, lane, acc, scale, eps);
      } else {
        float* sp = scratch + (2 * w + (row[u] == before ? 0 : 1)) * d;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int64_t c = lane + 32 * j;
          if (c < units) {
            Pack<float, VEC> p;
#pragma unroll
            for (int e = 0; e < VEC; ++e) p.e[e] = acc[j][e];
            *reinterpret_cast<Pack<float, VEC>*>(sp + c * VEC) = p;
          }
        }
      }
    }
  }
}

template <typename E, int VEC, int CPL>
__global__ void __launch_bounds__(kThreads)
runscatter_combine_kernel(E* __restrict__ table,
                          const int32_t* __restrict__ rows,
                          float* __restrict__ accum,
                          const float* __restrict__ scratch, int64_t n,
                          int64_t v, int64_t d, float scale, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t units = d / VEC;
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t w0 = w * kRunWindow;
  const int64_t w1 = w0 + kRunWindow;
  if (w1 >= n) return;               // the last window's runs cross no edge
  // This window owns the run of its last row if that run continues into
  // the next window and does not come from the window before.
  const int32_t row = rows[w1 - 1];
  if (row < 0 || row >= v || rows[w1] != row || (w0 > 0 && rows[w0 - 1] == row))
    return;

  // The run covers windows w + 1 ... we - 1: the first window past w + 1
  // whose first row differs (or that does not exist) is we.
  int64_t we = w + 2;
  for (;;) {
    const int64_t ww = we + lane;
    const bool stop = ww * kRunWindow >= n || rows[ww * kRunWindow] != row;
    const unsigned m = __ballot_sync(kAll, stop);
    if (m) {
      we += __ffs(m) - 1;
      break;
    }
    we += 32;
  }

  Slice<E, VEC, CPL> sl;
  sl.load(table, accum, row, d, units, lane);
  float acc[CPL][VEC];
  zero(acc);
  add_row(acc, scratch + (2 * w + 1) * d, units, lane);
#pragma unroll 4
  for (int64_t ww = w + 1; ww < we; ++ww)
    add_row(acc, scratch + 2 * ww * d, units, lane);
  sl.epilogue(table, accum, row, d, units, lane, acc, scale, eps);
}

template <typename E, int VEC, int CPL>
cudaError_t launch_cpl(E* table, const int32_t* rows, const float* vals,
                       float* accum, float* scratch, int64_t n, int64_t v,
                       int64_t d, float scale, float eps, cudaStream_t s) {
  const int64_t windows = (n + kRunWindow - 1) / kRunWindow;
  const dim3 grid(static_cast<unsigned>(
      (windows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  runscatter_pieces_kernel<E, VEC, CPL><<<grid, kThreads, 0, s>>>(
      table, rows, vals, accum, scratch, n, v, d, scale, eps);
  runscatter_combine_kernel<E, VEC, CPL><<<grid, kThreads, 0, s>>>(
      table, rows, accum, scratch, n, v, d, scale, eps);
  return cudaSuccess;
}

template <typename E, int VEC>
cudaError_t launch_vec(void* table, const int32_t* rows, const float* vals,
                       float* accum, float* scratch, int64_t n, int64_t v,
                       int64_t d, float scale, float eps, cudaStream_t s) {
  const int64_t units = d / VEC;
  E* t = static_cast<E*>(table);
  if (units <= 32)
    return launch_cpl<E, VEC, 1>(t, rows, vals, accum, scratch, n, v, d, scale, eps, s);
  if (units <= 64)
    return launch_cpl<E, VEC, 2>(t, rows, vals, accum, scratch, n, v, d, scale, eps, s);
  if (units <= 128)
    return launch_cpl<E, VEC, 4>(t, rows, vals, accum, scratch, n, v, d, scale, eps, s);
  if (units <= 32 * kMaxCpl)
    return launch_cpl<E, VEC, kMaxCpl>(t, rows, vals, accum, scratch, n, v, d, scale, eps, s);
  return cudaErrorInvalidValue;
}

template <typename E>
cudaError_t launch(void* table, const int32_t* rows, const float* vals,
                   float* accum, float* scratch, int64_t n, int64_t v,
                   int64_t d, float scale, float eps, cudaStream_t s) {
  // Four elements a lane: a 16-byte value and scratch access and a 16- (f32)
  // or 8-byte (bf16) table access, when D and the base pointers allow it.
  if (d % 4 == 0 && aligned_to(vals, 16) && aligned_to(scratch, 16) &&
      aligned_to(table, 4 * sizeof(E)))
    return launch_vec<E, 4>(table, rows, vals, accum, scratch, n, v, d, scale, eps, s);
  return launch_vec<E, 1>(table, rows, vals, accum, scratch, n, v, d, scale, eps, s);
}

}  // namespace

// The window length L, for the wrapper to check against its own constant.
extern "C" int et_run_window() { return kRunWindow; }

// table: (v, d) f32 (dtype 0) or bf16 (dtype 1), updated in place; rows: (n,)
// int32 ascending; vals: (n, d) f32; accum: (v,) f32 for the AdaGrad
// epilogue, or null for SGD; scratch: (2 * ceil(n / L), d) f32, contents
// ignored. n, d > 0; every pointer is a device pointer to a contiguous
// array. Returns cudaErrorInvalidValue, launching nothing, for rows wider
// than the registers hold: d > 1024 (d % 4 == 0 and 16-byte aligned values),
// else d > 256.
extern "C" int et_scatter_add_rows_sorted(void* table, const void* rows,
                                          const void* vals, void* accum,
                                          void* scratch, int64_t n, int64_t v,
                                          int64_t d, int dtype, float scale,
                                          float eps, void* stream) {
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* x = static_cast<const float*>(vals);
  auto* a = static_cast<float*>(accum);
  auto* sc = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<uint32_t>(table, r, x, a, sc, n, v, d, scale, eps, s)
                 : launch<uint16_t>(table, r, x, a, sc, n, v, d, scale, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
