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
// epilogue agrees with it bit for bit, at every width. (AdaGrad's sum of
// squares is reduced in another tree than the plain mean: rtol 1e-6.)
//
// Two passes, at every width:
//  - Pass 1 (pieces): each window is walked by its own group of threads, so
//    none walks more than L positions, whatever the longest run. L = 128 was
//    chosen on the card from 128, 256, 512 and 1024 (`chip_smoke.py
//    --run-window-sweep`): the smallest was fastest on every stream. A piece
//    starts where the row changes and is summed from zero; a piece that is a
//    whole run runs the epilogue where it ends. A piece of a run that
//    crosses a window edge goes to an f32 scratch of two slots per window
//    (2 * ceil(n / L) rows, allocated by the wrapper): slot 0 holds the
//    window's first piece if it continues a run from the window before,
//    slot 1 the last piece if it starts a run that continues into the next.
//  - Pass 2 (combine): the window that holds a crossing run's start owns it.
//    It finds the run's last window with ballots over the windows' first
//    rows, folds slot 1 of its own window and slot 0 of each later window
//    left to right, and runs the epilogue. Runs are disjoint: no atomics.
//  - The epilogue combines in f32 without FMA contraction (__fmul_rn /
//    __fadd_rn, as PyTorch's separate ops round) and writes the row once.
//    Row and position offsets are 64-bit: 6.5M rows x 516 B > 2^31 bytes.
//
// What bounds it: bytes. One add per value element read and a handful of
// operations per unique row, far below the card's ridge point: the least
// time is (values + rows + one read and one write per unique row) over
// device memory bandwidth. Reaching it takes enough bytes in flight to cover
// the memory latency, and no thread that waits on one small load before it
// can ask for the next. A row is VEC-element units (VEC = 4: 16-byte value
// accesses, when D and the pointers allow), and the design has three width
// classes by the row's units:
//
//  - 32 to 128 units (D = 128 f32, the planner's CTR tables; the first
//    redesign's layout): one warp a window, each lane CPL = 1, 2 or 4 slots of
//    the row. The warp walks its window in batches of 8 / CPL positions and
//    issues every load of a batch before the first add: the values, and the
//    table row (and accum) of each run that ends in the batch. A batch then
//    costs one memory round trip. The window's rows are staged in shared memory
//    first. What bounds it there: the bytes (73-86 % of the bound).
//  - Fewer than 32 units (narrow: D = 1, the DeepFM first-order stack; 32
//    and 64, the mixed replicated group and the two-tower tables; D = 7):
//    a warp per window left 32 - units lanes idle, and at D = 1 every lane
//    but one waited on a 4-byte load per position. Now a group of P lanes
//    takes one window, P the next power of two at or above the units, and a
//    warp walks 32 / P consecutive windows at once, each group exactly as a
//    warp walks one in the class above; D = 1 walks one window per lane.
//    The warp's windows' rows are staged in shared memory with cp.async
//    before the walk, padded to an odd stride so that the groups' reads fall
//    in distinct banks. Where a unit is 4 bytes and P <= 8 (D = 1 ... 8 off
//    the 16-byte path), the values are staged the same way (up to 35 KB, a
//    warp a block), and pass 1 splits in two: each group scans its window in
//    shared memory, summing each piece from zero in stream order and writing
//    the sum over the piece's last value; then the groups take the warp's
//    positions in turn, 16 at a time, for the epilogues of the pieces that
//    end there. The scan waits on no device load, and the epilogues' table
//    loads are 16 a lane in flight, where a walk took one round trip a batch
//    and its 32 windows' branches diverged. With 16-byte units (D = 32, 64)
//    a group already reads whole 128-byte lines per position, and staging
//    them would cut an SM to a few warps: their values stay in registers, 8
//    positions in flight, and a block holds as many warps (up to 8) as
//    their staged rows fit the default 48 KB of dynamic shared memory: at
//    one or two 16-byte units (D = 4, 8) a warp's 32 or 16 windows take
//    17.5 KB or 8.8 KB, so 2 or 5 warps. AdaGrad reduces over the group with
//    __shfl_xor_sync(width = P). What bounds the class: at the path's sizes
//    the latency of each window's 128-position chain, not the bytes (a
//    D = 1 update moves 14 MB, 5 us at the card's rate).
//    The combine pass keeps one warp a window (a grouped combine, each group
//    its window's run or the warp taking its windows' runs in turn, was
//    slower on the card: PERF.md §6), and spreads the fold over the
//    lanes: the warp's 32 / P groups load that many pieces at once and fold
//    them in order through shuffles, and the run's end is searched 128
//    windows a round, so the hottest run's fold is not one load after
//    another.
//  - More than 128 units (wide: D = 129, the folded DeepFM; 258 ... 4,096,
//    TT's middle core at rank 32): one block a window, its W = ceil(D /
//    256) warps (at most kWideWarps) each a slice of the row's units, the
//    slices of equal width (ceil(units / W)). Every warp walks the block's
//    window in the same order over its slice, a lane holding about 8
//    elements of a position, so a position's flags are worked out once for
//    8 elements, and 4 or more positions in flight. The unit follows the
//    pitch: 16 bytes when D % 4 == 0, 8 when D % 2 == 0, else 4 (no 256 + 2
//    column chunks). Both passes cover every slice of every window in one
//    grid each, so a wide update is two launches, and the grid has one
//    block a window (512 at n = 65,536, more than the 132 SMs). AdaGrad
//    reduces a run's sum of squares across the block's warps in shared
//    memory before any element is written, so the values are read once and
//    no (n,) scratch of sums is needed, for rows of up to kWideCols = 4,096
//    columns. What bounds the class: the bytes at 2,048-4,096 columns
//    (77-83 % of the bound on the card); at 258-1,025 a window's blocks
//    are few and short, and the positions' latency shows (37-50 %).
//    Wider rows (D > 4,096) are walked in column chunks of 4,096, both
//    passes once a chunk with the same windows and fold, so SGD stays
//    bitwise the plain version; their AdaGrad epilogue walks the chunks
//    twice, first adding each run's sum of squares per chunk into an (n,)
//    f32 scratch (ssq, zeroed by the wrapper, keyed by the position where
//    the run's epilogue runs), then writing each chunk (the accumulator by
//    the last chunk only).
//
// The entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

constexpr int kRunWindow = 128;        // L: positions per window (see above)
constexpr int kThreads = 256;          // most threads a block of the warp kernels
constexpr size_t kSmemBytes = 48 * 1024;  // dynamic shared memory a block may take
constexpr int kMaxBatch = 8;           // positions in flight per lane at CPL 1
constexpr int kStagedBatch = 16;       // positions per batch, values staged
constexpr int kStageMaxLanes = 8;      // groups this narrow stage 4-byte values
constexpr int kWideWarps = 16;         // most warps of a wide block (4,096 / 256)
constexpr int64_t kWideCols = 4096;    // columns a wide block holds in one pass
constexpr int kWideInFlight = 32;      // elements a wide thread keeps in flight
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// The sum of x over the P lanes of a group (lanes [P * g, P * g + P));
// `mask` holds at least the group's lanes.
template <int P>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
  for (int o = P / 2; o > 0; o >>= 1) x += __shfl_xor_sync(mask, x, o, P);
  return x;
}

template <int P>
__device__ __forceinline__ unsigned group_mask(int lane) {
  if constexpr (P == 32) {
    return kAll;
  } else {
    return ((1u << P) - 1u) << (lane / P * P);
  }
}

// A 4-byte asynchronous copy from device to shared memory (cp.async), and
// the wait for all of this thread's copies.
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int VEC, int CPL>
__device__ __forceinline__ void zero(float (&acc)[CPL][VEC]) {
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;
}

template <int VEC>
__device__ __forceinline__ void add(float (&acc)[VEC], const Pack<float, VEC>& x) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] += x.e[e];
}

template <int VEC>
__device__ __forceinline__ Pack<float, VEC> pack(const float (&acc)[VEC]) {
  Pack<float, VEC> p;
#pragma unroll
  for (int e = 0; e < VEC; ++e) p.e[e] = acc[e];
  return p;
}

// p plus the step of the run sum acc, rounded once: scale * acc (SGD), or
// (scale * acc) * rs (AdaGrad).
template <typename E, int VEC>
__device__ __forceinline__ Pack<E, VEC> stepped(Pack<E, VEC> p,
                                                const float (&acc)[VEC],
                                                float scale, float rs,
                                                bool adagrad) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float s = adagrad ? __fmul_rn(__fmul_rn(scale, acc[e]), rs)
                            : __fmul_rn(scale, acc[e]);
    p.e[e] = Elem<E>::from_f32(__fadd_rn(Elem<E>::to_f32(p.e[e]), s));
  }
  return p;
}

// ---------------------------------------------------------------------------
// The warp kernels: fewer than 32 units (P < 32) and 32 to 128 (P = 32)
// ---------------------------------------------------------------------------

// A group of P lanes takes one window, a warp G = 32 / P consecutive
// windows; lane sl of a group holds CPL slots of VEC elements, slot j being
// unit sl + P * j (units <= P * CPL).
template <int VEC, int CPL, int P>
struct Warp {
  static constexpr int G = 32 / P;
  // 4-byte values are staged in shared memory for groups of <= 8 lanes.
  static constexpr bool kStage = VEC == 1 && P <= kStageMaxLanes;
  // Positions in flight: the walk's batch, or the staged epilogues'.
  static constexpr int KB = kStage ? kStagedBatch : kMaxBatch / CPL;
  // A window's staged rows: L (then -1 for the walk's lookahead); odd, so
  // the groups' reads at one offset fall in distinct banks.
  static constexpr int RS = kStage ? kRunWindow + 1 : kRunWindow + KB + 1;
  // A window's staged values: L * d floats, padded so that the groups' P
  // consecutive words start P banks apart.
  __host__ __device__ static int64_t vals_stride(int64_t d) {
    return kRunWindow * d + P;
  }
  // Words of shared memory a warp takes: its windows' rows; when staged,
  // the rows just outside each window and the values.
  __host__ __device__ static int64_t smem_words(int64_t d) {
    return G * RS + (kStage ? 2 * G + G * vals_stride(d) : 0);
  }
};

// One lane's slots of a table row, loaded ahead of the epilogue.
template <typename E, int VEC, int CPL, int P>
struct Slice {
  Pack<E, VEC> t[CPL];
  float a_old;           // accum[row] (AdaGrad)

  __device__ __forceinline__ void load(const E* table, const float* accum,
                                       int32_t row, int64_t d, int64_t units,
                                       int sl) {
    const E* tr = table + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int64_t c = sl + P * j;
      if (c < units) t[j] = *reinterpret_cast<const Pack<E, VEC>*>(tr + c * VEC);
    }
    a_old = accum != nullptr ? accum[row] : 0.0f;
  }

  // Writes table[row] (and accum[row]) from the run sum acc when `write`.
  // Every lane of `mask` calls it (AdaGrad reduces over the group).
  __device__ __forceinline__ void epilogue(E* table, float* accum, int32_t row,
                                           int64_t d, int64_t units, int sl,
                                           unsigned mask,
                                           const float (&acc)[CPL][VEC],
                                           float scale, float eps, bool write) {
    float rs = 0.0f;
    if (accum != nullptr) {
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (sl + P * j < units)
#pragma unroll
          for (int e = 0; e < VEC; ++e) ss += acc[j][e] * acc[j][e];
      ss = group_sum<P>(ss, mask);
      const float a = a_old + ss / static_cast<float>(d);
      if (write && sl == 0) accum[row] = a;
      rs = rsqrtf(fmaxf(a + eps, 1e-30f));
    }
    if (!write) return;
    E* tr = table + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int64_t c = sl + P * j;
      if (c < units)
        *reinterpret_cast<Pack<E, VEC>*>(tr + c * VEC) =
            stepped<E, VEC>(t[j], acc[j], scale, rs, accum != nullptr);
    }
  }
};

// Pass 1 where the values stay in registers (16-byte units, or groups of
// more than 8 lanes): each group walks its window in batches of KB
// positions. E: table element bits (uint32_t f32, uint16_t bf16). Dynamic
// shared memory: Warp::smem_words(d) words for each warp of the block.
template <typename E, int VEC, int CPL, int P>
__global__ void __launch_bounds__(kThreads)
runscatter_pieces_kernel(E* __restrict__ table,
                         const int32_t* __restrict__ rows,
                         const float* __restrict__ vals,
                         float* __restrict__ accum,
                         float* __restrict__ scratch, int64_t n, int64_t v,
                         int64_t d, int64_t units, float scale, float eps) {
  using W = Warp<VEC, CPL, P>;
  constexpr int G = W::G, KB = W::KB, RS = W::RS;
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31, sl = lane % P, grp = lane / P;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t p0 = warp * G * kRunWindow;      // the warp's first position
  if (p0 >= n) return;
  int32_t* wrows = smem + (threadIdx.x >> 5) * W::smem_words(d);

  // Stage the warp's windows' rows (-1 past each window's end).
  for (int i = lane; i < G * RS; i += 32) {
    const int k = i % RS;
    const int64_t p = p0 + (i / RS) * kRunWindow + k;
    if (k < kRunWindow && p < n)
      copy_async4(wrows + i, rows + p);
    else
      wrows[i] = -1;
  }
  // This group's window, and the rows just outside it (-1: none). A piece
  // whose row is one of them belongs to a run that crosses the window's edge.
  const int64_t w = warp * G + grp;
  const int64_t w0 = w * kRunWindow;
  const bool live = w0 < n;
  const int64_t w1 = live && w0 + kRunWindow < n ? w0 + kRunWindow : n;
  const int32_t before = live && w0 > 0 ? rows[w0 - 1] : -1;
  const int32_t after = live && w1 < n ? rows[w1] : -1;
  copy_async_wait();
  __syncwarp();
  if (!live) return;

  const unsigned mask = group_mask<P>(lane);
  const int32_t* gr = wrows + grp * RS;
  float acc[CPL][VEC];
  zero(acc);
  int32_t prev = -1;                 // the row of the position before
  for (int64_t kb = w0; kb < w1; kb += KB) {
    int32_t row[KB];
    bool valid[KB], end[KB], whole[KB];
    Pack<float, VEC> x[KB][CPL];
    Slice<E, VEC, CPL, P> s[KB];
    // Every load of the batch is issued before the first add: the values,
    // and the table row (and accum) of each run that ends here.
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int64_t k = kb + u;
      row[u] = gr[k - w0];
      const int32_t next = gr[k - w0 + 1];
      valid[u] = k < w1 && row[u] >= 0 && row[u] < v;
      end[u] = valid[u] && (k == w1 - 1 || next != row[u]);
      whole[u] = row[u] != before && row[u] != after;
      if (valid[u]) {
        const float* xr = vals + k * d;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int64_t c = sl + P * j;
          if (c < units)
            x[u][j] = *reinterpret_cast<const Pack<float, VEC>*>(xr + c * VEC);
        }
      }
      if (end[u] && whole[u]) s[u].load(table, accum, row[u], d, units, sl);
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      if (!valid[u]) continue;
      if (row[u] != prev) zero(acc);   // a piece starts: sum from zero
      prev = row[u];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (sl + P * j < units) add(acc[j], x[u][j]);
      if (!end[u]) continue;
      if (whole[u]) {
        s[u].epilogue(table, accum, row[u], d, units, sl, mask, acc, scale,
                      eps, true);
      } else {
        float* sp = scratch + (2 * w + (row[u] == before ? 0 : 1)) * d;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int64_t c = sl + P * j;
          if (c < units)
            *reinterpret_cast<Pack<float, VEC>*>(sp + c * VEC) = pack(acc[j]);
        }
      }
    }
  }
}

// Pass 1 for narrow rows of 4-byte units (VEC = 1, P <= 8, one warp a
// block): the warp stages its windows' rows and values; each group scans
// its window in shared memory, summing each piece from zero in stream order
// and writing the sum over the piece's last value; then the groups take the
// warp's positions in turn, KB at a time, for the epilogues of the pieces
// that end there.
template <typename E, int P>
__global__ void __launch_bounds__(32)
runscatter_staged_kernel(E* __restrict__ table,
                         const int32_t* __restrict__ rows,
                         const float* __restrict__ vals,
                         float* __restrict__ accum,
                         float* __restrict__ scratch, int64_t n, int64_t v,
                         int64_t d, float scale, float eps) {
  using W = Warp<1, 1, P>;
  constexpr int G = W::G, KB = W::KB, RS = W::RS;
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31, sl = lane % P, grp = lane / P;
  const int64_t warp = blockIdx.x;
  const int64_t p0 = warp * G * kRunWindow;
  int32_t* wrows = smem;                      // [G][RS]
  int32_t* edges = smem + G * RS;             // [G][2]: rows before, after
  float* wvals = reinterpret_cast<float*>(edges + 2 * G);
  const int64_t vs = W::vals_stride(d);

  for (int i = lane; i < G * RS; i += 32) {
    const int k = i % RS;
    const int64_t p = p0 + (i / RS) * kRunWindow + k;
    if (k < kRunWindow && p < n)
      copy_async4(wrows + i, rows + p);
    else
      wrows[i] = -1;
  }
  for (int g = 0; g < G; ++g) {
    const int64_t q = p0 + g * kRunWindow;
    if (q >= n) break;
    const int64_t count = ((q + kRunWindow < n ? q + kRunWindow : n) - q) * d;
    for (int64_t e = lane; e < count; e += 32)
      copy_async4(wvals + g * vs + e, vals + q * d + e);
  }
  if (lane < G) {
    const int64_t q = p0 + lane * kRunWindow;
    edges[2 * lane] = q < n && q > 0 ? rows[q - 1] : -1;
    edges[2 * lane + 1] = q + kRunWindow < n ? rows[q + kRunWindow] : -1;
  }
  copy_async_wait();
  __syncwarp();

  // The scan: a piece starts where the row changes.
  if (p0 + grp * kRunWindow < n && sl < d) {
    const int32_t* gr = wrows + grp * RS;
    float* gv = wvals + grp * vs + sl;
    float acc = 0.0f;
    int32_t prev = -1;
    for (int k = 0; k < kRunWindow; ++k) {
      const int32_t r = gr[k];
      if (r >= 0 && r < v) {
        acc = (r != prev ? 0.0f : acc) + gv[k * d];
        prev = r;
        gv[k * d] = acc;
      }
    }
  }
  __syncwarp();

  // The epilogues: group grp takes the warp's positions G * i + grp.
  const unsigned mask = group_mask<P>(lane);
  for (int i0 = 0; i0 < kRunWindow; i0 += KB) {
    int32_t row[KB];
    bool end[KB], whole[KB];
    Slice<E, 1, 1, P> s[KB];
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int p = (i0 + u) * G + grp, g = p / kRunWindow, k = p % kRunWindow;
      row[u] = wrows[g * RS + k];
      // Rows past a window's end are staged as -1: a piece ends where the
      // next staged row differs.
      end[u] = row[u] >= 0 && row[u] < v && wrows[g * RS + k + 1] != row[u];
      whole[u] = row[u] != edges[2 * g] && row[u] != edges[2 * g + 1];
      if (end[u] && whole[u]) s[u].load(table, accum, row[u], d, d, sl);
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      if (!end[u]) continue;
      const int p = (i0 + u) * G + grp, g = p / kRunWindow, k = p % kRunWindow;
      const float acc[1][1] = {{sl < d ? wvals[g * vs + k * d + sl] : 0.0f}};
      if (whole[u]) {
        s[u].epilogue(table, accum, row[u], d, d, sl, mask, acc, scale, eps,
                      true);
      } else if (sl < d) {
        const int64_t w = warp * G + g;
        scratch[(2 * w + (row[u] == edges[2 * g] ? 0 : 1)) * d + sl] =
            acc[0][0];
      }
    }
  }
}

// Pass 2, one warp a window. For rows of fewer than 32 units the warp's G
// groups each load a piece, folded in order through shuffles.
template <typename E, int VEC, int CPL, int P>
__global__ void __launch_bounds__(kThreads)
runscatter_combine_kernel(E* __restrict__ table,
                          const int32_t* __restrict__ rows,
                          float* __restrict__ accum,
                          const float* __restrict__ scratch, int64_t n,
                          int64_t v, int64_t d, int64_t units, float scale,
                          float eps) {
  constexpr int G = 32 / P;
  constexpr int K = P == 32 ? 1 : 4;     // windows a lane checks a round
  // Pieces a group loads a round: 4 for a warp-wide row, else up to 64 a
  // warp (the mixed group's hottest run spans about 400 windows).
  constexpr int FB = P == 32 ? 4 : 64 / G > 16 ? 16 : 64 / G;
  const int lane = threadIdx.x & 31, sl = lane % P, grp = lane / P;
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
    bool stop[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t ww = we + lane + 32 * k;
      stop[k] = ww * kRunWindow >= n || rows[ww * kRunWindow] != row;
    }
    int first = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned m = __ballot_sync(kAll, stop[k]);
      if (first < 0 && m) first = 32 * k + __ffs(m) - 1;
    }
    if (first >= 0) {
      we += first;
      break;
    }
    we += 32 * K;
  }

  Slice<E, VEC, CPL, P> s;
  s.load(table, accum, row, d, units, sl);
  // The run's pieces: slot 1 of w, then slot 0 of w + 1 ... we - 1, folded
  // left to right; piece i is loaded by group i % G.
  float acc[CPL][VEC];
  zero(acc);
  const int64_t pieces = we - w;
  for (int64_t i0 = 0; i0 < pieces; i0 += G * FB) {
    Pack<float, VEC> x[FB][CPL];
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      const int64_t pi = i0 + f * G + grp;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        x[f][j] = Pack<float, VEC>{};
        const int64_t c = sl + P * j;
        if (pi < pieces && c < units)
          x[f][j] = *reinterpret_cast<const Pack<float, VEC>*>(
              scratch + (pi == 0 ? 2 * w + 1 : 2 * (w + pi)) * d + c * VEC);
      }
    }
#pragma unroll
    for (int f = 0; f < FB; ++f) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (i0 + f * G + h >= pieces) break;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          Pack<float, VEC> y = x[f][j];
          if constexpr (G > 1) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              y.e[e] = __shfl_sync(kAll, x[f][j].e[e], h * P + sl);
          }
          if (sl + P * j < units) add(acc[j], y);
        }
      }
    }
  }
  // Every group holds the sum; group 0 writes it.
  s.epilogue(table, accum, row, d, units, sl, kAll, acc, scale, eps,
             grp == 0);
}

// ---------------------------------------------------------------------------
// The wide kernels: more than 128 units, one block a window
// ---------------------------------------------------------------------------

// What one launch covers of each row, and what its epilogue does.
enum Mode : int {
  kFull = 0,      // the epilogue writes the columns (and, last, the accum)
  kSquares = 1,   // AdaGrad, rows wider than kWideCols: add sum(acc^2) to ssq
  kWrite = 2,     // AdaGrad, rows wider than kWideCols: write from ssq
};

struct Cols {
  int64_t d;          // the row's width and pitch, in elements
  int64_t c0;         // the launch's first column
  int64_t units;      // VEC-wide units in the launch's columns
  int64_t slice;      // units a warp takes: warp i the units [i, i + 1) * slice
  int64_t sw;         // the scratch's row pitch, in elements
  float* ssq;         // (n,) f32 sums of squares by run (kSquares, kWrite)
  int mode;
  bool write_accum;   // the launch that writes accum[row]
};

template <int VEC, int CPL>
struct Wide {
  // Positions in flight: about kWideInFlight elements a thread, at most 8.
  static constexpr int KB =
      kWideInFlight / (CPL * VEC) < 1 ? 1
      : kWideInFlight / (CPL * VEC) > kMaxBatch ? kMaxBatch
                                                : kWideInFlight / (CPL * VEC);
};

// A thread's slots of the launch's columns: slot j is unit base + lane +
// 32 * j of the warp's slice.
template <typename E, int VEC, int CPL>
struct WideSlice {
  Pack<E, VEC> t[CPL];
  float a_old;

  __device__ __forceinline__ void load(const E* table, const float* accum,
                                       int32_t row, const Cols& cols,
                                       int64_t base, const bool (&on)[CPL],
                                       int lane) {
    if (cols.mode == kSquares) return;   // writes nothing, needs no row
    const E* tr = table + static_cast<int64_t>(row) * cols.d + cols.c0;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (on[j])
        t[j] = *reinterpret_cast<const Pack<E, VEC>*>(
            tr + (base + lane + 32 * j) * VEC);
    a_old = accum != nullptr ? accum[row] : 0.0f;
  }
};

// The sum of x over the block, in one fixed order: each warp's sum to
// red[buf], one barrier, every thread adds them. The buffers alternate, so
// the next call's writes cannot overtake this call's reads.
__device__ __forceinline__ float block_sum(float x, float (*red)[kWideWarps],
                                           int& buf) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[buf][threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) s += red[buf][i];
  buf ^= 1;
  return s;
}

// Writes the launch's columns of table[row] (and accum[row]) from the run
// sum acc; in kSquares mode only adds the columns' sum(acc^2) into
// ssq[key]. Every thread of the block calls it.
template <typename E, int VEC, int CPL>
__device__ __forceinline__ void wide_epilogue(
    const WideSlice<E, VEC, CPL>& s, E* table, float* accum, int32_t row,
    const Cols& cols, int64_t key, int64_t base, const bool (&on)[CPL],
    int lane, const float (&acc)[CPL][VEC], float scale, float eps,
    float (*red)[kWideWarps], int& buf) {
  float rs = 0.0f;
  if (accum != nullptr) {
    float ss;
    if (cols.mode == kWrite) {
      ss = cols.ssq[key];
      // Every thread has read accum[row] before thread 0 writes it (kFull
      // gets this from block_sum's barrier).
      if (cols.write_accum) __syncthreads();
    } else {
      ss = 0.0f;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (on[j])
#pragma unroll
          for (int e = 0; e < VEC; ++e) ss += acc[j][e] * acc[j][e];
      ss = block_sum(ss, red, buf);
      if (cols.mode == kSquares) {
        if (threadIdx.x == 0) cols.ssq[key] += ss;
        return;
      }
    }
    const float a = s.a_old + ss / static_cast<float>(cols.d);
    if (threadIdx.x == 0 && cols.write_accum) accum[row] = a;
    rs = rsqrtf(fmaxf(a + eps, 1e-30f));
  }
  E* tr = table + static_cast<int64_t>(row) * cols.d + cols.c0;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (on[j]) {
      Pack<E, VEC>* p =
          reinterpret_cast<Pack<E, VEC>*>(tr + (base + lane + 32 * j) * VEC);
      *p = stepped<E, VEC>(s.t[j], acc[j], scale, rs, accum != nullptr);
    }
}

template <typename E, int VEC, int CPL>
__global__ void __launch_bounds__(kWideWarps * 32)
runscatter_wide_pieces_kernel(E* __restrict__ table,
                              const int32_t* __restrict__ rows,
                              const float* __restrict__ vals,
                              float* __restrict__ accum,
                              float* __restrict__ scratch, int64_t n,
                              int64_t v, Cols cols, float scale, float eps) {
  constexpr int KB = Wide<VEC, CPL>::KB;
  __shared__ int32_t wrows[kRunWindow + KB];
  __shared__ float red[2][kWideWarps];
  const int lane = threadIdx.x & 31;
  const int64_t base = (threadIdx.x >> 5) * cols.slice;
  const int64_t w = blockIdx.x;
  const int64_t w0 = w * kRunWindow;
  const int64_t w1 = w0 + kRunWindow < n ? w0 + kRunWindow : n;
  for (int i = threadIdx.x; i < kRunWindow + KB; i += blockDim.x)
    wrows[i] = w0 + i < w1 ? rows[w0 + i] : -1;
  const int32_t before = w0 > 0 ? rows[w0 - 1] : -1;
  const int32_t after = w1 < n ? rows[w1] : -1;
  bool on[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    on[j] = lane + 32 * j < cols.slice && base + lane + 32 * j < cols.units;
  __syncthreads();

  int buf = 0;
  float acc[CPL][VEC];
  zero(acc);
  int32_t prev = -1;
  for (int64_t kb = w0; kb < w1; kb += KB) {
    int32_t row[KB];
    bool valid[KB], end[KB], whole[KB];
    Pack<float, VEC> x[KB][CPL];
    WideSlice<E, VEC, CPL> s[KB];
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int64_t k = kb + u;
      row[u] = wrows[k - w0];
      const int32_t next = wrows[k - w0 + 1];
      valid[u] = k < w1 && row[u] >= 0 && row[u] < v;
      end[u] = valid[u] && (k == w1 - 1 || next != row[u]);
      whole[u] = row[u] != before && row[u] != after;
      if (valid[u]) {
        const float* xr = vals + k * cols.d + cols.c0;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (on[j])
            x[u][j] = *reinterpret_cast<const Pack<float, VEC>*>(
                xr + (base + lane + 32 * j) * VEC);
      }
      if (end[u] && whole[u])
        s[u].load(table, accum, row[u], cols, base, on, lane);
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      if (!valid[u]) continue;
      if (row[u] != prev) zero(acc);
      prev = row[u];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (on[j]) add(acc[j], x[u][j]);
      if (!end[u]) continue;
      if (whole[u]) {
        // A whole run's key is the position where it ends.
        wide_epilogue(s[u], table, accum, row[u], cols, kb + u, base, on, lane,
                      acc, scale, eps, red, buf);
      } else {
        float* sp = scratch + (2 * w + (row[u] == before ? 0 : 1)) * cols.sw;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (on[j])
            *reinterpret_cast<Pack<float, VEC>*>(
                sp + (base + lane + 32 * j) * VEC) = pack(acc[j]);
      }
    }
  }
}

template <typename E, int VEC, int CPL>
__global__ void __launch_bounds__(kWideWarps * 32)
runscatter_wide_combine_kernel(E* __restrict__ table,
                               const int32_t* __restrict__ rows,
                               float* __restrict__ accum,
                               const float* __restrict__ scratch, int64_t n,
                               int64_t v, Cols cols, float scale, float eps) {
  __shared__ float red[2][kWideWarps];
  const int lane = threadIdx.x & 31;
  const int64_t base = (threadIdx.x >> 5) * cols.slice;
  const int64_t w = blockIdx.x;
  const int64_t w0 = w * kRunWindow;
  const int64_t w1 = w0 + kRunWindow;
  if (w1 >= n) return;
  const int32_t row = rows[w1 - 1];
  if (row < 0 || row >= v || rows[w1] != row || (w0 > 0 && rows[w0 - 1] == row))
    return;
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
  bool on[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    on[j] = lane + 32 * j < cols.slice && base + lane + 32 * j < cols.units;
  WideSlice<E, VEC, CPL> s;
  s.load(table, accum, row, cols, base, on, lane);
  float acc[CPL][VEC];
  zero(acc);
#pragma unroll 8
  for (int64_t ww = w; ww < we; ++ww) {
    const float* sp = scratch + (ww == w ? 2 * w + 1 : 2 * ww) * cols.sw;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (on[j])
        add(acc[j], *reinterpret_cast<const Pack<float, VEC>*>(
                        sp + (base + lane + 32 * j) * VEC));
  }
  int buf = 0;
  // A crossing run's key is the last position of the window that owns it
  // (no whole run ends there: that position's run continues).
  wide_epilogue(s, table, accum, row, cols, w1 - 1, base, on, lane, acc,
                scale, eps, red, buf);
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

struct Args {
  void* table;
  const int32_t* rows;
  const float* vals;
  float* accum;
  float* scratch;
  float* ssq;
  int64_t n, v, d;
  float scale, eps;
  cudaStream_t s;
  int* kernels;      // adds the kernels it launches
};

enum WidthClass : int { kNarrow = 0, kMid = 1, kWide = 2 };

// The value unit of the warp kernels, in elements: 4 (16-byte value and
// scratch accesses, 16- or 8-byte table accesses) when D and the base
// pointers allow it, else 1.
int warp_vec(const Args& a, int64_t esize) {
  return a.d % 4 == 0 && aligned_to(a.vals, 16) && aligned_to(a.scratch, 16) &&
                 aligned_to(a.table, 4 * esize)
             ? 4
             : 1;
}

WidthClass width_class(const Args& a, int64_t esize) {
  const int64_t units = a.d / warp_vec(a, esize);
  return units < 32 ? kNarrow : units <= 128 ? kMid : kWide;
}

template <typename E, int VEC, int CPL, int P>
cudaError_t launch_warp(const Args& a) {
  using W = Warp<VEC, CPL, P>;
  const int64_t units = a.d / VEC;
  const int64_t windows = (a.n + kRunWindow - 1) / kRunWindow;
  const int64_t warps = (windows + W::G - 1) / W::G;
  const size_t warp_bytes = static_cast<size_t>(W::smem_words(a.d)) * 4;
  constexpr int kWarps = kThreads / 32;
  // As many warps a block as their staged windows fit the default dynamic
  // shared memory: 8, but 2 at one 16-byte unit a row (P = 1, 17.5 KB a
  // warp) and 5 at two.
  const int64_t fit = static_cast<int64_t>(kSmemBytes / warp_bytes);
  const int block = static_cast<int>(fit < kWarps ? fit : kWarps);
  if (block < 1) return cudaErrorInvalidValue;
  E* t = static_cast<E*>(a.table);
  if constexpr (W::kStage) {
    // A warp that stages values takes up to 35 KB: one warp a block.
    runscatter_staged_kernel<E, P>
        <<<static_cast<unsigned>(warps), 32, warp_bytes, a.s>>>(
            t, a.rows, a.vals, a.accum, a.scratch, a.n, a.v, a.d, a.scale,
            a.eps);
  } else {
    runscatter_pieces_kernel<E, VEC, CPL, P>
        <<<static_cast<unsigned>((warps + block - 1) / block), block * 32,
           block * warp_bytes, a.s>>>(t, a.rows, a.vals, a.accum, a.scratch,
                                      a.n, a.v, a.d, units, a.scale, a.eps);
  }
  runscatter_combine_kernel<E, VEC, CPL, P>
      <<<static_cast<unsigned>((windows + kWarps - 1) / kWarps), kThreads, 0,
         a.s>>>(t, a.rows, a.accum, a.scratch, a.n, a.v, a.d, units, a.scale,
                a.eps);
  *a.kernels += 2;
  return cudaSuccess;
}

template <typename E, int VEC>
cudaError_t launch_narrow(const Args& a) {
  const int64_t units = a.d / VEC;
  if (units <= 1) return launch_warp<E, VEC, 1, 1>(a);
  if (units <= 2) return launch_warp<E, VEC, 1, 2>(a);
  if (units <= 4) return launch_warp<E, VEC, 1, 4>(a);
  if (units <= 8) return launch_warp<E, VEC, 1, 8>(a);
  if (units <= 16) return launch_warp<E, VEC, 1, 16>(a);
  return launch_warp<E, VEC, 1, 32>(a);
}

template <typename E, int VEC>
cudaError_t launch_mid(const Args& a) {
  const int64_t units = a.d / VEC;
  if (units <= 32) return launch_warp<E, VEC, 1, 32>(a);
  if (units <= 64) return launch_warp<E, VEC, 2, 32>(a);
  return launch_warp<E, VEC, 4, 32>(a);
}

template <typename E, int VEC, int CPL>
cudaError_t launch_wide_cpl(const Args& a, const Cols& cols, int warps) {
  const unsigned grid =
      static_cast<unsigned>((a.n + kRunWindow - 1) / kRunWindow);
  E* t = static_cast<E*>(a.table);
  runscatter_wide_pieces_kernel<E, VEC, CPL><<<grid, warps * 32, 0, a.s>>>(
      t, a.rows, a.vals, a.accum, a.scratch, a.n, a.v, cols, a.scale, a.eps);
  runscatter_wide_combine_kernel<E, VEC, CPL><<<grid, warps * 32, 0, a.s>>>(
      t, a.rows, a.accum, a.scratch, a.n, a.v, cols, a.scale, a.eps);
  *a.kernels += 2;
  return cudaSuccess;
}

// Slots a thread holds: the warp's slice over 32 lanes (a slice is at most
// 256 / VEC units: CPL <= 8 / VEC). A slice wider than that launches
// nothing and is an error.
template <typename E, int VEC>
cudaError_t launch_wide_slices(const Args& a, const Cols& cols, int warps) {
  if (cols.slice <= 32) return launch_wide_cpl<E, VEC, 1>(a, cols, warps);
  if (cols.slice <= 64) return launch_wide_cpl<E, VEC, 2>(a, cols, warps);
  if constexpr (VEC <= 2) {
    if (cols.slice <= 128) return launch_wide_cpl<E, VEC, 4>(a, cols, warps);
  }
  if constexpr (VEC == 1) {
    if (cols.slice <= 256) return launch_wide_cpl<E, 1, 8>(a, cols, warps);
  }
  return cudaErrorInvalidValue;
}

template <typename E, int VEC>
cudaError_t launch_wide(const Args& a) {
  const bool chunked = a.d > kWideCols;
  if (chunked && a.accum != nullptr && a.ssq == nullptr)
    return cudaErrorInvalidValue;
  // Both passes over every chunk of kWideCols columns (one chunk up to
  // kWideCols), in order on the stream.
  auto sweep = [&](int mode) -> cudaError_t {
    for (int64_t c0 = 0; c0 < a.d; c0 += kWideCols) {
      const int64_t cw = a.d - c0 < kWideCols ? a.d - c0 : kWideCols;
      const int64_t units = cw / VEC;
      // About 8 elements a lane (32 bytes of values a position), so that a
      // position's flags are worked out once for 8 elements: at most
      // kWideWarps warps at kWideCols.
      const int64_t warps = (units * VEC + 32 * 8 - 1) / (32 * 8);
      const Cols cols{a.d, c0, units, (units + warps - 1) / warps,
                      chunked ? kWideCols : a.d, a.ssq, mode,
                      c0 + kWideCols >= a.d};
      const cudaError_t err =
          launch_wide_slices<E, VEC>(a, cols, static_cast<int>(warps));
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  };
  if (chunked && a.accum != nullptr) {
    const cudaError_t err = sweep(kSquares);
    if (err != cudaSuccess) return err;
  }
  return sweep(chunked && a.accum != nullptr ? kWrite : kFull);
}

template <typename E>
cudaError_t launch(const Args& a) {
  constexpr int64_t es = sizeof(E);
  const bool vec4 = warp_vec(a, es) == 4;
  switch (width_class(a, es)) {
    case kNarrow:
      return vec4 ? launch_narrow<E, 4>(a) : launch_narrow<E, 1>(a);
    case kMid:
      return vec4 ? launch_mid<E, 4>(a) : launch_mid<E, 1>(a);
    default:
      // The wide unit follows the pitch: 16, 8 or 4 bytes of values.
      if (vec4) return launch_wide<E, 4>(a);
      if (a.d % 2 == 0 && aligned_to(a.vals, 8) && aligned_to(a.scratch, 8) &&
          aligned_to(a.table, 2 * es))
        return launch_wide<E, 2>(a);
      return launch_wide<E, 1>(a);
  }
}

}  // namespace

// The window length L, for the wrapper to check against its own constant.
extern "C" int et_run_window() { return kRunWindow; }

// table: (v, d) f32 (dtype 0) or bf16 (dtype 1), updated in place; rows: (n,)
// int32 ascending; vals: (n, d) f32; accum: (v,) f32 for the AdaGrad
// epilogue, or null for SGD; scratch: (2 * ceil(n / L), min(d, 4096)) f32,
// contents ignored; ssq: (n,) f32 of zeros when accum is given and
// d > 4096, else ignored (may be null). n, d > 0; every pointer is a device
// pointer to a contiguous array. Rows of any width. info: null, or two ints
// that a call which returns 0 sets to its width class (0 narrow: fewer than
// 32 units; 1 32 to 128 units; 2 wide: more than 128) and the kernels it
// launched (2, or 2 a chunk and sweep past 4,096 columns).
extern "C" int et_scatter_add_rows_sorted(void* table, const void* rows,
                                          const void* vals, void* accum,
                                          void* scratch, void* ssq, int64_t n,
                                          int64_t v, int64_t d, int dtype,
                                          float scale, float eps, void* stream,
                                          int* info) {
  int kernels = 0;
  const Args a{table, static_cast<const int32_t*>(rows),
               static_cast<const float*>(vals), static_cast<float*>(accum),
               static_cast<float*>(scratch), static_cast<float*>(ssq), n, v, d,
               scale, eps, static_cast<cudaStream_t>(stream), &kernels};
  cudaError_t err = dtype == 0 ? launch<uint32_t>(a) : launch<uint16_t>(a);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && info != nullptr) {
    info[0] = width_class(a, dtype == 0 ? 4 : 2);
    info[1] = kernels;
  }
  return static_cast<int>(err);
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
