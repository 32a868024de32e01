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
// (rows read + ids read + output written) over device memory bandwidth. To
// reach it, enough bytes must be in flight to cover the memory latency
// (Little's law): a warp that waits for one row before it asks for the next
// cannot.
//
// What the design does about it:
//  - Rows move in 16-byte chunks whatever their pitch. A row whose pitch is
//    off the 16-byte grid (DeepFM's fused D + 1 = 129 f32 row is 516 bytes)
//    starts anywhere in a chunk, and its output row starts elsewhere in
//    another. Lanes load the aligned 16-byte chunks of the window that covers
//    the source row, shifted so that window byte 16k + b is output chunk k's
//    byte 0, where b = (source start - output offset) mod 16. Each lane
//    realigns its chunk with its neighbour's (one __shfl_sync per word, then
//    a word select and __funnelshift_r), and stores whole aligned chunks;
//    only the partial chunks at the two ends of an output row are stored in
//    U-byte units (U = 4, or 2 for bf16 rows of odd width or 2-byte aligned
//    bases). The aligned chunk reads never cross an allocation's edge. A
//    tensor map (TMA) cannot take such a pitch: its strides must be
//    multiples of 16 bytes.
//  - A stream of LPS lanes (4 ... 32) owns a row, each lane CPL (1 or 2)
//    chunks of it: a compile-time width class picked from the row's chunk
//    count, up to 64 chunks (about 1 KB; wider rows off the grid take one
//    element a lane). A warp runs 32 / LPS streams, each with R rows in
//    flight (kRowsInFlight, chosen on the card with `chip_smoke.py
//    --gather-sweep`): the warp reads its rows' ids in one coalesced load,
//    broadcasts them with shuffles, and issues every load of all its rows
//    before the first store. CPL is a template parameter, so the loads stay
//    independent.
//  - Table loads take the read-only path (__ldg); output stores stream
//    (__stcs), so the n x D output does not push the hot rows of a skewed id
//    stream out of the 50 MB L2.
//  - gather_bags accumulates each bag in f32 registers, in bag order, R bag
//    rows in flight, and rounds once (the Pallas kernel sums in the table
//    dtype). Rows on the 16-byte grid keep the first version's kernel, which
//    holds 16 bytes a lane for the whole bag and reaches 76 % of its bound.
//  - Which kernel a width takes was measured on the card (`chip_smoke.py
//    --gather-sweep`): gather_rows rows on the 16-byte grid of at least a
//    warp's 32 chunks (D = 128 f32) take the vector kernel, narrower grid
//    rows (D = 64, 36) the first version's one 16-byte unit a lane, where
//    the vector kernel was 3-8 % slower. Rows narrower than one chunk
//    (DeepFM's first-order D = 1) take one element a lane, a third of the
//    vector kernel's time there.
//  - Rows are walked with a grid-stride loop sized to fill the SMs, so one
//    launch covers any n. Byte offsets are 64-bit: 6.5M rows x 516 B is more
//    than 2^31 bytes.
//  - Id contract of the JAX lookup (jnp.take on the stacked table): an id in
//    [-V, 0) wraps to id + V; any other out-of-range id gives a row of NaN,
//    and a bag that holds one sums to NaN. No read ever leaves the table's
//    allocation, and an out-of-range id reads nothing.
//
// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

constexpr int kThreads = 256;       // threads per block
constexpr int kBlocksPerSm = 8;     // 8 x 256 = the 2048 threads an SM holds
constexpr int kRowsInFlight = 4;    // R, rows in flight per stream
// gather_rows on the 16-byte grid takes the vector kernel from this pitch
// up (a warp's 32 chunks), the first version's kernel below it; chosen on
// the card with the sweep.
constexpr int64_t kGridVecMinBytes = 512;
constexpr int kMaxChunks = 64;      // 16-byte chunks a stream holds (CPL 2)
constexpr unsigned kFull = 0xffffffffu;

// The JAX id contract: wrap [-v, 0), reject the rest.
__device__ __forceinline__ bool resolve(int32_t raw, int64_t v, int64_t* row) {
  int64_t id = raw;
  if (id < 0) id += v;
  *row = id;
  return id >= 0 && id < v;
}

// ---------------------------------------------------------------------------
// Rows on the 16-byte grid (pitch and both bases 16-byte aligned), and rows
// off it that the vector kernels do not take (narrower than one chunk, or
// wider than kMaxChunks)
// ---------------------------------------------------------------------------

// U is the unit one lane moves: a uint4 on the 16-byte grid, else one
// element. A group of lanes owns one output row.
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

// Each lane sums N consecutive elements of the row over the bag: one 16-byte
// pack on the grid, else one element (N = 1).
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

// ---------------------------------------------------------------------------
// Rows at any pitch: aligned chunks, realigned in registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 shfl_u4(uint4 x, int src, int width) {
  x.x = __shfl_sync(kFull, x.x, src, width);
  x.y = __shfl_sync(kFull, x.y, src, width);
  x.z = __shfl_sync(kFull, x.z, src, width);
  x.w = __shfl_sync(kFull, x.w, src, width);
  return x;
}

// Bytes [b, b + 16) of the 32 bytes a:c. b is a multiple of U.
template <int U>
__device__ __forceinline__ uint4 realign(uint4 a, uint4 c, int b) {
  uint32_t r0, r1, r2, r3, r4;
  switch (b >> 2) {
    case 0: r0 = a.x; r1 = a.y; r2 = a.z; r3 = a.w; r4 = c.x; break;
    case 1: r0 = a.y; r1 = a.z; r2 = a.w; r3 = c.x; r4 = c.y; break;
    case 2: r0 = a.z; r1 = a.w; r2 = c.x; r3 = c.y; r4 = c.z; break;
    default: r0 = a.w; r1 = c.x; r2 = c.y; r3 = c.z; r4 = c.w; break;
  }
  if constexpr (U == 2) {
    const unsigned sh = (b & 3) * 8;   // 0 or 16
    r0 = __funnelshift_r(r0, r1, sh);
    r1 = __funnelshift_r(r1, r2, sh);
    r2 = __funnelshift_r(r2, r3, sh);
    r3 = __funnelshift_r(r3, r4, sh);
  }
  return make_uint4(r0, r1, r2, r3);
}

// Store the aligned output chunk at `addr`, which holds bytes [lo, lo + 16)
// of an output row of `len` bytes: whole when it lies inside, else its bytes
// inside in U-byte units. Streaming stores.
template <int U>
__device__ __forceinline__ void store_chunk(char* addr, uint4 o, int lo, int len) {
  if (lo >= 0 && lo + 16 <= len) {
    __stcs(reinterpret_cast<uint4*>(addr), o);
    return;
  }
  const uint32_t w[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
  for (int e = 0; e < 16 / U; ++e) {
    const int p = lo + e * U;
    if (p >= 0 && p < len) {
      if constexpr (U == 4)
        __stcs(reinterpret_cast<unsigned int*>(addr) + e, w[e]);
      else
        __stcs(reinterpret_cast<unsigned short*>(addr) + e,
               static_cast<unsigned short>(w[e / 2] >> (16 * (e & 1))));
    }
  }
}

// Where one row sits: its output start and offset in a chunk, the shift b
// and the aligned window of its source, and its length (0 past the end of
// the gather).
struct Seg {
  uintptr_t dst, src, win;
  int len, shift, oa;
};

__device__ __forceinline__ Seg locate(const char* table, char* out, int64_t row,
                                      int64_t i, int len, int64_t pitch) {
  Seg s;
  s.src = reinterpret_cast<uintptr_t>(table) + static_cast<uintptr_t>(row * pitch);
  s.dst = reinterpret_cast<uintptr_t>(out) + static_cast<uintptr_t>(i * pitch);
  s.oa = static_cast<int>(s.dst & 15);
  s.win = (s.src - s.oa) & ~static_cast<uintptr_t>(15);
  s.shift = static_cast<int>((s.src - s.oa) & 15);
  s.len = len;
  return s;
}

// Chunk j of this lane from the row's window, if it overlaps the row.
template <int LPS>
__device__ __forceinline__ uint4 load_chunk(const Seg& s, bool use, int j, int sl) {
  const uintptr_t c = s.win + 16 * static_cast<uintptr_t>(j * LPS + sl);
  if (use && c < s.src + s.len && c + 16 > s.src)
    return __ldg(reinterpret_cast<const uint4*>(c));
  return make_uint4(0u, 0u, 0u, 0u);
}

// Output chunk j * LPS + sl of a row from the lanes' window chunks: this
// lane's slot j and the next chunk (the next lane's slot j, or lane 0's slot
// j + 1 for the last lane of the stream). Every lane must call it.
template <int U, int LPS, int CPL>
__device__ __forceinline__ uint4 output_chunk(const uint4 (&x)[CPL], int j, int sl,
                                              int shift) {
  const uint4 supply = (sl == 0 && j + 1 < CPL) ? x[j + 1 < CPL ? j + 1 : j] : x[j];
  const uint4 nxt = shfl_u4(supply, sl + 1, LPS);
  return realign<U>(x[j], nxt, shift);
}

template <int U, int LPS, int CPL>
__global__ void __launch_bounds__(kThreads)
gather_rows_vec_kernel(const char* __restrict__ table,
                       const int32_t* __restrict__ idx, char* __restrict__ out,
                       int64_t n, int64_t v, int64_t pitch, uint32_t nan_word) {
  constexpr int R = kRowsInFlight;
  constexpr int NS = 32 / LPS;          // streams per warp
  constexpr int SW = NS * R;            // rows per warp and round
  constexpr int IDS = (SW + 31) / 32;   // ids per lane and round
  const int lane = threadIdx.x & 31, sl = lane % LPS, stream = lane / LPS;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const uint4 nan4 = make_uint4(nan_word, nan_word, nan_word, nan_word);
  for (int64_t i0 = warp * SW; i0 < n; i0 += warps * SW) {
    // Row q of the round is i0 + s * NS + stream for row slot s.
    int32_t ids[IDS];
#pragma unroll
    for (int a = 0; a < IDS; ++a) {
      const int64_t i = i0 + a * 32 + lane;
      ids[a] = i < n ? __ldg(idx + i) : 0;
    }
    uint4 x[R][CPL];
    Seg seg[R];
    bool ok[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int q = s * NS + stream;
      const int32_t raw = __shfl_sync(kFull, ids[(s * NS) / 32], q & 31);
      const int64_t i = i0 + q;
      int64_t row;
      ok[s] = resolve(raw, v, &row);
      seg[s] = locate(table, out, row, i, i < n ? static_cast<int>(pitch) : 0,
                      pitch);
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        x[s][j] = load_chunk<LPS>(seg[s], ok[s], j, sl);
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      char* base = reinterpret_cast<char*>(seg[s].dst - seg[s].oa);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const uint4 o = output_chunk<U, LPS, CPL>(x[s], j, sl, seg[s].shift);
        const int k = j * LPS + sl;
        store_chunk<U>(base + 16 * k, ok[s] ? o : nan4, 16 * k - seg[s].oa,
                       seg[s].len);
      }
    }
  }
}

template <typename E>
__device__ __forceinline__ void add_chunk(float* acc, uint4 o) {
  const uint32_t w[4] = {o.x, o.y, o.z, o.w};
  if constexpr (sizeof(E) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += __uint_as_float(w[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] += Elem<uint16_t>::to_f32(static_cast<uint16_t>(w[e / 2] >> (16 * (e & 1))));
  }
}

template <typename E>
__device__ __forceinline__ uint4 pack_chunk(const float* acc, bool ok) {
  uint32_t w[4];
  if constexpr (sizeof(E) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = ok ? __float_as_uint(acc[e]) : Elem<uint32_t>::kNan;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = ok ? Elem<uint16_t>::from_f32(acc[2 * e]) : Elem<uint16_t>::kNan;
      const uint32_t hi = ok ? Elem<uint16_t>::from_f32(acc[2 * e + 1]) : Elem<uint16_t>::kNan;
      w[e] = lo | (hi << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A stream owns one output row and walks its bag R rows at a time: every
// load of the R rows first, then their adds in bag order.
template <typename E, int U, int LPS, int CPL>
__global__ void __launch_bounds__(kThreads)
gather_bags_vec_kernel(const char* __restrict__ table,
                       const int32_t* __restrict__ idx, char* __restrict__ out,
                       int64_t n, int64_t bag, int64_t v, int64_t pitch) {
  constexpr int R = kRowsInFlight;
  constexpr int NS = 32 / LPS;
  constexpr int EPC = 16 / sizeof(E);   // elements a chunk
  const int lane = threadIdx.x & 31, sl = lane % LPS, stream = lane / LPS;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i0 = warp * NS; i0 < n; i0 += warps * NS) {
    const bool live = i0 + stream < n;
    const int64_t i = live ? i0 + stream : 0;
    const int len = live ? static_cast<int>(pitch) : 0;
    const int32_t* ids = idx + i * bag;
    float acc[CPL][EPC];
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[j][e] = 0.0f;
    bool all_ok = true;
    for (int64_t k0 = 0; k0 < bag; k0 += R) {
      uint4 x[R][CPL];
      int shift[R];
      bool use[R];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const bool in_bag = live && k0 + s < bag;
        int64_t row = 0;
        const bool ok = in_bag ? resolve(__ldg(ids + k0 + s), v, &row) : true;
        all_ok = all_ok && ok;
        use[s] = in_bag && ok;
        const Seg sg = locate(table, out, row, i, len, pitch);
        shift[s] = sg.shift;
#pragma unroll
        for (int j = 0; j < CPL; ++j) x[s][j] = load_chunk<LPS>(sg, use[s], j, sl);
      }
#pragma unroll
      for (int s = 0; s < R; ++s) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const uint4 o = output_chunk<U, LPS, CPL>(x[s], j, sl, shift[s]);
          if (use[s]) add_chunk<E>(acc[j], o);
        }
      }
    }
    const uintptr_t dst = reinterpret_cast<uintptr_t>(out) +
                          static_cast<uintptr_t>(i * pitch);
    const int oa = static_cast<int>(dst & 15);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int k = j * LPS + sl;
      store_chunk<U>(reinterpret_cast<char*>(dst - oa) + 16 * k,
                     pack_chunk<E>(acc[j], all_ok), 16 * k - oa, len);
    }
  }
}

// Most 16-byte window chunks a row of `pitch` bytes can span: the pitch
// plus the shift and the output offset, each at most 16 - U bytes; on the
// grid, the pitch alone.
int64_t window_chunks(int64_t pitch, int u, bool grid) {
  return grid ? pitch / 16 : (pitch + 2 * (16 - u) - 1) / 16 + 1;
}

// The launch of a vector kernel: its width class (LPS lanes a row, CPL
// chunks a lane) and grid.
struct VecPlan {
  int lps, cpl;
  int64_t blocks;
};

VecPlan vec_plan(int64_t n, int64_t nch, int rows_per_stream, int sms) {
  VecPlan p;
  p.lps = nch <= 4 ? 4 : nch <= 8 ? 8 : nch <= 16 ? 16 : 32;
  p.cpl = nch <= 32 ? 1 : 2;
  const int64_t per_block = (kThreads / p.lps) * rows_per_stream;
  p.blocks = (n + per_block - 1) / per_block;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (p.blocks > most) p.blocks = most;
  return p;
}

template <int U, int LPS, int CPL>
void rows_vec(const VecPlan& p, const void* table, const int32_t* idx, void* out,
              int64_t n, int64_t v, int64_t pitch, uint32_t nan_word,
              cudaStream_t stream) {
  gather_rows_vec_kernel<U, LPS, CPL>
      <<<static_cast<unsigned>(p.blocks), kThreads, 0, stream>>>(
          static_cast<const char*>(table), idx, static_cast<char*>(out), n, v,
          pitch, nan_word);
}

template <int U>
void launch_rows_vec(const void* table, const int32_t* idx, void* out, int64_t n,
                     int64_t v, int64_t pitch, int64_t nch, uint32_t nan_word,
                     int sms, cudaStream_t s) {
  const VecPlan p = vec_plan(n, nch, kRowsInFlight, sms);
  switch (p.lps * 10 + p.cpl) {
    case 41: rows_vec<U, 4, 1>(p, table, idx, out, n, v, pitch, nan_word, s); break;
    case 81: rows_vec<U, 8, 1>(p, table, idx, out, n, v, pitch, nan_word, s); break;
    case 161: rows_vec<U, 16, 1>(p, table, idx, out, n, v, pitch, nan_word, s); break;
    case 321: rows_vec<U, 32, 1>(p, table, idx, out, n, v, pitch, nan_word, s); break;
    default: rows_vec<U, 32, 2>(p, table, idx, out, n, v, pitch, nan_word, s); break;
  }
}

template <typename E, int U, int LPS, int CPL>
void bags_vec(const VecPlan& p, const void* table, const int32_t* idx, void* out,
              int64_t n, int64_t bag, int64_t v, int64_t pitch,
              cudaStream_t stream) {
  gather_bags_vec_kernel<E, U, LPS, CPL>
      <<<static_cast<unsigned>(p.blocks), kThreads, 0, stream>>>(
          static_cast<const char*>(table), idx, static_cast<char*>(out), n, bag,
          v, pitch);
}

template <typename E, int U>
void launch_bags_vec(const void* table, const int32_t* idx, void* out, int64_t n,
                     int64_t bag, int64_t v, int64_t pitch, int64_t nch, int sms,
                     cudaStream_t s) {
  const VecPlan p = vec_plan(n, nch, 1, sms);
  switch (p.lps * 10 + p.cpl) {
    case 41: bags_vec<E, U, 4, 1>(p, table, idx, out, n, bag, v, pitch, s); break;
    case 81: bags_vec<E, U, 8, 1>(p, table, idx, out, n, bag, v, pitch, s); break;
    case 161: bags_vec<E, U, 16, 1>(p, table, idx, out, n, bag, v, pitch, s); break;
    case 321: bags_vec<E, U, 32, 1>(p, table, idx, out, n, bag, v, pitch, s); break;
    default: bags_vec<E, U, 32, 2>(p, table, idx, out, n, bag, v, pitch, s); break;
  }
}

bool aligned_bytes(const void* a, const void* b, int64_t pitch, unsigned m) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           static_cast<uintptr_t>(pitch)) & (m - 1)) == 0;
}

// The store unit of the vector kernels: 4 bytes when the pitch and both
// bases allow, else 2 (bf16 rows of odd width, 2-byte aligned bases).
int unit_of(const void* table, const void* out, int64_t pitch) {
  return aligned_bytes(table, out, pitch, 4) ? 4 : 2;
}

// Which kernel a row takes: the vector kernel off the grid for rows of at
// least one chunk and at most kMaxChunks, and on the grid from
// kGridVecMinBytes; else the grid's 16-byte units or one element a lane.
enum class Path { kVec, kGrid, kElement };

Path path_of(bool grid, int64_t pitch, int64_t nch, int64_t grid_vec_min) {
  if (nch <= kMaxChunks && (grid ? pitch >= grid_vec_min : pitch >= 16))
    return Path::kVec;
  return grid ? Path::kGrid : Path::kElement;
}

template <typename E>
cudaError_t launch_rows(const void* table, const int32_t* idx, void* out,
                        int64_t n, int64_t v, int64_t d, int sms,
                        cudaStream_t stream) {
  if (!aligned_bytes(table, out, 0, sizeof(E))) return cudaErrorMisalignedAddress;
  const int64_t pitch = d * static_cast<int64_t>(sizeof(E));
  const uint32_t nan_word = sizeof(E) == 4 ? Elem<uint32_t>::kNan
      : (uint32_t(Elem<uint16_t>::kNan) << 16) | Elem<uint16_t>::kNan;
  const bool grid = aligned_bytes(table, out, pitch, 16);
  const int u = grid ? 4 : unit_of(table, out, pitch);
  const int64_t nch = window_chunks(pitch, u, grid);
  switch (path_of(grid, pitch, nch, kGridVecMinBytes)) {
    case Path::kVec:
      if (u == 4)
        launch_rows_vec<4>(table, idx, out, n, v, pitch, nch, nan_word, sms, stream);
      else
        launch_rows_vec<2>(table, idx, out, n, v, pitch, nch, nan_word, sms, stream);
      break;
    case Path::kGrid: {
      const Plan p = plan(n, pitch / 16, sms);
      gather_rows_kernel<uint4><<<p.grid, p.block, 0, stream>>>(
          static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), n, v,
          pitch / 16, make_uint4(nan_word, nan_word, nan_word, nan_word));
      break;
    }
    case Path::kElement: {
      const Plan p = plan(n, d, sms);
      gather_rows_kernel<E><<<p.grid, p.block, 0, stream>>>(
          static_cast<const E*>(table), idx, static_cast<E*>(out), n, v, d,
          Elem<E>::kNan);
      break;
    }
  }
  return cudaSuccess;
}

// gather_bags keeps the first version's kernel on the grid, where it reaches
// 76 % of its bound and beats F.embedding_bag.
template <typename E>
cudaError_t launch_bags(const void* table, const int32_t* idx, void* out,
                        int64_t n, int64_t bag, int64_t v, int64_t d, int sms,
                        cudaStream_t stream) {
  if (!aligned_bytes(table, out, 0, sizeof(E))) return cudaErrorMisalignedAddress;
  const int64_t pitch = d * static_cast<int64_t>(sizeof(E));
  const bool grid = aligned_bytes(table, out, pitch, 16);
  const int u = grid ? 4 : unit_of(table, out, pitch);
  const int64_t nch = window_chunks(pitch, u, grid);
  switch (path_of(grid, pitch, nch, INT64_MAX)) {
    case Path::kVec:
      if (u == 4)
        launch_bags_vec<E, 4>(table, idx, out, n, bag, v, pitch, nch, sms, stream);
      else
        launch_bags_vec<E, 2>(table, idx, out, n, bag, v, pitch, nch, sms, stream);
      break;
    case Path::kGrid: {
      constexpr int kVec = 16 / sizeof(E);
      const Plan p = plan(n, d / kVec, sms);
      gather_bags_kernel<E, kVec><<<p.grid, p.block, 0, stream>>>(
          static_cast<const E*>(table), idx, static_cast<E*>(out), n, bag, v, d);
      break;
    }
    case Path::kElement: {
      const Plan p = plan(n, d, sms);
      gather_bags_kernel<E, 1><<<p.grid, p.block, 0, stream>>>(
          static_cast<const E*>(table), idx, static_cast<E*>(out), n, bag, v, d);
      break;
    }
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. n, d > 0; every pointer is a device
// pointer to a contiguous array aligned to its element; sms is the card's SM
// count.
extern "C" int et_gather_rows(const void* table, const void* idx, void* out,
                              int64_t n, int64_t v, int64_t d, int dtype,
                              int sms, void* stream) {
  const auto* ids = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_rows<uint32_t>(table, ids, out, n, v, d, sms, s)
                 : launch_rows<uint16_t>(table, ids, out, n, v, d, sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int et_gather_bags(const void* table, const void* idx, void* out,
                              int64_t n, int64_t bag, int64_t v, int64_t d,
                              int dtype, int sms, void* stream) {
  const auto* ids = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_bags<uint32_t>(table, ids, out, n, bag, v, d, sms, s)
                 : launch_bags<uint16_t>(table, ids, out, n, bag, v, d, sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
