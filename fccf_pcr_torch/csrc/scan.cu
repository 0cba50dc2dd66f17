// Scans along long rows on Hopper (sm_90a), with a plain C interface bound
// with ctypes by fccf_pcr_torch/ops/scan.py.
//
// S1, fccf_scan_int: the integer scans of the register step along the last
// dim of (rows, n): the inclusive prefix sum (bool, int32 or int64 in,
// int64 out, as torch.cumsum promotes), the running max and the running
// min from the row's end (int32 or int64). It replaces torch.cumsum,
// torch.cummax and the flip / cummin / flip of the port (the JAX package's
// jnp.cumsum in _run_segments, _kth_impl and compact,
// fccf_pcr_tpu/ops/voxelize.py:116, :208, :386, and lax.cummax at :526).
// Bound: the bytes, each entry read once and written once. A row is cut
// into tiles of kTile entries in scan order (from the row's end for the
// reversed min), a block a tile; a first launch reduces each tile to its
// total, a second one gives each block the combination of the totals of
// the row's tiles before it and scans its tile from there. A row of one
// tile takes the second launch alone. A warp holds 512 consecutive
// entries as 4 rows of 32 groups of 4, a group a lane, so neighbouring
// lanes load neighbouring words (16 bytes a lane for int32, 32 for int64,
// 4 for bool) and a lane's 4 loads are issued together; a lane scans its
// groups serially, the warp the groups' totals by shuffles and the block
// the warps' totals, one barrier. Integer sums wrap and max / min are
// exact, so the result equals torch's in any order of combination. The
// design reads a row of two tiles or more twice: a single pass with
// decoupled look-back (Merrill and Garland 2016: tiles taken by an atomic
// ticket, aggregates and inclusive prefixes published with release stores
// and read with acquire loads, the ticket and flags zeroed by a
// cudaMemsetAsync a call) read it once but was slower on the step's rows
// in turns (PERF.md section 6).
//
// S2, fccf_prefix_sum16*: the float32 inclusive prefix sum along dim 1 of
// (B, n, D) columns in the association of XLA's cumsum on the CPU (the
// reference's goldens; jnp.cumsum at fccf_pcr_tpu/ops/voxelize.py :143,
// :530 and :584), bit for bit equal to the port's plain version
// (ops/scan.py::_prefix_sum0): level k's entries T_k (T_0 the input) are
// cut into rows of 16; a row's prefixes P are sequential sums from +0.0
// (entries past the end add +0.0, as the plain version's padding); the row
// totals, T_{k+1}, are scanned the same way, up to a level of at most 16
// entries, which is one such row (one entry: returned as it is); then each
// level's output is P + E, E the previous row's output one level up (+0.0
// for the first row: -0.0 + 0.0 is +0.0, so the zero is added, never
// skipped). The association fixes the order of every add; the design only
// chooses where they run. A block takes 256 entries (a level-1 row: 16
// rows of 16) of a group of at most 16 columns: its 64 threads form the
// columns from their sources, four entries a thread (the sources read
// once a launch), into shared memory sized to the group, and the sums run
// there a (row, column) a thread. Three launches a call:
//   1. up: the block's T_1 (its 16 row totals), then their total, an
//      entry of T_2, which alone goes to the scratch;
//   2. top: a block a (b, column) runs levels 2..K in the scratch (960 ->
//      60 -> 4 entries at 245760 rows) and writes level 2's output;
//   3. down: the block's T_1 again and level 1's output from level 2's,
//      then level 0's output, staged in shared memory and written by
//      neighbouring threads to neighbouring addresses. The block's first
//      row takes the previous level-1 row's last output, T_2 + the
//      level-2 output before it (that association).
// Level 1 never leaves the chip. A column of at most 256 entries (K <= 1)
// is one launch of the down kernel. The columns come from their sources:
// a dense (B, n, D) tensor (fccf_prefix_sum16), the voxelization's leaf
// columns [px w, py w, pz w, ff] (w = float(m), ff = float(first & m);
// fccf_prefix_sum16_leaf) or its moment columns [x, y, z, xx, yy, zz, xy,
// xz, yz, float(m)] (ops/voxelize.py::_outer6's order;
// fccf_prefix_sum16_moments), so the concatenated columns are never
// written. A product is a float32 multiply (__fmul_rn), never a select:
// x * 0.0 keeps -0.0 and NaN or inf times 0.0 is NaN, as torch's product.
// Bound: the bytes, the sources read once and the output written once;
// the up and the down launch each read the sources, the levels above add
// 1/256.
//
// Every entry launches on the given stream, allocates nothing (the caller
// passes the scratch) and returns cudaGetLastError() after its launches.
// Built with nvcc --fmad=false and no fast math: no product is contracted
// into the scan's first add and no add is dropped (the adds are
// __fadd_rn as well).

#include <cuda_runtime.h>

#include <climits>

namespace {

// ------------------------------------------------------------------ S1 --

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                       // entries a thread
constexpr long long kTile = kThreads * kItems;   // entries a block: 1024
constexpr int kGroupItems = 4;                   // consecutive, a load
constexpr int kRows = kItems / kGroupItems;      // groups a thread
constexpr int kRowLen = 32 * kGroupItems;        // entries a warp row
constexpr unsigned kFull = 0xffffffffu;

enum Op { kSum = 0, kMax = 1, kMinReversed = 2 };
enum InType { kBool = 0, kInt32 = 1, kInt64 = 2 };

template <typename T> struct Limits;
template <> struct Limits<int> {
  static __device__ __forceinline__ int lowest() { return INT_MIN; }
  static __device__ __forceinline__ int highest() { return INT_MAX; }
};
template <> struct Limits<long long> {
  static __device__ __forceinline__ long long lowest() { return LLONG_MIN; }
  static __device__ __forceinline__ long long highest() { return LLONG_MAX; }
};

template <int OP, typename T>
__device__ __forceinline__ T identity() {
  if (OP == kSum) return 0;
  if (OP == kMax) return Limits<T>::lowest();
  return Limits<T>::highest();
}

template <int OP, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if (OP == kSum)  // wraps, as torch's integer cumsum does
    return (T)((unsigned long long)a + (unsigned long long)b);
  if (OP == kMax) return a > b ? a : b;
  return a < b ? a : b;
}

// Entry j of a row in scan order (from the row's end for kMinReversed).
template <int OP>
__device__ __forceinline__ long long position(long long n, long long j) {
  return OP == kMinReversed ? n - 1 - j : j;
}

// A lane's kGroupItems consecutive entries (scan order) as the widest
// load words that divide them (16 bytes at most), or as entries.
template <int BYTES> struct Word;
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<16> { using type = uint4; };
template <> struct Word<32> { using type = uint4; };

template <typename E>
union Group {
  using W = typename Word<kGroupItems * sizeof(E)>::type;
  W w[kGroupItems * sizeof(E) / sizeof(W)];
  E e[kGroupItems];
};

// Entries j .. j + kGroupItems - 1 of a row in scan order (contiguous in
// memory, descending for the reversed min); entries past the row's end
// are the identity.
template <int OP, typename In, typename T>
__device__ __forceinline__ void load_group(const In* __restrict__ xr,
                                           long long n, long long j,
                                           T (&v)[kGroupItems]) {
  using W = typename Group<In>::W;
  if (j + kGroupItems <= n) {
    const In* src = xr + (OP == kMinReversed ? n - j - kGroupItems : j);
    Group<In> u;
    if (((unsigned long long)src & (sizeof(W) - 1)) == 0) {
#pragma unroll
      for (int k = 0; k < (int)(sizeof(u.w) / sizeof(W)); ++k)
        u.w[k] = __ldg(reinterpret_cast<const W*>(src) + k);
    } else {
#pragma unroll
      for (int c = 0; c < kGroupItems; ++c) u.e[c] = __ldg(src + c);
    }
#pragma unroll
    for (int i = 0; i < kGroupItems; ++i)
      v[i] = (T)u.e[OP == kMinReversed ? kGroupItems - 1 - i : i];
  } else {
#pragma unroll
    for (int i = 0; i < kGroupItems; ++i) {
      const long long jj = j + i;
      v[i] = jj < n ? (T)__ldg(xr + position<OP>(n, jj)) : identity<OP, T>();
    }
  }
}

template <int OP, typename T>
__device__ __forceinline__ void store_group(T* __restrict__ outr, long long n,
                                            long long j,
                                            const T (&v)[kGroupItems]) {
  using W = typename Group<T>::W;
  if (j + kGroupItems <= n) {
    T* dst = outr + (OP == kMinReversed ? n - j - kGroupItems : j);
    Group<T> u;
#pragma unroll
    for (int c = 0; c < kGroupItems; ++c)
      u.e[c] = v[OP == kMinReversed ? kGroupItems - 1 - c : c];
    if (((unsigned long long)dst & (sizeof(W) - 1)) == 0) {
#pragma unroll
      for (int k = 0; k < (int)(sizeof(u.w) / sizeof(W)); ++k)
        reinterpret_cast<W*>(dst)[k] = u.w[k];
    } else {
#pragma unroll
      for (int c = 0; c < kGroupItems; ++c) dst[c] = u.e[c];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kGroupItems; ++i) {
      const long long jj = j + i;
      if (jj < n) outr[position<OP>(n, jj)] = v[i];
    }
  }
}

// The warp's 512 entries of tile ``tile`` are kRows rows of 32 groups of
// kGroupItems, group ``lane`` of each row the lane's, so neighbouring
// lanes load neighbouring words: the scan-order index of the lane's first
// entry.
__device__ __forceinline__ long long lane_start(long long tile, int warp,
                                                int lane) {
  return tile * kTile + (long long)warp * (32 * kItems) + kGroupItems * lane;
}

template <int OP, typename T>
__device__ __forceinline__ T warp_combine(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = combine<OP>(v, (T)__shfl_xor_sync(kFull, v, o));
  return v;
}

// Launch 1 (rows of two tiles or more): totals[row * tiles + tile] = the
// combination of the tile's entries.
template <int OP, typename In, typename T>
__global__ void __launch_bounds__(kThreads)
scan_tile_reduce_kernel(const In* __restrict__ x, T* __restrict__ totals,
                        long long n, long long row_stride, long long tiles) {
  __shared__ T s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const In* xr = x + row * row_stride;
  const long long j0 = lane_start(tile, warp, lane);
  T v[kRows][kGroupItems];
#pragma unroll
  for (int r = 0; r < kRows; ++r) load_group<OP>(xr, n, j0 + r * kRowLen, v[r]);
  T t = identity<OP, T>();
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < kGroupItems; ++i) t = combine<OP>(t, v[r][i]);
  t = warp_combine<OP>(t);
  if (lane == 0) s_warp[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = identity<OP, T>();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total = combine<OP>(total, s_warp[w]);
    totals[blockIdx.x] = total;
  }
}

// Launch 2 (the only one for rows of one tile): the tile's inclusive scan,
// from the combination of the totals of the row's tiles before it.
template <int OP, typename In, typename T>
__global__ void __launch_bounds__(kThreads)
scan_tile_apply_kernel(const In* __restrict__ x, T* __restrict__ out,
                       const T* __restrict__ totals, long long n,
                       long long row_stride, long long tiles) {
  __shared__ T s_warp[kWarps];
  __shared__ T s_carry[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const In* xr = x + row * row_stride;
  const long long j0 = lane_start(tile, warp, lane);
  T v[kRows][kGroupItems];
#pragma unroll
  for (int r = 0; r < kRows; ++r) load_group<OP>(xr, n, j0 + r * kRowLen, v[r]);
  T c = identity<OP, T>();
  for (long long k = threadIdx.x; k < tile; k += kThreads)
    c = combine<OP>(c, __ldg(totals + row * tiles + k));
  c = warp_combine<OP>(c);
  if (lane == 0) s_carry[warp] = c;
  T incl[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 1; i < kGroupItems; ++i)
      v[r][i] = combine<OP>(v[r][i - 1], v[r][i]);
    incl[r] = v[r][kGroupItems - 1];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const T u = (T)__shfl_up_sync(kFull, incl[r], o);
      if (lane >= o) incl[r] = combine<OP>(u, incl[r]);
    }
  }
  // Each group's exclusive prefix within the warp, and the warp's total.
  T pre[kRows];
  T carry = identity<OP, T>();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    T ex = (T)__shfl_up_sync(kFull, incl[r], 1);
    if (lane == 0) ex = identity<OP, T>();
    pre[r] = combine<OP>(carry, ex);
    carry = combine<OP>(carry, (T)__shfl_sync(kFull, incl[r], 31));
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  T before = identity<OP, T>();  // the tiles before, then the warps before
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before = combine<OP>(before, s_carry[w]);
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w < warp) before = combine<OP>(before, s_warp[w]);
  T* outr = out + row * n;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const T p = combine<OP>(before, pre[r]);
#pragma unroll
    for (int i = 0; i < kGroupItems; ++i) v[r][i] = combine<OP>(p, v[r][i]);
    store_group<OP>(outr, n, j0 + r * kRowLen, v[r]);
  }
}

long long scan_tiles(long long n) { return (n + kTile - 1) / kTile; }

template <int OP, typename In, typename T>
int scan_int(const void* x, void* out, void* totals, long long rows,
             long long n, long long row_stride, cudaStream_t stream) {
  const long long tiles = scan_tiles(n);
  const long long blocks = rows * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  if (tiles > 1) {
    scan_tile_reduce_kernel<OP, In, T><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(
        (const In*)x, (T*)totals, n, row_stride, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  scan_tile_apply_kernel<OP, In, T><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
      (const In*)x, (T*)out, (const T*)totals, n, row_stride, tiles);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ S2 --

constexpr int kS2Threads = 64;
constexpr int kBase = 16;
constexpr int kBlockLen = kBase * kBase;  // entries a block: a level-1 row
constexpr int kGroup = 16;                // columns a block at most
constexpr int kMaxLevels = 24;

__host__ __device__ inline long long up16(long long len) {
  return (len + kBase - 1) / kBase;
}

// lens[0] = n, lens[k + 1] = ceil(lens[k] / 16) while lens[k] > 16;
// returns K, the number of levels above the input.
__host__ __device__ inline int levels(long long n, long long* lens) {
  int K = 0;
  lens[0] = n;
  while (lens[K] > kBase) {
    lens[K + 1] = up16(lens[K]);
    ++K;
  }
  return K;
}

// Floats of the scratch a (b, column): none where level 1 is the top
// (K <= 1), else T_2, level 2's output and the levels 3..K.
long long scratch_floats(long long n) {
  long long lens[kMaxLevels];
  const int K = levels(n, lens);
  if (K < 2) return 0;
  long long total = 2 * lens[2];
  for (int k = 3; k <= K; ++k) total += lens[k];
  return total;
}

// The columns' sources. ``entry`` writes entry i's ``dg`` columns from
// column d0 on, of batch row b, to dst[0 .. dg - 1]; kCols is the number
// of columns where the source fixes it (one column group), else 0.

struct Dense {  // x (B, n, D) contiguous
  static constexpr int kCols = 0;
  const float* x;
  long long D;
  __device__ __forceinline__ void entry(long long b, long long n,
                                        long long i, int d0, int dg,
                                        float* dst) const {
    const float* src = x + (b * n + i) * D + d0;
    for (int d = 0; d < dg; ++d) dst[d] = __ldg(src + d);
  }
};

struct Leaf {  // [px w, py w, pz w, ff], w = float(m), ff = float(first & m)
  static constexpr int kCols = 4;
  const float* px;
  const float* py;
  const float* pz;
  const unsigned char* m;
  const unsigned char* first;
  __device__ __forceinline__ void entry(long long b, long long n,
                                        long long i, int, int,
                                        float* dst) const {
    const long long k = b * n + i;
    const bool in = __ldg(m + k) != 0;
    const float w = in ? 1.0f : 0.0f;
    dst[0] = __fmul_rn(__ldg(px + k), w);
    dst[1] = __fmul_rn(__ldg(py + k), w);
    dst[2] = __fmul_rn(__ldg(pz + k), w);
    dst[3] = in && __ldg(first + k) != 0 ? 1.0f : 0.0f;
  }
};

struct Moments {  // [x, y, z, xx, yy, zz, xy, xz, yz, float(m)]
  static constexpr int kCols = 10;
  const float* p;  // (B, n, 3)
  const unsigned char* m;
  __device__ __forceinline__ void entry(long long b, long long n,
                                        long long i, int, int,
                                        float* dst) const {
    const long long k = b * n + i;
    const float x = __ldg(p + 3 * k);
    const float y = __ldg(p + 3 * k + 1);
    const float z = __ldg(p + 3 * k + 2);
    dst[0] = x;
    dst[1] = y;
    dst[2] = z;
    // _outer6's products: p's component first.
    dst[3] = __fmul_rn(x, x);
    dst[4] = __fmul_rn(y, y);
    dst[5] = __fmul_rn(z, z);
    dst[6] = __fmul_rn(x, y);
    dst[7] = __fmul_rn(x, z);
    dst[8] = __fmul_rn(y, z);
    dst[9] = __ldg(m + k) != 0 ? 1.0f : 0.0f;
  }
};

// A block's 256 entries (one level-1 row: 16 rows of 16) of its dg
// columns in shared memory: entry e, column d at row_at(e / 16) + (e %
// 16) * dg + d, each row of 16 padded by dg floats, so the threads of a
// warp on (row, column) pairs hit distinct banks.
__device__ __forceinline__ int row_at(int r, int dg) { return r * 17 * dg; }

// Stage the block's entries (+0.0 past the column's end), the sources
// read once; a thread takes kBlockLen / kS2Threads entries, their loads
// issued together.
template <class Cols>
__device__ __forceinline__ void stage(const Cols& cols, float* sm,
                                      long long b, long long n, long long g,
                                      int d0, int dg) {
#pragma unroll
  for (int e = threadIdx.x; e < kBlockLen; e += kS2Threads) {
    const long long i = g * kBlockLen + e;
    float* dst = sm + row_at(e / kBase, dg) + (e % kBase) * dg;
    if (i < n) {
      cols.entry(b, n, i, d0, dg, dst);
    } else {
      for (int d = 0; d < dg; ++d) dst[d] = 0.0f;
    }
  }
}

// T_1 of the block's 16 rows into t1[r * dg + d] (+0.0 for rows past the
// column's end).
__device__ __forceinline__ void row_totals(const float* sm, float* t1,
                                           long long g, long long L1,
                                           int dg) {
  for (int task = threadIdx.x; task < kBase * dg; task += kS2Threads) {
    const int r = task / dg;
    const int d = task - r * dg;
    float s = 0.0f;
    if (g * kBase + r < L1) {
      const float* q = sm + row_at(r, dg) + d;
#pragma unroll
      for (int c = 0; c < kBase; ++c) s = __fadd_rn(s, q[c * dg]);
    }
    t1[task] = s;
  }
}

// The top level (m <= 16 entries, ``stride`` apart): its sequential prefix
// sums from +0.0, or the entry itself for a scan of one entry. In place.
__device__ __forceinline__ void top_scan(float* t, long long m, int stride) {
  if (m == 1) return;
  float s = 0.0f;
  for (long long c = 0; c < m; ++c) {
    s = __fadd_rn(s, t[c * stride]);
    t[c * stride] = s;
  }
}

// Launch 1: T_2[g], the level-1 row's total, a column, into the scratch.
template <class Cols>
__global__ void __launch_bounds__(kS2Threads)
prefix16_up_kernel(Cols cols, float* __restrict__ scratch, long long n,
                   long long groups, int D, long long stride) {
  extern __shared__ float smem[];
  const long long b = blockIdx.x / groups;
  const long long g = blockIdx.x % groups;
  const int d0 = blockIdx.y * kGroup;
  const int dg = Cols::kCols ? Cols::kCols : min(kGroup, D - d0);
  float* sm = smem;                 // the entries
  float* t1 = sm + kBase * 17 * dg;  // T_1
  stage(cols, sm, b, n, g, d0, dg);
  __syncthreads();
  row_totals(sm, t1, g, up16(n), dg);
  __syncthreads();
  if (threadIdx.x < dg) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kBase; ++r) s = __fadd_rn(s, t1[r * dg + threadIdx.x]);
    scratch[(b * D + d0 + threadIdx.x) * stride + g] = s;
  }
}

// Launch 2: levels 2..K of one (b, column), a block a column, in its
// scratch: T_2 at [0, L2) read, level 2's output written at [L2, 2 L2),
// levels 3..K after it, each scanned up and then brought down in place.
__global__ void __launch_bounds__(kS2Threads)
prefix16_top_kernel(float* scratch, long long n, long long stride) {
  long long len[kMaxLevels];
  const int K = levels(n, len);
  float* col = scratch + blockIdx.x * stride;
  long long off[kMaxLevels];
  off[2] = 0;
  off[3] = 2 * len[2];
  for (int k = 4; k <= K; ++k) off[k] = off[k - 1] + len[k - 1];
  for (int k = 2; k < K; ++k) {  // T_{k+1}
    const float* in = col + off[k];
    for (long long r = threadIdx.x; r < len[k + 1]; r += kS2Threads) {
      float s = 0.0f;
      for (int c = 0; c < kBase; ++c) {
        const long long i = r * kBase + c;
        s = __fadd_rn(s, i < len[k] ? in[i] : 0.0f);
      }
      col[off[k + 1] + r] = s;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {  // the top level; at K = 2, into level 2's output
    float* top = K == 2 ? col + len[2] : col + off[K];
    for (long long c = 0; K == 2 && c < len[2]; ++c) top[c] = col[c];
    top_scan(top, len[K], 1);
  }
  __syncthreads();
  for (int k = K - 1; k >= 2; --k) {  // level k's output
    const float* in = col + off[k];
    float* out = k == 2 ? col + len[2] : col + off[k];
    const float* above = col + off[k + 1];
    for (long long r = threadIdx.x; r < len[k + 1]; r += kS2Threads) {
      const float e = r == 0 ? 0.0f : above[r - 1];
      float s = 0.0f;
      for (long long i = r * kBase; i < r * kBase + kBase && i < len[k];
           ++i) {
        s = __fadd_rn(s, in[i]);
        out[i] = __fadd_rn(s, e);
      }
    }
    __syncthreads();
  }
}

// Launch 3 (the only one where level 1 is the top): the level-1 row g's
// outputs in shared memory, then its 256 level-0 outputs into out (B, n,
// D), staged in shared memory and written by neighbouring threads.
template <class Cols>
__global__ void __launch_bounds__(kS2Threads)
prefix16_down_kernel(Cols cols, float* __restrict__ out,
                     const float* __restrict__ scratch, long long n,
                     long long groups, int D, long long stride) {
  extern __shared__ float smem[];
  const long long b = blockIdx.x / groups;
  const long long g = blockIdx.x % groups;
  const int d0 = blockIdx.y * kGroup;
  const int dg = Cols::kCols ? Cols::kCols : min(kGroup, D - d0);
  float* sm = smem;                      // the entries
  float* o1 = sm + kBase * 17 * dg;      // T_1, then level 1's output
  float* e_first = o1 + kBase * dg;      // E of the block's first row
  const long long L1 = up16(n);
  stage(cols, sm, b, n, g, d0, dg);
  __syncthreads();
  if (n <= kBase) {  // the input is the top level
    if (threadIdx.x < dg) top_scan(sm + threadIdx.x, n, dg);
  } else {
    row_totals(sm, o1, g, L1, dg);
    __syncthreads();
    if (threadIdx.x < dg) {
      const int d = threadIdx.x;
      if (L1 <= kBase) {  // level 1 is the top
        top_scan(o1 + d, L1, dg);
      } else {
        // Level 2's entries and outputs of this column.
        const float* c = scratch + (b * D + d0 + d) * stride;
        const long long L2 = up16(L1);
        const float e = g == 0 ? 0.0f : __ldg(c + L2 + g - 1);
        float s = 0.0f;
#pragma unroll
        for (int r = 0; r < kBase; ++r) {
          s = __fadd_rn(s, o1[r * dg + d]);
          o1[r * dg + d] = __fadd_rn(s, e);
        }
        // The previous level-1 row's last output: its total T_2 plus its
        // E, level 2's output before it.
        if (g > 0)
          e_first[d] = __fadd_rn(__ldg(c + g - 1),
                                 g == 1 ? 0.0f : __ldg(c + L2 + g - 2));
      }
    }
    __syncthreads();
    for (int task = threadIdx.x; task < kBase * dg; task += kS2Threads) {
      const int r = task / dg;
      const int d = task - r * dg;
      const long long rg = g * kBase + r;
      if (rg >= L1) continue;
      const float e = rg == 0 ? 0.0f : r > 0 ? o1[(r - 1) * dg + d]
                                             : e_first[d];
      float* q = sm + row_at(r, dg) + d;
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < kBase; ++c) {
        s = __fadd_rn(s, q[c * dg]);
        q[c * dg] = __fadd_rn(s, e);
      }
    }
  }
  __syncthreads();
  const long long i0 = g * kBlockLen;
  const int len = (int)min((long long)kBlockLen, n - i0);
  for (int k = threadIdx.x; k < len * dg; k += kS2Threads) {
    const int e = k / dg;
    const int d = k - e * dg;
    out[(b * n + i0 + e) * D + d0 + d] =
        sm[row_at(e / kBase, dg) + (e % kBase) * dg + d];
  }
}

template <class Cols>
int prefix_sum16(const Cols& cols, float* out, float* scratch, long long B,
                 long long n, long long D, cudaStream_t s) {
  if (B <= 0 || n <= 0 || D <= 0) return 0;
  const long long groups = up16(up16(n));  // level-1 rows, a block each
  const long long col_groups = (D + kGroup - 1) / kGroup;
  if (B * groups > INT_MAX || col_groups > 65535 || B * D > INT_MAX ||
      (Cols::kCols && D != Cols::kCols))
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(B * groups), (unsigned)col_groups);
  const long long stride = scratch_floats(n);
  // Shared memory for the widest column group: its entries, T_1 and E.
  const size_t smem = (kBase * 17 + kBase + 1) * sizeof(float) *
                      (size_t)(D < kGroup ? D : kGroup);
  cudaError_t err;
  if (stride > 0) {
    prefix16_up_kernel<Cols><<<grid, kS2Threads, smem, s>>>(
        cols, scratch, n, groups, (int)D, stride);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    prefix16_top_kernel<<<(unsigned)(B * D), kS2Threads, 0, s>>>(scratch, n,
                                                                 stride);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  prefix16_down_kernel<Cols><<<grid, kS2Threads, smem, s>>>(
      cols, out, scratch, n, groups, (int)D, stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of S1's scratch for ``rows`` rows of n entries: a total a tile,
// 8 bytes each (none for rows of one tile).
long long fccf_scan_scratch_bytes(long long rows, long long n) {
  const long long tiles = scan_tiles(n);
  return tiles <= 1 ? 0 : 8 * rows * tiles;
}

// S1 over rows of n entries, row r at x + r * row_stride entries (each row
// contiguous); out is (rows, n) contiguous: int64 for op kSum, else the
// input type. Bool input only for kSum.
int fccf_scan_int(const void* x, void* out, void* totals, int op,
                  int in_type, long long rows, long long n,
                  long long row_stride, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (rows <= 0 || n <= 0) return 0;
  if (op == kSum && in_type == kBool)
    return scan_int<kSum, unsigned char, long long>(x, out, totals, rows, n,
                                                    row_stride, s);
  if (op == kSum && in_type == kInt32)
    return scan_int<kSum, int, long long>(x, out, totals, rows, n,
                                          row_stride, s);
  if (op == kSum && in_type == kInt64)
    return scan_int<kSum, long long, long long>(x, out, totals, rows, n,
                                                row_stride, s);
  if (op == kMax && in_type == kInt32)
    return scan_int<kMax, int, int>(x, out, totals, rows, n, row_stride, s);
  if (op == kMax && in_type == kInt64)
    return scan_int<kMax, long long, long long>(x, out, totals, rows, n,
                                                row_stride, s);
  if (op == kMinReversed && in_type == kInt32)
    return scan_int<kMinReversed, int, int>(x, out, totals, rows, n,
                                            row_stride, s);
  if (op == kMinReversed && in_type == kInt64)
    return scan_int<kMinReversed, long long, long long>(x, out, totals,
                                                        rows, n, row_stride,
                                                        s);
  return (int)cudaErrorInvalidValue;
}

// Floats of S2's scratch a (b, column) of n entries (0 up to one tile).
long long fccf_prefix_sum16_scratch(long long n) { return scratch_floats(n); }

// S2 along dim 1 of x (B, n, D) float32 contiguous into out (the same);
// scratch holds B * D * fccf_prefix_sum16_scratch(n) floats.
int fccf_prefix_sum16(const float* x, float* out, float* scratch,
                      long long B, long long n, long long D,
                      void* stream_ptr) {
  return prefix_sum16(Dense{x, D}, out, scratch, B, n, D,
                      (cudaStream_t)stream_ptr);
}

// S2 of the leaf columns [px w, py w, pz w, ff] of (B, n) sources
// (float32 px, py, pz; bool m, first; contiguous) into out (B, n, 4);
// scratch holds B * 4 * fccf_prefix_sum16_scratch(n) floats.
int fccf_prefix_sum16_leaf(const float* px, const float* py, const float* pz,
                           const unsigned char* m, const unsigned char* first,
                           float* out, float* scratch, long long B,
                           long long n, void* stream_ptr) {
  return prefix_sum16(Leaf{px, py, pz, m, first}, out, scratch, B, n, 4,
                      (cudaStream_t)stream_ptr);
}

// S2 of the moment columns [x, y, z, xx, yy, zz, xy, xz, yz, float(m)] of
// p (B, n, 3) float32 and m (B, n) bool, contiguous, into out (B, n, 10);
// scratch holds B * 10 * fccf_prefix_sum16_scratch(n) floats.
int fccf_prefix_sum16_moments(const float* p, const unsigned char* m,
                              float* out, float* scratch, long long B,
                              long long n, void* stream_ptr) {
  return prefix_sum16(Moments{p, m}, out, scratch, B, n, 10,
                      (cudaStream_t)stream_ptr);
}

}  // extern "C"
