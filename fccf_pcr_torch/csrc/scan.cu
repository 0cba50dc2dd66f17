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
// ATen's scan gives a row of a many-row scan one block, which walks it in
// chunks of 1024 entries: 16 rows of 245760 ran on 16 of the 132 SMs.
// Here a row is cut into tiles of kTile entries, a block a tile: a first
// launch reduces each tile to its total, a second one gives each block the
// combination of the totals of the tiles before it and scans its tile from
// there, a chunk of kThreads entries at a time (warp shuffles, then the
// warps' totals). Rows of one tile take the second launch alone. Integer
// sums wrap and max / min are exact, so the result equals torch's in any
// order of combination. Bound: the bytes, each entry read once and written
// once; the design reads each entry twice (once a launch).
//
// S2, fccf_prefix_sum16: the float32 inclusive prefix sum along dim 1 of a
// contiguous (B, n, D) tensor in the association of XLA's cumsum on the
// CPU (the reference's goldens; jnp.cumsum at fccf_pcr_tpu/ops/voxelize.py
// :143, :530 and :584), bit for bit equal to the port's plain version
// (ops/scan.py::_prefix_sum0): level k's entries T_k (T_0 the input) are
// cut into rows of 16; a row's prefixes P are sequential sums from +0.0
// (entries past the end add +0.0, as the plain version's padding); the row
// totals, T_{k+1}, are scanned the same way, up to a level of at most 16
// entries, which is one such row (one entry: returned as it is); then each
// level's output is P + E, E the previous row's output one level up (+0.0
// for the first row: -0.0 + 0.0 is +0.0, so the zero is added, never
// skipped). One launch a level up (T_k -> T_{k+1}), one for the top level
// and one a level down, a thread a (b, row of 16, d): 2K + 1 launches for
// K levels above the input, in place in the scratch above level 0. D is
// the fastest index of the threads, so a warp reads neighbouring columns.
// The association fixes the order of every add: each entry is one chain of
// its row's adds plus one add a level, so the design can change where the
// adds run, not how many run one after another. Bound: the bytes, the
// input read once and the output written once; level 0 is read twice (up
// and down) and the levels above add about 1/15 of the input.
//
// Every entry launches on the given stream, allocates nothing (the caller
// passes the scratch) and returns cudaGetLastError() after its launches.
// Built with nvcc --fmad=false and no fast math (no add is contracted or
// dropped).

#include <cuda_runtime.h>

#include <climits>

namespace {

// ------------------------------------------------------------------ S1 --

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr long long kTile = 8192;  // entries a block: 16 chunks of kThreads

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

// The combination of every thread's v, in every thread. ``warp_part`` holds
// kWarps entries; the block is synchronized on return.
template <int OP, typename T>
__device__ __forceinline__ T block_combine(T v, T* warp_part) {
  for (int o = 16; o > 0; o >>= 1)
    v = combine<OP>(v, (T)__shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = identity<OP, T>();
  for (int w = 0; w < kWarps; ++w) r = combine<OP>(r, warp_part[w]);
  __syncthreads();
  return r;
}

// Launch 1: totals[row * tiles + tile] = the combination of the tile.
template <int OP, typename In, typename T>
__global__ void __launch_bounds__(kThreads)
scan_tile_reduce_kernel(const In* __restrict__ x, T* __restrict__ totals,
                        long long n, long long row_stride, long long tiles) {
  __shared__ T warp_part[kWarps];
  const long long row = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const In* xr = x + row * row_stride;
  const long long j1 = min(n, (tile + 1) * kTile);
  T v = identity<OP, T>();
  for (long long j = tile * kTile + threadIdx.x; j < j1; j += kThreads)
    v = combine<OP>(v, (T)xr[position<OP>(n, j)]);
  v = block_combine<OP>(v, warp_part);
  if (threadIdx.x == 0) totals[blockIdx.x] = v;
}

// Launch 2: the tile's inclusive scan, from the combination of the totals
// of the tiles before it.
template <int OP, typename In, typename T>
__global__ void __launch_bounds__(kThreads)
scan_tile_apply_kernel(const In* __restrict__ x, T* __restrict__ out,
                       const T* __restrict__ totals, long long n,
                       long long row_stride, long long tiles) {
  __shared__ T warp_part[kWarps];
  const long long row = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T carry = identity<OP, T>();
  for (long long t = threadIdx.x; t < tile; t += kThreads)
    carry = combine<OP>(carry, totals[row * tiles + t]);
  carry = block_combine<OP>(carry, warp_part);
  const In* xr = x + row * row_stride;
  T* outr = out + row * n;
  const long long j1 = min(n, (tile + 1) * kTile);
  for (long long base = tile * kTile; base < j1; base += kThreads) {
    const long long j = base + threadIdx.x;
    T v = j < j1 ? (T)xr[position<OP>(n, j)] : identity<OP, T>();
    for (int o = 1; o < 32; o <<= 1) {
      const T u = (T)__shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = combine<OP>(u, v);
    }
    if (lane == 31) warp_part[warp] = v;
    __syncthreads();
    T before = carry;
    T after = carry;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before = combine<OP>(before, warp_part[w]);
      after = combine<OP>(after, warp_part[w]);
    }
    if (j < j1) outr[position<OP>(n, j)] = combine<OP>(before, v);
    carry = after;
    __syncthreads();
  }
}

template <int OP, typename In, typename T>
int scan_int(const void* x, void* out, void* totals, long long rows,
             long long n, long long row_stride, cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
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

constexpr int kS2Threads = 256;
constexpr int kBase = 16;
constexpr int kMaxLevels = 24;

// lens[0] = n, lens[k + 1] = ceil(lens[k] / 16) while lens[k] > 16;
// returns K, the number of levels above the input.
int levels(long long n, long long* lens) {
  int K = 0;
  lens[0] = n;
  while (lens[K] > kBase) {
    lens[K + 1] = (lens[K] + kBase - 1) / kBase;
    ++K;
  }
  return K;
}

__device__ __forceinline__ bool thread_of(long long count, long long* t) {
  *t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  return *t < count;
}

// T_{k+1}[b, r, d]: the sequential sum from +0.0 of T_k[b, 16 r + c, d],
// c = 0..15 (+0.0 past the level's end).
__global__ void __launch_bounds__(kS2Threads)
prefix16_up_kernel(const float* __restrict__ in, float* __restrict__ up,
                   long long B, long long len, long long len_up,
                   long long D) {
  long long t;
  if (!thread_of(B * len_up * D, &t)) return;
  const long long d = t % D;
  const long long r = (t / D) % len_up;
  const long long b = t / (D * len_up);
  const float* p = in + (b * len + kBase * r) * D + d;
  float s = 0.0f;
  if (kBase * r + kBase <= len) {
#pragma unroll
    for (int c = 0; c < kBase; ++c) s = s + __ldg(p + c * D);
  } else {
    for (int c = 0; c < kBase; ++c)
      s = s + (kBase * r + c < len ? __ldg(p + c * D) : 0.0f);
  }
  up[t] = s;
}

// The top level (len <= 16 entries a column): its sequential prefix sums
// from +0.0, or the entry itself for a scan of one entry. In place when
// in == out.
__global__ void __launch_bounds__(kS2Threads)
prefix16_top_kernel(const float* in, float* out, long long B, long long len,
                    long long D) {
  long long t;
  if (!thread_of(B * D, &t)) return;
  const long long d = t % D;
  const long long b = t / D;
  const long long base = b * len * D + d;
  if (len == 1) {
    out[base] = in[base];
    return;
  }
  float s = 0.0f;
  for (long long c = 0; c < len; ++c) {
    s = s + in[base + c * D];
    out[base + c * D] = s;
  }
}

// A level's output from its row prefixes and the level above's output:
// out[b, 16 r + c, d] = P + E, E = +0.0 for r = 0, else up_out[b, r - 1, d].
// In place when in == out (a thread reads each entry before it writes it).
__global__ void __launch_bounds__(kS2Threads)
prefix16_down_kernel(const float* in, float* out,
                     const float* __restrict__ up_out, long long B,
                     long long len, long long len_up, long long D) {
  long long t;
  if (!thread_of(B * len_up * D, &t)) return;
  const long long d = t % D;
  const long long r = (t / D) % len_up;
  const long long b = t / (D * len_up);
  const float e = r == 0 ? 0.0f : up_out[t - D];
  const long long base = (b * len + kBase * r) * D + d;
  const float* p = in + base;
  float* q = out + base;
  float s = 0.0f;
  if (kBase * r + kBase <= len) {
    float v[kBase];
#pragma unroll
    for (int c = 0; c < kBase; ++c) v[c] = p[c * D];
#pragma unroll
    for (int c = 0; c < kBase; ++c) {
      s = s + v[c];
      q[c * D] = s + e;
    }
  } else {
    for (int c = 0; kBase * r + c < len; ++c) {
      s = s + p[c * D];
      q[c * D] = s + e;
    }
  }
}

unsigned grid(long long threads) {
  return (unsigned)((threads + kS2Threads - 1) / kS2Threads);
}

}  // namespace

extern "C" {

// Tiles of S1 a row of n entries (the totals buffer holds rows x tiles
// entries of 8 bytes where this is above 1).
long long fccf_scan_tiles(long long n) { return (n + kTile - 1) / kTile; }

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
    return scan_int<kMinReversed, long long, long long>(x, out, totals, rows,
                                                        n, row_stride, s);
  return (int)cudaErrorInvalidValue;
}

// Floats of S2's scratch a (b, d) column: the entries of every level above
// the input.
long long fccf_prefix_sum16_scratch(long long n) {
  long long lens[kMaxLevels];
  const int K = levels(n, lens);
  long long total = 0;
  for (int k = 1; k <= K; ++k) total += lens[k];
  return total;
}

// S2 along dim 1 of x (B, n, D) float32 contiguous into out (the same);
// scratch holds B * D * fccf_prefix_sum16_scratch(n) floats.
int fccf_prefix_sum16(const float* x, float* out, float* scratch,
                      long long B, long long n, long long D,
                      void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (B <= 0 || n <= 0 || D <= 0) return 0;
  long long lens[kMaxLevels];
  const int K = levels(n, lens);
  if (K == 0) {
    prefix16_top_kernel<<<grid(B * D), kS2Threads, 0, s>>>(x, out, B, n, D);
    return (int)cudaGetLastError();
  }
  // level[k]: T_k (level 0 the input), then level k's output in place.
  float* level[kMaxLevels];
  long long offset = 0;
  for (int k = 1; k <= K; ++k) {
    level[k] = scratch + offset;
    offset += B * lens[k] * D;
  }
  cudaError_t err;
  for (int k = 0; k < K; ++k) {
    prefix16_up_kernel<<<grid(B * lens[k + 1] * D), kS2Threads, 0, s>>>(
        k == 0 ? x : level[k], level[k + 1], B, lens[k], lens[k + 1], D);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  prefix16_top_kernel<<<grid(B * D), kS2Threads, 0, s>>>(
      level[K], level[K], B, lens[K], D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int k = K - 1; k >= 0; --k) {
    prefix16_down_kernel<<<grid(B * lens[k + 1] * D), kS2Threads, 0, s>>>(
        k == 0 ? x : level[k], k == 0 ? out : level[k], level[k + 1], B,
        lens[k], lens[k + 1], D);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
