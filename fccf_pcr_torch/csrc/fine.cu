// Fine verify's per-candidate join on Hopper (sm_90a), with a plain C
// interface bound with ctypes by fccf_pcr_torch/ops/fine_kernels.py. It
// replaces no Pallas kernel: the JAX package's compiled program joins each
// candidate's transformed cloud with its pair's table
// (fccf_pcr_tpu/verify/fine.py:138 fine_verify: the join sort at :193-194,
// the run ends' cummin at :202, the sum at :216) as fused XLA loops, where
// the port sorted (P, C, Vf + M) int64 join rows and ran some 200 PyTorch
// kernels a step.
//
// The table of a pair holds its cloud's sorted unique voxel keys in its R
// occupied slots, then the sentinel, and each key's point count s. In the
// sorted join [table keys (label 0) ++ a candidate's keys (label 1)] the
// run of occupied slot i starts at place
//     p_i = i + sum_{j < i} (hit[j] + below[j]) + below[i]
// (the i table entries before it and the candidate's keys of lower cells)
// and holds hit[i] of the candidate's keys besides the table entry: hit[i]
// counts the keys equal to key i, below[i] those between keys i - 1 and i.
// Only these runs can score, so a candidate's join is a lookup and two
// counts a slot; nothing is sorted.
//
// V1, fccf_fine_lookup, a grid of (blocks, P) of 1024 threads, one wave
// of blocks over the card: each block holds its pair's occupied table keys
// in shared memory as 32-bit words (every stride-th key where the table
// has more than kTableSample: the search then ends among the stride - 1
// keys between two held ones, in global memory) and the C candidates'
// poses; a thread takes a target point (tiles of 1024 points round robin
// over the pair's blocks) and, for each candidate, forms the key as
// fine.keys does (the transform in small_matmul's order ((p0 R_r0 + p1
// R_r1) + p2 R_r2) + t_r, the cell floor(x * float32(1 / res)) cast to
// int32 as torch's CUDA cast does, with saturation and NaN to 0, the
// window test, the packing), finds its place by binary search and counts
// it with an integer atomicAdd into hit or below, in global memory: the
// table (128 KB at heritage) and two counters a slot (256 KB more) do not
// fit in one block's shared memory, and the counters of a pair's 12
// candidates are 3 MB. Integer atomics are exact, so the counts are the
// same in any order. A key past the last occupied slot, a masked point and
// a cell outside the window are counted nowhere.
//
// V2, fccf_fine_score, a block a candidate (a grid of (C, P)): an exclusive
// scan of the slots' hit + below in slot order (a run of slots a warp, read 32
// at a time by its lanes, four rounds of loads in flight at once) gives each
// slot's place; a live slot (hit >= 1) has the value (s + t) * min(s, t) /
// max(max(s, t), 1), t = float(hit + 1) - 1, in the plain version's order of
// operations. similar is ops/batch.py's fold_sum over the join's n = Vf + M
// places, +0.0 at every other place: every value is finite and >= 0 and x +
// (+0.0) = x, so fold_sum's first level y[q] = x[q] + x[q + h] (h = n / 2;
// y[h] = x[2h] where n is odd) is formed from the live places alone: each
// writes its value to y[p] (p < h) or y[h] (p = 2h), then, after a barrier,
// y[p - h] = y[p - h] + v (h <= p < 2h). The other levels are fold_sum's on y,
// in shared memory (in the candidate's slice of a global scratch where y is
// longer than kRowFloats). score = similar / max(n_src + count(tar_mask), 1),
// the count exact as torch's float32 sum of the 0/1 mask is below 2^24.
//
// Built with nvcc --fmad=false, no fast math; the float arithmetic is
// written with the _rn intrinsics besides. Bound: V1's operations (33 a
// (candidate, valid point) pair: the transform, the cells, the window;
// for a key in the window 8 more and 2 a search step over the occupied
// keys, ~14 steps at heritage); V2's bytes (the occupied slots' counts,
// the mask, the scores).
//
// Every entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kSentinel = 0xFFFFFFFFu;
constexpr int kLookupThreads = 1024;
constexpr int kScoreThreads = 1024;
constexpr int kScoreWarps = kScoreThreads / 32;
// The table keys a V1 block holds in shared memory: heritage's 32768 all.
constexpr int kTableSample = 32768;
// Dynamic shared memory a block may have on the card, and the level-1 row
// V2 keeps there (the scan's static partials take the rest).
constexpr long long kMaxShared = 232448;
constexpr long long kRowFloats = (kMaxShared - 1024) / 4;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// torch.clamp(v, min=lo) on the card: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// ops/voxelize.py's cell_index of one coordinate: floor(x * inv) and
// torch's CUDA float -> int32 cast (cvt.rzi: saturating, NaN -> 0).
__device__ __forceinline__ int cell_of(float x, float inv) {
  return __float2int_rz(floorf(mul(x, inv)));
}

// The place of `key` among the table's Vf keys (the count of keys below
// it), from the keys held in shared memory (keys 0, stride, 2 stride, ...
// up to the first sentinel; S of them) and, where stride > 1, the keys
// between two held ones.
__device__ __forceinline__ int table_place(const unsigned* held, int S,
                                           int stride,
                                           const long long* keys, int Vf,
                                           unsigned key) {
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (held[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (stride == 1 || lo == 0) return lo * stride;
  int idx = (lo - 1) * stride + 1;
  const int end = min(lo * stride, Vf);
  while (idx < end && (unsigned)keys[idx] < key) ++idx;
  return idx;
}

// V1 over pair blockIdx.y's target points: tiles of 1024 points round
// robin over the pair's gridDim.x blocks (the residual's valid points come
// first, so chunks in order would leave the last blocks idle).
__global__ void __launch_bounds__(kLookupThreads)
    fine_lookup_kernel(const float* __restrict__ T,
                       const float* __restrict__ pts,
                       const unsigned char* __restrict__ mask,
                       const long long* __restrict__ keys,
                       const int* __restrict__ cmin,
                       const int* __restrict__ cmax, int* __restrict__ hit,
                       int* __restrict__ below, int C, long long M, int Vf,
                       int stride, int S, float inv) {
  extern __shared__ unsigned held[];  // S keys, then the C poses
  __shared__ int occupied;  // the held keys before the first sentinel
  float* pose = reinterpret_cast<float*>(held + S);
  const long long b = blockIdx.y;
  const long long* K = keys + b * Vf;
  if (threadIdx.x == 0) occupied = S;
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const unsigned k = (unsigned)K[(long long)j * stride];
    if (k == kSentinel) {  // the sentinels are the table's last slots
      atomicMin(&occupied, j);
      break;
    }
    held[j] = k;
  }
  // Rows 0-2 of each candidate's 4 x 4 transform: R_r0, R_r1, R_r2, t_r.
  for (int j = threadIdx.x; j < C * 12; j += blockDim.x)
    pose[j] = T[(b * C + j / 12) * 16 + j % 12];
  int lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    lo[a] = cmin[b * 3 + a];
    hi[a] = cmax[b * 3 + a];
  }
  __syncthreads();
  const int S_occ = occupied;

  for (long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x; m < M;
       m += (long long)gridDim.x * blockDim.x) {
    if (!mask[b * M + m]) continue;
    const float* p = pts + (b * M + m) * 3;
    const float p0 = p[0], p1 = p[1], p2 = p[2];
    for (int c = 0; c < C; ++c) {
      const float* R = pose + c * 12;
      int cell[3];
      bool inside = true;
      for (int r = 0; r < 3; ++r) {
        const float x = add(add(add(mul(p0, R[r * 4]), mul(p1, R[r * 4 + 1])),
                                mul(p2, R[r * 4 + 2])),
                            R[r * 4 + 3]);
        cell[r] = cell_of(x, inv);
        inside = inside && cell[r] >= lo[r] && cell[r] <= hi[r];
      }
      if (!inside) continue;
      const unsigned key = ((unsigned)(cell[0] & 1023) << 20) |
                           ((unsigned)(cell[1] & 1023) << 10) |
                           (unsigned)(cell[2] & 1023);
      const int idx = table_place(held, S_occ, stride, K, Vf, key);
      if (idx >= Vf) continue;
      const int j = idx / stride;
      const unsigned at = idx % stride != 0 ? (unsigned)K[idx]
                          : j < S_occ       ? held[j]
                                            : kSentinel;
      if (at == kSentinel) continue;  // past the last occupied slot
      atomicAdd((at == key ? hit : below) + (b * C + c) * Vf + idx, 1);
    }
  }
}

// Inclusive scan of v over a warp's lanes in lane order.
__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive scan of v over the block's threads in thread order; *total is
// the block's sum. Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kScoreWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) warp_sums[lane] = warp_inclusive_scan(warp_sums[lane]);
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kScoreWarps - 1];
  __syncthreads();  // warp_sums is free for the next call
  return before;
}

// A live slot's value: (s + t) * min(s, t) / clamp(max(s, t), min=1).
__device__ __forceinline__ float run_value(float s, int h) {
  const float t = __fsub_rn(__int2float_rn(h + 1), 1.0f);
  return __fdiv_rn(mul(add(s, t), fminf(s, t)), clamp_min(fmaxf(s, t), 1.0f));
}

// V2 for candidate blockIdx.x of pair blockIdx.y. h = n / 2 and
// width = h + n % 2, the length of fold_sum's first level. A warp takes a
// run of slots, 32 at a time (neighbouring lanes on neighbouring slots).
// The counts are below 2^24 (a candidate's keys), the places below 2^31.
__global__ void __launch_bounds__(kScoreThreads)
    fine_score_kernel(const int* __restrict__ hit,
                      const int* __restrict__ below,
                      const float* __restrict__ counts,
                      const float* __restrict__ n_src,
                      const unsigned char* __restrict__ mask,
                      float* __restrict__ score, float* scratch, int C,
                      long long M, int Vf, long long h, long long width) {
  extern __shared__ float row[];
  const long long b = blockIdx.y;
  const long long cand = b * C + blockIdx.x;
  const int* H = hit + cand * Vf;
  const int* B = below + cand * Vf;
  const float* s_cnt = counts + b * Vf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = (Vf + kScoreWarps - 1) / kScoreWarps;
  const int w0 = min(Vf, warp * seg), w1 = min(Vf, w0 + seg);

  // The candidate's keys before the warp's first slot.
  int run = 0;
  for (int i = w0 + lane; i < w1; i += 32) run += H[i] + B[i];
  for (int o = 16; o > 0; o >>= 1) run += __shfl_xor_sync(0xffffffffu, run, o);
  int keys;
  const int first = __shfl_sync(
      0xffffffffu, block_exclusive_scan(lane == 0 ? run : 0, &keys), 0);
  int cnt = 0;
  for (long long m = threadIdx.x; m < M; m += blockDim.x)
    cnt += mask[b * M + m];
  int valid;
  block_exclusive_scan(cnt, &valid);

  float* y = scratch != nullptr ? scratch + cand * width : row;
  for (long long q = threadIdx.x; q < width; q += blockDim.x) y[q] = 0.0f;
  __syncthreads();
  // fold_sum's first level from the live places: the left operands (and
  // the odd carry) first, then the right ones added to them.
  for (int pass = 0; pass < 2; ++pass) {
    int before = first;
    for (int i0 = w0; i0 < w1; i0 += 4 * 32) {
      int hv[4], bv[4];  // four rounds' loads in flight at once
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u + lane;
        hv[u] = i < w1 ? H[i] : 0;
        bv[u] = i < w1 ? B[i] : 0;
      }
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u + lane, hi = hv[u];
        const int incl = warp_inclusive_scan(hi + bv[u]);
        // i table entries, the keys of the slots before i and i's below.
        const long long p = (long long)i + before + incl - hi;
        before += __shfl_sync(0xffffffffu, incl, 31);
        if (hi < 1) continue;
        if (pass == 0 && p < h)
          y[p] = run_value(s_cnt[i], hi);
        else if (pass == 0 && p == 2 * h)
          y[h] = run_value(s_cnt[i], hi);
        else if (pass == 1 && p >= h && p < 2 * h)
          y[p - h] = add(y[p - h], run_value(s_cnt[i], hi));
      }
    }
    __syncthreads();
  }
  // fold_sum's other levels.
  for (long long L = width; L > 1;) {
    const long long half = L >> 1;
    for (long long q = threadIdx.x; q < half; q += blockDim.x)
      y[q] = add(y[q], y[q + half]);
    __syncthreads();
    if (L & 1) {
      if (threadIdx.x == 0) y[half] = y[2 * half];
      __syncthreads();
    }
    L = half + (L & 1);
  }
  if (threadIdx.x == 0) {
    const float total = add(n_src[b], (float)valid);
    score[cand] = __fdiv_rn(y[0], clamp_min(total, 1.0f));
  }
}

// Raises the block's dynamic shared memory where it needs more than 48 KB.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, long long bytes) {
  if (bytes > kMaxShared) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// The longest first level of fold_sum V2 keeps in shared memory, in
// floats; a longer one takes a global scratch of width floats a candidate.
long long fccf_fine_row_floats() { return kRowFloats; }

// V1 over P pairs of C candidates: T (P, C, 4, 4), tar_pts (P, M, 3)
// float32, tar_mask (P, M) bool, the table's keys (P, Vf) int64 (sorted,
// sentinel 0xFFFFFFFF past the occupied slots), cell_min and cell_max
// (P, 3) int32, inv = float32(1 / fine_voxel); hit and below (P, C, Vf)
// int32, zero on entry, are counted into.
int fccf_fine_lookup(const void* T, const void* pts, const void* mask,
                     const void* keys, const void* cmin, const void* cmax,
                     void* hit, void* below, long long P, int C, long long M,
                     int Vf, float inv, void* stream) {
  if (P <= 0 || C <= 0 || M <= 0 || Vf <= 0) return 0;
  if (P > 65535) return (int)cudaErrorInvalidValue;
  const int stride = (Vf + kTableSample - 1) / kTableSample;
  const int S = (Vf + stride - 1) / stride;
  const long long bytes = (long long)S * 4 + (long long)C * 12 * 4;
  cudaError_t err = allow_shared(fine_lookup_kernel, bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fine_lookup_kernel, kLookupThreads, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  // One wave of blocks over the pairs, every candidate of a point in one
  // thread (the table is loaded once a block).
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1) / P;
  const long long tiles = (M + kLookupThreads - 1) / kLookupThreads;
  blocks = blocks < 1 ? 1 : (blocks > tiles ? tiles : blocks);
  fine_lookup_kernel<<<dim3((unsigned)blocks, (unsigned)P), kLookupThreads,
                       bytes, (cudaStream_t)stream>>>(
      (const float*)T, (const float*)pts, (const unsigned char*)mask,
      (const long long*)keys, (const int*)cmin, (const int*)cmax, (int*)hit,
      (int*)below, C, M, Vf, stride, S, inv);
  return (int)cudaGetLastError();
}

// V2 over P pairs of C candidates: hit and below (P, C, Vf) int32 (V1's),
// the table's counts (P, Vf) and n_src (P) float32, tar_mask (P, M) bool;
// out score (P, C) float32. scratch: (P, C, width) float32, width =
// (Vf + M + 1) / 2, where width > fccf_fine_row_floats(), else null.
int fccf_fine_score(const void* hit, const void* below, const void* counts,
                    const void* n_src, const void* mask, void* score,
                    void* scratch, long long P, int C, long long M, int Vf,
                    void* stream) {
  if (P <= 0 || C <= 0) return 0;
  const long long n = (long long)Vf + M;
  if (P > 65535 || C > 65535 || Vf <= 0 || M < 0 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long h = n / 2, width = h + n % 2;
  const bool in_shared = width <= kRowFloats;
  if (!in_shared && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long bytes = in_shared ? width * 4 : 0;
  cudaError_t err = allow_shared(fine_score_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  fine_score_kernel<<<dim3((unsigned)C, (unsigned)P), kScoreThreads, bytes,
                      (cudaStream_t)stream>>>(
      (const int*)hit, (const int*)below, (const float*)counts,
      (const float*)n_src, (const unsigned char*)mask, (float*)score,
      in_shared ? nullptr : (float*)scratch, C, M, Vf, h, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
