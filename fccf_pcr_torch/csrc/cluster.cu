// The cluster stage's two sequential loops, for Hopper (sm_90a).
//
// Neither replaces a Pallas kernel: they are the device loops that the
// JAX package's compiled program runs inside fccf_pcr_tpu/cluster/cluster.py
// and that the port ran on the host, one host sync each.
//
// - cluster_block_seeds_kernel (C1) replaces the intra-block greedy
//   fixpoint, the lax.while_loop at fccf_pcr_tpu/cluster/cluster.py:157:
//
//     s[i] = elig[i] AND NOT any(j < i: s[j] AND sub_lower[j, i])
//
//   for one block of B <= 512 hypotheses of each (pair, type) lane.
//   sub_lower is strictly lower triangular ([j, i] only for j < i), so
//   the system has one solution, which the JAX loop reaches by Jacobi
//   iteration within B rounds and a pass in index order computes
//   directly.
// - cluster_floor_walk_kernel (C2) replaces the adaptive floor walk, the
//   lax.scan at fccf_pcr_tpu/cluster/cluster.py:260 (the reference's
//   FCCF.cpp:1126-1229), over the clusters of each lane sorted by size,
//   with the scan's float32 comparisons.
//
// Layout: sub_lower (L, B, B) bool bytes, elig (L, B) bool bytes, seeds
// (L, B) bool bytes; s_size (L, W) float32 (a slot is a seed cluster iff
// its size is > 0), cluster_num (L,) float32, emit (L, W) bool bytes. L is
// every leading dim (pairs x 3 types) flattened.
//
// Bound. Both are sequential chains of data-dependent steps over a few
// dozen lanes (L = 24 at batch 8): neither the bytes (C1 needs the rows of
// its seeds, 512 bytes each; C2 reads each slot it walks once) nor the
// operations come near the card's rates, and the time is the chain's
// latency. The design keeps every step of a chain on-chip:
//
// - C1: one block a lane. Its threads pack the eligible rows of the
//   lane's (B, B) bytes into bits in shared memory (32 KB at B = 512,
//   16-byte loads); then one warp walks the rows in index order, lane l
//   holding the block's coverage of columns 16l..16l+15 as 16 bits. A
//   candidate i is eligible and uncovered; the warp finds the next one
//   with one shuffle and __ffs, ORs its row into the coverage (one shared
//   load a lane) and skips every index that row covers, so a step is a
//   seed, never a row that is not.
// - C2: one block a lane, the lane's sizes staged through shared memory
//   by all threads in chunks, one thread walking each chunk in order and
//   the walk's state (emitted, floor, stop) kept in that thread's
//   registers; the block stops at the chunk where the walk stops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 512;          // B: the seed block of cluster.py
constexpr int kChunks = kMaxBlock / 16;  // 16-column chunks of a row
constexpr int kSeedThreads = 256;
constexpr int kWalkThreads = 256;
constexpr int kWalkChunk = 2048;         // slots staged at a time

// 16 bool bytes at p (columns c0..c0+15 of a row of n) as bits.
__device__ __forceinline__ unsigned pack16(const uint8_t* p, int c0, int n,
                                           bool vec) {
  unsigned bits = 0;
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + c0);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((w[q] >> (8 * b)) & 0xffu) bits |= 1u << (4 * q + b);
  } else {
    for (int b = 0; b < 16 && c0 + b < n; ++b)
      if (p[c0 + b]) bits |= 1u << b;
  }
  return bits;
}

__global__ void __launch_bounds__(kSeedThreads)
cluster_block_seeds_kernel(const uint8_t* __restrict__ sub,
                           const uint8_t* __restrict__ elig,
                           uint8_t* __restrict__ seeds, int B, int vec) {
  __shared__ uint16_t rows[kMaxBlock][kChunks];
  __shared__ uint16_t elig_bits[kChunks];
  const long long lane_id = blockIdx.x;
  const uint8_t* sub_l = sub + lane_id * B * B;
  const uint8_t* elig_l = elig + lane_id * B;
  uint8_t* seeds_l = seeds + lane_id * B;
  const int nc = (B + 15) / 16;
  const int t = threadIdx.x;

  if (t < nc) elig_bits[t] = (uint16_t)pack16(elig_l, 16 * t, B, false);
  __syncthreads();
  // Pack the eligible rows (a seed is eligible; no other row is read).
  for (int idx = t; idx < B * nc; idx += kSeedThreads) {
    const int i = idx / nc, c = idx % nc;
    if ((elig_bits[i >> 4] >> (i & 15)) & 1u)
      rows[i][c] = (uint16_t)pack16(sub_l + (long long)i * B, 16 * c, B, vec);
  }
  __syncthreads();
  if (t >= 32) return;

  const unsigned full = 0xffffffffu;
  const int l = t;  // this lane's 16 columns: chunk l
  unsigned cov = 0, mine = 0;
  const unsigned my_elig = l < nc ? elig_bits[l] : 0u;
  for (int c = 0; c < nc; ++c) {
    unsigned cand = __shfl_sync(full, my_elig, c) &
                    ~__shfl_sync(full, cov, c);
    unsigned s = 0;
    while (cand) {
      const int b = __ffs(cand) - 1;
      s |= 1u << b;
      if (l < nc) cov |= rows[16 * c + b][l];
      cand &= ~__shfl_sync(full, cov, c) & ~((2u << b) - 1u);
    }
    if (l == c) mine = s;
  }
  for (int b = 0; b < 16 && 16 * l + b < B; ++b)
    seeds_l[16 * l + b] = (uint8_t)((mine >> b) & 1u);
}

__global__ void __launch_bounds__(kWalkThreads)
cluster_floor_walk_kernel(const float* __restrict__ s_size,
                          const float* __restrict__ cluster_num,
                          uint8_t* __restrict__ emit, int W) {
  __shared__ float sz[kWalkChunk];
  __shared__ uint8_t out[kWalkChunk];
  __shared__ int stopped;
  const long long lane_id = blockIdx.x;
  const float* size_l = s_size + lane_id * W;
  uint8_t* emit_l = emit + lane_id * W;
  const int t = threadIdx.x;

  // The scan's carry, in thread 0's registers: (emitted, floor, stop).
  const float cn = cluster_num[lane_id];
  const float half = cn / 2.0f;
  int emitted = 0;
  float floor_ = 0.0f;
  if (t == 0) {
    const float s0 = size_l[0];
    floor_ = 0.0f > s0 ? 0.0f : s0;  // jnp.maximum(s_size[0], 0.0)
    stopped = 0;
  }
  __syncthreads();
  int c0 = 0;
  for (; c0 < W && !stopped; c0 += kWalkChunk) {
    const int n = W - c0 < kWalkChunk ? W - c0 : kWalkChunk;
    for (int i = t; i < n; i += kWalkThreads) {
      sz[i] = size_l[c0 + i];
      out[i] = 0;
    }
    __syncthreads();
    if (t == 0) {
      bool stop = false;
      for (int i = 0; i < n && !stop; ++i) {
        const float x = sz[i];
        if (!(x > 0.0f)) continue;  // not a seed: the carry is unchanged
        if (x >= floor_) {
          out[i] = 1;
          ++emitted;
          stop = (float)emitted > cn;  // break after push (:1208-1211)
        } else if ((float)emitted < half) {
          floor_ = floor_ - 1.0f;
          stop = floor_ < 2.0f;
        } else {
          stop = true;
        }
      }
      stopped = stop;
    }
    __syncthreads();
    for (int i = t; i < n; i += kWalkThreads) emit_l[c0 + i] = out[i];
    __syncthreads();
  }
  for (int i = c0 + t; i < W; i += kWalkThreads) emit_l[i] = 0;
}

}  // namespace

// The greedy seeds of one block of B <= 512 for L lanes on `stream`.
// Returns cudaGetLastError() of the launch (0 = launched).
extern "C" int fccf_cluster_block_seeds(const void* sub_lower,
                                        const void* elig, void* seeds, int L,
                                        int B, void* stream) {
  if (L <= 0 || B <= 0 || B > kMaxBlock) return (int)cudaErrorInvalidValue;
  const int vec = (B % 16 == 0) &&
                  ((uintptr_t)sub_lower % 16 == 0);
  cluster_block_seeds_kernel<<<L, kSeedThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sub_lower, (const uint8_t*)elig, (uint8_t*)seeds, B,
      vec);
  return (int)cudaGetLastError();
}

// The floor walk's emit mask over W sorted slots for L lanes on `stream`.
// Returns cudaGetLastError() of the launch (0 = launched).
extern "C" int fccf_cluster_floor_walk(const void* s_size,
                                       const void* cluster_num, void* emit,
                                       int L, int W, void* stream) {
  if (L <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cluster_floor_walk_kernel<<<L, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const float*)s_size, (const float*)cluster_num, (uint8_t*)emit, W);
  return (int)cudaGetLastError();
}
