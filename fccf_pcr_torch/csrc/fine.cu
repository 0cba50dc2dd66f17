// Fine verify's per-candidate join on Hopper (sm_90a), one launch, with a
// plain C interface bound with ctypes by fccf_pcr_torch/ops/fine_kernels.py.
// It replaces no Pallas kernel: the JAX package's compiled program joins
// each candidate's transformed cloud with its pair's table
// (fccf_pcr_tpu/verify/fine.py:138 fine_verify: the keys at :168-177, the
// join sort at :193-194, the run ends' cummin at :202, the sum at :216) as
// fused XLA loops.
//
// The table of a pair holds its cloud's sorted unique voxel keys in its R
// occupied slots, then the sentinel, and each key's point count s. In the
// sorted join [table keys (label 0) ++ a candidate's keys (label 1)] the
// run of occupied slot i starts at place
//     p_i = i + sum_{j < i} (hit[j] + below[j]) + below[i]
// and holds hit[i] of the candidate's keys besides the table entry: hit[i]
// counts the keys equal to key i, below[i] those between keys i - 1 and i.
// Only these runs can score, so a candidate's join is a lookup and two
// counts a slot; nothing is sorted.
//
// fccf_fine_join: a cluster of K blocks of 1024 threads a candidate (grid
// (K, C, P)), K the least of 1, 2, 4, 8 whose share fits in a block's shared
// memory. Nothing of the join goes through device memory but its inputs and
// the score:
//
//  1. The table. Every block finds its pair's R on the card (every
//     ceil(Vf / 1024)-th key, a load a thread, brackets the first sentinel;
//     the bracket's keys and the keys before them place it: the one place
//     that holds the sentinel after a key), loads the R occupied keys once, eight
//     a thread at a time with their loads in flight, and keeps them as
//     16-bit offsets from key 0 in buckets of 2^16 keys (key - key_0 <
//     2^30: at most 2^14 buckets, as many as the keys span), each bucket's
//     first slot held in a 16-bit table (empty buckets filled by a suffix
//     min). A key's place is R past the last key, else its bucket's slot
//     range and a binary search of a few offsets, not ~14 steps over the
//     whole table.
//  2. The counts, in shared memory. Rank r of the cluster owns slots
//     [r S, (r + 1) S), S = ceil(R / K), and holds their hit and below,
//     packed in one 32-bit word (hit low, below high) where a count cannot
//     pass 65535 (M < 65536), else in two words. Only R slots are zeroed.
//     The cluster's lanes take the pair's target points in turn, four
//     neighbouring ones a lane (their mask bytes in one word, their
//     coordinates in three 16-byte loads, two such quads in flight) where
//     M and the pointers allow, else one; each forms the candidate's key as
//     fine.keys does (the transform in small_matmul's order ((p0 R_r0 + p1
//     R_r1) + p2 R_r2) + t_r, the cell floor(x * float32(1 / res)) cast as
//     torch's CUDA cast does, with saturation and NaN to 0, the window
//     test, the packing), finds its place and counts it with an integer
//     atomicAdd into the owning rank's shared memory (distributed shared
//     memory where it is another rank). Integer atomics are exact in any
//     order. The mask is counted on the way.
//  3. The places. Each rank walks its own slots in rounds of kThreads *
//     kSlots, in slot order, kSlots neighbouring slots a thread: a block
//     scan of hit + below (the ranks before it add their sums) gives each
//     slot's place, a live slot (hit >= 1) its value (s + t) * min(s, t) /
//     max(max(s, t), 1), t = float(hit + 1) - 1, in the plain version's
//     order of operations. Values go in place of the counts, in slot
//     order, so the j-th live place's value is the j-th held; rank 0 marks
//     each live place in a bitmap of the join's n = Vf + M places.
//  4. The score. similar is ops/batch.py's fold_sum over the n places,
//     +0.0 at every other place. Its levels have lengths L_0 = n, L_{j+1} =
//     ceil(L_j / 2); level j + 1's entry q is level j's q + (q + L_j / 2)
//     (q < floor(L_j / 2)) or its q + floor(L_j / 2) alone (the odd carry).
//     So the first level no longer than kFoldLevel (level k, k <= 4) has
//     at entry Q the sum of 2^k leaves Q + off[t] in the tree's order,
//     x + y in the tree's pairs (t an odd carry's missing operand where Q
//     >= lim[t]). Every value is finite and >= 0 and x + (+0.0) = x, so
//     rank 0 forms level k from the live places alone, a thread an entry
//     Q: its leaves' bits in the bitmap and the live ones' values, summed
//     in the tree's order; the other levels are fold_sum's, dense in
//     shared memory. score =
//     similar / max(n_src + count(tar_mask), 1), the count exact as
//     torch's float32 sum of the 0/1 mask is below 2^24.
//
// Where a candidate's share fills a block's shared memory (heritage: Vf =
// 32768 packed counts, 128 KB, and the table's 96 KB), K is 1 and the
// launch has one block a candidate; two half blocks a candidate would not
// end sooner, as one SM holds one of them either way.
//
// Where no cluster holds a candidate's share in shared memory (Vf >
// 65535, which 16-bit bucket starts cannot index, or too many bytes: the
// `large` caps, Vf = 65536 and M = 131072, and auto caps' escalation on
// dense scans), the entry takes K = 0: clusters of kScratchCluster blocks
// a candidate as above, but its counts, values, bitmap, words' ranks
// (32-bit) and dense level lie in its slice of a scratch the caller
// allocates (fccf_fine_join_scratch words a candidate), each key's place
// is a binary search of the pair's keys in device memory and each rank
// counts by a global integer atomicAdd. The order of every float
// operation is the one above. Built with nvcc
// --fmad=false, no fast math; the float arithmetic is written with the _rn
// intrinsics besides. Bound: V1's operations (33 a (candidate, valid
// point); for a key in the window 8 more and 2 a search step) against the
// bytes of the points, mask, poses, occupied keys and counts and the
// scores.
//
// The entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kSentinel = 0xFFFFFFFFu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// key - key_0 < 2^30: 2^14 buckets of 2^16 keys, offsets in 16 bits.
constexpr int kBucketShift = 16;
constexpr int kBuckets = 1 << 14;
// The longest level of fold_sum formed densely, in floats, where at most
// kMaxDepth levels above it reach it (a subtree's 16 leaves in registers);
// longer where n > 2^18.
constexpr long long kFoldLevel = 16384;
constexpr int kMaxDepth = 4;
constexpr int kMaxLeaves = 1 << kMaxDepth;
constexpr int kMaxCluster = 8;
// The blocks a candidate where its share lies in the scratch.
constexpr int kScratchCluster = 8;
// Quads of neighbouring points a lane loads at once; slots a thread takes
// in a round of the places.
constexpr int kQuads = 2;
constexpr int kSlots = 8;
// Dynamic shared memory a block may have on the card.
constexpr long long kMaxShared = 232448 - 1024;

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

// A live slot's value: (s + t) * min(s, t) / clamp(max(s, t), min=1).
__device__ __forceinline__ float run_value(float s, int h) {
  const float t = __fsub_rn(__int2float_rn(h + 1), 1.0f);
  return __fdiv_rn(mul(add(s, t), fminf(s, t)), clamp_min(fmaxf(s, t), 1.0f));
}

// Inclusive scans over a warp's lanes in lane order.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive scans of a and b over the block's threads in thread order;
// *ta and *tb are the block's sums. Every thread must call it.
__device__ void block_scan2(int& a, int& b, int* ta, int* tb) {
  __shared__ int sa[kWarps], sb[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xa = warp_scan(a), xb = warp_scan(b);
  if (lane == 31) {
    sa[warp] = xa;
    sb[warp] = xb;
  }
  __syncthreads();
  if (warp == 0) {
    sa[lane] = warp_scan(sa[lane]);
    sb[lane] = warp_scan(sb[lane]);
  }
  __syncthreads();
  a = (warp > 0 ? sa[warp - 1] : 0) + xa - a;
  b = (warp > 0 ? sb[warp - 1] : 0) + xb - b;
  *ta = sa[kWarps - 1];
  *tb = sb[kWarps - 1];
  __syncthreads();  // sa and sb are free for the next call
}

// The shared memory a block holds, in bytes: the counts (then the values)
// of its S_cap slots, then the table's offsets and bucket starts, which
// the fold's bitmap, its words' ranks and the dense level take over once
// the counts are made.
struct Layout {
  long long counts, table, bitmap_words, fold, total;
};

__host__ __device__ inline Layout layout(int Vf, long long n, int K,
                                         bool wide, long long level) {
  Layout l;
  const long long s_cap = (Vf + K - 1) / K;
  l.counts = s_cap * (wide ? 8 : 4);
  l.table = 2LL * Vf + 2LL * (kBuckets + 1);
  l.bitmap_words = (n + 31) / 32;
  l.fold = 4 * l.bitmap_words + ((2 * l.bitmap_words + 3) / 4) * 4 +
           4 * level;
  l.total = l.counts + ((l.table > l.fold ? l.table : l.fold) + 15) / 16 * 16;
  return l;
}

// fold_sum's levels: the length of the first level no longer than
// kFoldLevel, or of level kMaxDepth, and how many levels come before it.
__host__ __device__ inline long long fold_level(long long n, int* depth) {
  long long L = n;
  int k = 0;
  while (L > kFoldLevel && k < kMaxDepth) {
    L = (L >> 1) + (L & 1);
    ++k;
  }
  *depth = k;
  return L;
}

// A candidate's words of the scratch where no cluster holds its share:
// its counts (then values), bitmap, words' ranks and dense level.
__host__ __device__ inline long long scratch_words(int Vf, long long n,
                                                   bool wide) {
  int depth;
  const long long level = fold_level(n, &depth);
  return (long long)Vf * (wide ? 2 : 1) + 2 * ((n + 31) / 32) + level;
}

// fold_sum's level k (k = kDepth levels above the live places), a thread
// an entry Q, so a warp's lanes read neighbouring bitmap bits: its
// subtree's 2^k leaves in the tree's order, in registers, summed x + y in
// the tree's pairs (+0.0 where a leaf is no live place).
template <int kDepth, typename Value>
__device__ __forceinline__ void dense_level(float* y, int level,
                                            const int* off, const int* lim,
                                            Value live_value) {
  int o[1 << kDepth], m[1 << kDepth];
#pragma unroll
  for (int t = 0; t < (1 << kDepth); ++t) {
    o[t] = off[t];
    m[t] = lim[t];
  }
  for (int Q = threadIdx.x; Q < level; Q += kThreads) {
    float v[1 << kDepth];
#pragma unroll
    for (int t = 0; t < (1 << kDepth); ++t)
      v[t] = Q < m[t] ? live_value(Q + o[t]) : 0.0f;
#pragma unroll
    for (int j = 0; j < kDepth; ++j)
#pragma unroll
      for (int t = 0; t < (1 << kDepth); t += 2 << j)
        v[t] = add(v[t], v[t + (1 << j)]);
    y[Q] = v[0];
  }
}

// Candidate blockIdx.y of pair blockIdx.z, rank blockIdx.x of its cluster;
// with kScratch, its share in the `share` words at scratch + cand * share.
template <bool kWide, bool kScratch>
__global__ void __launch_bounds__(kThreads)
    fine_join_kernel(const float* __restrict__ T,
                     const float* __restrict__ pts,
                     const unsigned char* __restrict__ mask,
                     const long long* __restrict__ keys,
                     const float* __restrict__ counts,
                     const float* __restrict__ n_src,
                     const int* __restrict__ cmin,
                     const int* __restrict__ cmax, float* __restrict__ score,
                     unsigned* scratch, long long share, int C, long long M,
                     int Vf, long long n, float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float pose[12];
  __shared__ int lo_cell[3], hi_cell[3];
  // Level k's entry Q holds leaf t of its subtree at Q + leaf_off[t] where
  // Q < leaf_lim[t] (else the leaf is an odd carry's missing operand).
  __shared__ int leaf_off[kMaxLeaves], leaf_lim[kMaxLeaves];
  // This rank's occupied slots, its sums of hit + below and of live
  // slots, and its valid points; then the ranks' live slots before each.
  __shared__ int s_R, s_first, s_valid, s_sum, s_live, s_valid_all;
  __shared__ unsigned s_kmax;
  __shared__ int live_before[kMaxCluster];
  __shared__ long long keys_before;

  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // A cluster of one block needs only a block barrier.
  auto sync = [&] {
    if (K == 1)
      __syncthreads();
    else
      cluster.sync();
  };
  const long long b = blockIdx.z;
  const long long cand = b * C + blockIdx.y;
  const long long* Kb = keys + b * Vf;
  int depth;
  const long long level = fold_level(n, &depth);
  const Layout l = layout(Vf, n, K, kWide, level);
  // A live place's rank among the live places: below R <= Vf.
  using Rank = std::conditional_t<kScratch, unsigned, unsigned short>;
  // kScratch: the candidate's words, hit (| below << 16) of every slot,
  // (kWide) below of every slot, then the bitmap, words' ranks and level.
  unsigned* const slab = kScratch ? scratch + cand * share : nullptr;
  unsigned short* const offs =
      reinterpret_cast<unsigned short*>(smem + l.counts);
  unsigned short* const starts = offs + Vf;
  unsigned* const bitmap =
      kScratch ? slab + (long long)Vf * (kWide ? 2 : 1)
               : reinterpret_cast<unsigned*>(smem + l.counts);
  Rank* const word_rank = reinterpret_cast<Rank*>(bitmap + l.bitmap_words);
  float* const y = reinterpret_cast<float*>(
      kScratch ? bitmap + 2 * l.bitmap_words
               : reinterpret_cast<unsigned*>(
                     smem + l.counts + 4 * l.bitmap_words +
                     ((2 * l.bitmap_words + 3) / 4) * 4));

  // 1. The table.
  if (threadIdx.x < 12) pose[threadIdx.x] = T[cand * 16 + threadIdx.x];
  if (threadIdx.x < 3) {
    lo_cell[threadIdx.x] = cmin[b * 3 + threadIdx.x];
    hi_cell[threadIdx.x] = cmax[b * 3 + threadIdx.x];
  }
  const int stride = (Vf + kThreads - 1) / kThreads;
  const int samples = (Vf + stride - 1) / stride;
  if (threadIdx.x == 0) {
    s_first = samples;
    s_valid = 0;
  }
  if (threadIdx.x < kMaxLeaves) {
    // From the top level down: a right operand adds half the level's
    // length; a left one needs the place below that half.
    long long halves[kMaxDepth], L = n;
    for (int j = 0; j < depth; ++j) {
      halves[j] = L >> 1;
      L = (L >> 1) + (L & 1);
    }
    long long off = 0, lim = 1LL << 30;
    for (int j = depth - 1; j >= 0; --j) {
      if (threadIdx.x >> j & 1)
        off += halves[j];
      else
        lim = halves[j] - off < lim ? halves[j] - off : lim;
    }
    leaf_off[threadIdx.x] = (int)off;
    leaf_lim[threadIdx.x] = (int)lim;
  }
  // R: every stride-th key (a load a thread) brackets the first sentinel
  // (place Vf where there is none); in the bracket, the one place whose
  // key is the sentinel and whose key before is not is R, and that key
  // before is the last occupied one.
  const int sampled = threadIdx.x * stride;
  const unsigned k0 = (unsigned)__ldg(Kb);
  const bool sentinel =
      sampled < Vf && (unsigned)__ldg(Kb + sampled) == kSentinel;
  __syncthreads();
  if (sentinel) atomicMin(&s_first, threadIdx.x);
  __syncthreads();
  const int first = s_first;
  const int from = first == 0 ? 0 : (first - 1) * stride + 1;
  const int to = min(first * stride, Vf);
  for (int i = from + (int)threadIdx.x; i <= to; i += kThreads) {
    // both loads in flight at once
    const unsigned key = i < Vf ? (unsigned)__ldg(Kb + i) : kSentinel;
    const unsigned prev = i > 0 ? (unsigned)__ldg(Kb + i - 1) : kSentinel;
    if (key == kSentinel && (i == 0 || prev != kSentinel)) {
      s_R = i;
      s_kmax = i > 0 ? prev : 0;
    }
  }
  __syncthreads();
  const int R = s_R;
  const unsigned kmax = s_kmax;
  const int lane = threadIdx.x & 31;
  if constexpr (!kScratch) {
    // The buckets the occupied keys span, each's first slot.
    const int buckets = R > 0 ? (int)((kmax - k0) >> kBucketShift) + 1 : 0;
    for (int j = threadIdx.x; j <= buckets; j += kThreads) starts[j] = 0xFFFF;
    __syncthreads();
    for (int i0 = threadIdx.x; i0 - lane < R; i0 += 8 * kThreads) {
      unsigned key[8], prev[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // the loads in flight at once
        const int i = i0 + u * kThreads;
        key[u] = i < R ? (unsigned)__ldg(Kb + i) : kSentinel;
        // The key before: the lane before's, lane 0's loaded.
        prev[u] = lane == 0 && i > 0 && i < R ? (unsigned)__ldg(Kb + i - 1)
                                              : kSentinel;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        const unsigned before = __shfl_up_sync(0xffffffffu, key[u], 1);
        if (lane > 0) prev[u] = before;
        if (i >= R) continue;
        const unsigned d = key[u] - k0;
        offs[i] = (unsigned short)(d & 0xFFFFu);
        if (i == 0 || (prev[u] - k0) >> kBucketShift != d >> kBucketShift)
          starts[d >> kBucketShift] = (unsigned short)i;
      }
    }
    __syncthreads();
    {  // each empty bucket starts where the next one does; past the last,
       // R: a suffix min over the buckets, a warp a run of them walked from
       // its end 32 at a time (neighbouring lanes on neighbouring buckets)
      __shared__ int run_min[kWarps];
      const int warp = threadIdx.x >> 5, per = (buckets + kWarps) / kWarps;
      const int w0 = min(buckets + 1, warp * per);
      const int w1 = min(buckets + 1, w0 + per);
      int m = 0xFFFF;
      for (int j = w0 + lane; j < w1; j += 32) m = min(m, (int)starts[j]);
      m = __reduce_min_sync(0xffffffffu, m);
      if (lane == 0) run_min[warp] = m;
      __syncthreads();
      int after = 0xFFFF;  // the runs after this warp's
      for (int v = warp + 1; v < kWarps; ++v) after = min(after, run_min[v]);
      for (int top = w1; top > w0; top -= 32) {
        const int j = top - 32 + lane;
        int x = j >= w0 ? (int)starts[j] : 0xFFFF;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_down_sync(0xffffffffu, x, o);
          if (lane + o < 32) x = min(x, y);
        }
        x = min(x, after);
        if (j >= w0) starts[j] = (unsigned short)(x == 0xFFFF ? R : x);
        after = __shfl_sync(0xffffffffu, x, 0);
      }
    }
  }  // !kScratch
  // 2. The counts of this rank's slots (then their values), from its
  // first slot on, zeroed.
  const int S = (R + K - 1) / K;
  const int mine = max(0, min(R - rank * S, S));
  unsigned* const cnt = kScratch ? slab + (long long)rank * S
                                 : reinterpret_cast<unsigned*>(smem);
  unsigned* const cnt_below = kScratch ? cnt + Vf : cnt + (Vf + K - 1) / K;
  float* const vals = reinterpret_cast<float*>(cnt);
  for (int j = threadIdx.x; j < mine; j += kThreads) {
    cnt[j] = 0;
    if (kWide) cnt_below[j] = 0;
  }
  sync();

  // Each target point: its key, its place, its count.
  int valid = 0;
  auto count = [&](float p0, float p1, float p2) {
    ++valid;
    int cell[3];
    bool inside = true;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* Rr = pose + r * 4;
      const float x = add(add(add(mul(p0, Rr[0]), mul(p1, Rr[1])),
                              mul(p2, Rr[2])),
                          Rr[3]);
      cell[r] = cell_of(x, inv);
      inside = inside && cell[r] >= lo_cell[r] && cell[r] <= hi_cell[r];
    }
    const unsigned key = ((unsigned)(cell[0] & 1023) << 20) |
                         ((unsigned)(cell[1] & 1023) << 10) |
                         (unsigned)(cell[2] & 1023);
    int idx = 0;
    bool hit = false;
    if (inside && key > kmax) {  // past the last occupied slot
      idx = R;
    } else if (kScratch && inside && key >= k0) {
      int lo = 0, top = R;  // a binary search of the keys
      while (lo < top) {
        const int mid = (lo + top) >> 1;
        if ((unsigned)__ldg(Kb + mid) < key)
          lo = mid + 1;
        else
          top = mid;
      }
      idx = lo;
      hit = idx < R && (unsigned)__ldg(Kb + idx) == key;
    } else if (inside && key >= k0) {  // else below key 0
      const unsigned d = key - k0;
      const unsigned short qo = (unsigned short)(d & 0xFFFFu);
      int lo = starts[d >> kBucketShift];
      const int hi = starts[(d >> kBucketShift) + 1];
      int top = hi;
      while (lo < top) {
        const int mid = (lo + top) >> 1;
        if (offs[mid] < qo)
          lo = mid + 1;
        else
          top = mid;
      }
      idx = lo;
      hit = idx < hi && offs[idx] == qo;
    }
    if (inside && idx < R) {  // else past the last occupied slot
      // kScratch: every rank's slots are in the scratch
      const int owner = kScratch || K == 1 ? rank : idx / S;
      const int at = idx - owner * S;
      unsigned* word = kWide && !hit ? cnt_below + at : cnt + at;
      const unsigned inc = kWide || hit ? 1u : 0x10000u;
      if (owner == rank)  // a shared- (or, kScratch, global-) memory atomic
        atomicAdd(word, inc);
      else
        atomicAdd(cluster.map_shared_rank(word, owner), inc);
    }
  };
  const unsigned char* mb = mask + b * M;
  const float* pb = pts + b * M * 3;
  const long long step = (long long)K * kThreads;
  if (M % 4 == 0 && (reinterpret_cast<size_t>(mb) & 3) == 0 &&
      (reinterpret_cast<size_t>(pb) & 15) == 0) {
    // Four neighbouring points a lane: their mask bytes in one word and
    // their 12 coordinates in three 16-byte loads; kQuads of them at once,
    // their loads in flight together.
    for (long long m0 = 4 * ((long long)rank * kThreads + threadIdx.x);
         m0 < M; m0 += 4 * kQuads * step) {
      unsigned ok[kQuads];
      float4 q[kQuads][3];
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const long long m = m0 + 4 * u * step;
        ok[u] = m < M ? *reinterpret_cast<const unsigned*>(mb + m) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kQuads; ++u)
        if (ok[u]) {
          const float4* at =
              reinterpret_cast<const float4*>(pb + (m0 + 4 * u * step) * 3);
          q[u][0] = at[0];
          q[u][1] = at[1];
          q[u][2] = at[2];
        }
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const float4 a = q[u][0], c = q[u][1], e = q[u][2];
        if (ok[u] & 0xFFu) count(a.x, a.y, a.z);
        if (ok[u] & 0xFF00u) count(a.w, c.x, c.y);
        if (ok[u] & 0xFF0000u) count(c.z, c.w, e.x);
        if (ok[u] & 0xFF000000u) count(e.y, e.z, e.w);
      }
    }
  } else {
    for (long long m = (long long)rank * kThreads + threadIdx.x; m < M;
         m += step)
      if (mb[m]) count(pb[m * 3], pb[m * 3 + 1], pb[m * 3 + 2]);
  }
  if (valid) atomicAdd(&s_valid, valid);
  sync();

  // 3. The places. The ranks' sums first, where there are ranks before.
  long long before = 0;
  if (K > 1) {
    int sum = 0, live = 0;
    for (int j = threadIdx.x; j < mine; j += kThreads) {
      const unsigned h = cnt[j], w = kWide ? cnt_below[j] : h >> 16;
      sum += (int)(kWide ? h + w : (h & 0xFFFFu) + w);
      live += (h & (kWide ? 0xFFFFFFFFu : 0xFFFFu)) != 0;
    }
    int tsum, tlive;
    block_scan2(sum, live, &tsum, &tlive);
    if (threadIdx.x == 0) {
      s_sum = tsum;
      s_live = tlive;
    }
  }
  if (rank == 0)  // the table of rank 0 is no longer read
    for (long long w = threadIdx.x; w < l.bitmap_words; w += kThreads)
      bitmap[w] = 0;
  sync();
  if (threadIdx.x == 0) {
    long long keys_sum = 0;
    int valid_all = s_valid, live = 0;
    live_before[0] = 0;
    if (K > 1) {
      valid_all = 0;
      for (int r = 0; r < K; ++r) {
        live_before[r] = live;
        if (r < rank) keys_sum += *cluster.map_shared_rank(&s_sum, r);
        live += *cluster.map_shared_rank(&s_live, r);
        valid_all += *cluster.map_shared_rank(&s_valid, r);
      }
    }
    keys_before = keys_sum;
    s_valid_all = valid_all;
  }
  __syncthreads();
  before = keys_before;
  const float* s_cnt = counts + b * Vf;
  int held = 0;
  // kSlots neighbouring slots a thread, kThreads * kSlots a round.
  for (int j0 = 0; j0 < mine; j0 += kThreads * kSlots) {
    unsigned h[kSlots], w[kSlots];
    float s_i[kSlots];
    int sum = 0, live = 0;
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int j = j0 + threadIdx.x * kSlots + u;
      h[u] = w[u] = 0;
      s_i[u] = 0.0f;
      if (j < mine) {
        h[u] = kWide ? cnt[j] : cnt[j] & 0xFFFFu;
        w[u] = kWide ? cnt_below[j] : cnt[j] >> 16;
        if (h[u] >= 1) s_i[u] = s_cnt[(long long)rank * S + j];  // in flight
      }
      sum += (int)(h[u] + w[u]);
      live += h[u] >= 1;
    }
    int tsum, tlive;
    block_scan2(sum, live, &tsum, &tlive);
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (h[u] >= 1) {
        const long long i =
            (long long)rank * S + j0 + threadIdx.x * kSlots + u;
        // i table entries, the keys of the slots before i and i's below.
        const long long p = i + before + sum + w[u];
        vals[held + live] = run_value(s_i[u], (int)h[u]);
        if (rank == 0 || kScratch)
          atomicOr(bitmap + (p >> 5), 1u << (p & 31));
        else
          atomicOr(cluster.map_shared_rank(bitmap, 0) + (p >> 5),
                   1u << (p & 31));
        ++live;
      }
      sum += (int)(h[u] + w[u]);
    }
    before += tsum;
    held += tlive;
  }
  sync();

  // 4. The score, in rank 0.
  if (rank == 0) {
    {  // each bitmap word's rank among the live places
      int base = 0;
      for (long long w0 = 0; w0 < l.bitmap_words; w0 += kThreads) {
        const long long w = w0 + threadIdx.x;
        int c = w < l.bitmap_words ? __popc(bitmap[w]) : 0, unused = 0;
        int tc, tu;
        block_scan2(c, unused, &tc, &tu);
        if (w < l.bitmap_words) word_rank[w] = (Rank)(base + c);
        base += tc;
      }
    }
    __syncthreads();
    // The value at place p: +0.0 where it is no live place, else the j-th
    // live place's, held by its rank.
    auto live_value = [&](int p) -> float {
      const unsigned word = bitmap[p >> 5], bit = 1u << (p & 31);
      if (!(word & bit)) return 0.0f;
      const int j = word_rank[p >> 5] + __popc(word & (bit - 1));
      int r = 0;
      while (r + 1 < K && live_before[r + 1] <= j) ++r;
      if (r == 0) return vals[j];
      if (kScratch)
        return reinterpret_cast<const float*>(slab + (long long)r * S)
            [j - live_before[r]];
      return *cluster.map_shared_rank(vals + j - live_before[r], r);
    };
    // Level k's entries from the live places.
    switch (depth) {
      case 0: dense_level<0>(y, (int)level, leaf_off, leaf_lim, live_value);
        break;
      case 1: dense_level<1>(y, (int)level, leaf_off, leaf_lim, live_value);
        break;
      case 2: dense_level<2>(y, (int)level, leaf_off, leaf_lim, live_value);
        break;
      case 3: dense_level<3>(y, (int)level, leaf_off, leaf_lim, live_value);
        break;
      default: dense_level<4>(y, (int)level, leaf_off, leaf_lim, live_value);
    }
    __syncthreads();
    // fold_sum's other levels (kScratch: in device memory, which the
    // block's barriers order as they order shared memory).
    for (long long L = level; L > 1;) {
      const long long h = L >> 1;
      for (long long q = threadIdx.x; q < h; q += kThreads)
        y[q] = add(y[q], y[q + h]);
      __syncthreads();
      if (L & 1) {
        if (threadIdx.x == 0) y[h] = y[2 * h];
        __syncthreads();
      }
      L = h + (L & 1);
    }
    if (threadIdx.x == 0) {
      const float total = add(n_src[b], (float)s_valid_all);
      score[cand] = __fdiv_rn(y[0], clamp_min(total, 1.0f));
    }
  }
  sync();  // the ranks' values stay until rank 0 has read them
}

}  // namespace

extern "C" {

// The shared memory a block of the join takes with Vf table slots, M
// target points and clusters of K blocks, in bytes; -1 where no cluster of
// K holds it: more than a block may have, K not 1, 2, 4 or 8, or Vf out of
// the bucket starts' range (Vf < 1 or > 65535).
long long fccf_fine_join_shared(int Vf, long long M, int K) {
  if (Vf < 1 || Vf > 65535 || M < 0 || (long long)Vf + M >= 0x7fffffffLL ||
      (K != 1 && K != 2 && K != 4 && K != 8))
    return -1;
  int depth;
  const long long n = Vf + M, level = fold_level(n, &depth);
  const long long bytes = layout(Vf, n, K, M >= 65536, level).total;
  return bytes > kMaxShared ? -1 : bytes;
}

// The 4-byte words of scratch a candidate takes where no cluster holds its
// share (K = 0); -1 where the sizes are out of range (Vf < 1, n = Vf + M
// at 2^31 or more).
long long fccf_fine_join_scratch(int Vf, long long M) {
  if (Vf < 1 || M < 0 || (long long)Vf + M >= 0x7fffffffLL) return -1;
  return scratch_words(Vf, Vf + M, M >= 65536);
}

// The join over P pairs of C candidates: T (P, C, 4, 4), tar_pts (P, M,
// 3) float32, tar_mask (P, M) bool, the table's keys (P, Vf) int64 (sorted,
// sentinel 0xFFFFFFFF past the occupied slots), counts (P, Vf) and n_src
// (P) float32, cell_min and cell_max (P, 3) int32, inv = float32(1 /
// fine_voxel), clusters of K blocks a candidate, or K = 0 and scratch
// (P * C * fccf_fine_join_scratch(Vf, M) words) where no cluster holds
// the share in shared memory;
// out score (P, C) float32.
int fccf_fine_join(const void* T, const void* pts, const void* mask,
                   const void* keys, const void* counts, const void* n_src,
                   const void* cmin, const void* cmax, void* score,
                   void* scratch, long long P, int C, long long M, int Vf,
                   float inv, int K, void* stream) {
  if (P <= 0 || C <= 0) return 0;
  const bool in_scratch = K == 0;
  const long long bytes = in_scratch ? 0 : fccf_fine_join_shared(Vf, M, K);
  const long long share = in_scratch ? fccf_fine_join_scratch(Vf, M) : 0;
  if (bytes < 0 || share < 0 || (in_scratch && scratch == nullptr) ||
      P > 65535 || C > 65535)
    return (int)cudaErrorInvalidValue;
  const bool wide = M >= 65536;  // a count may pass 65535
  const void* kernel =
      wide ? (in_scratch ? (const void*)fine_join_kernel<true, true>
                         : (const void*)fine_join_kernel<true, false>)
           : (in_scratch ? (const void*)fine_join_kernel<false, true>
                         : (const void*)fine_join_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  if (in_scratch) K = kScratchCluster;
  cfg.gridDim = dim3((unsigned)K, (unsigned)C, (unsigned)P);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long n = (long long)Vf + M;
  void* args[] = {(void*)&T,      (void*)&pts,    (void*)&mask,
                  (void*)&keys,   (void*)&counts, (void*)&n_src,
                  (void*)&cmin,   (void*)&cmax,   (void*)&score,
                  (void*)&scratch, (void*)&share,   (void*)&C,
                  (void*)&M,      (void*)&Vf,     (void*)&n,
                  (void*)&inv};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
