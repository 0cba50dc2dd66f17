// The cluster stage's sequential loops, for Hopper (sm_90a).
//
// None replaces a Pallas kernel: they are the device loops that the JAX
// package's compiled program runs inside fccf_pcr_tpu/cluster/cluster.py
// and that the port ran as PyTorch loops on the card, or on the host.
//
// - cluster_block_scan_kernel (C1) is the whole greedy-leader block scan
//   of _greedy_seeds_all_types (fccf_pcr_tpu/cluster/cluster.py:131-200:
//   the fori_loop over blocks of B = 512 hypotheses, its intra-block
//   lax.while_loop at :157 and the member sums ss = geo_f @ stats_cols at
//   :173) in one launch: the seeds, and for every hypothesis r of each
//   (pair, type) lane the sums of [t, px, py, 1] over r's ball within the
//   lane (size and the 9 sums). Nothing of the (B, H) ball predicates,
//   the (B, B) sub-blocks or the products is materialized.
// - cluster_block_seeds_kernel is the intra-block fixpoint alone,
//   s[i] = elig[i] AND NOT any(j < i: s[j] AND sub_lower[j, i]), on a
//   (B, B) predicate block given in memory: the walk C1 runs inside, kept
//   as a standalone entry (ops/cluster_kernels.py::block_seeds) held to
//   its plain version, off the main path.
// - cluster_floor_walk_kernel (C2) replaces the adaptive floor walk, the
//   lax.scan at fccf_pcr_tpu/cluster/cluster.py:260 (the reference's
//   FCCF.cpp:1126-1229), over the clusters of each lane sorted by size,
//   with the scan's float32 comparisons.
//
// Bit-equal to the plain versions on the card (ops/cluster_kernels.py),
// built with --fmad=false so that every product rounds once:
//
// - the ball predicate of row r and column c of a pair is _ball_rows':
//   d2 = (sum(t_r^2) + sum(t_c^2)) - 2 ((t_r0 t_c0 + t_r1 t_c1) + t_r2
//   t_c2), the 3-entry sums in torch's CUDA order (tsum3, as
//   csrc/lm.cu's), then d2 <= r2 AND clamp(px_r . px_c, -1, 1) >= cos
//   (a NaN fails both);
// - a member sum adds the products geo_f * stats_cols (stats_cols = the
//   column's [t, px, py, 1] times its lane mask, as the plain version's
//   tensor) over each 512-column tile in ops/batch.py::fold_sum's tree,
//   and the tiles in order from 0.0 + the first; the row's lane mask
//   then multiplies it. A hypothesis belongs to at most one lane, so
//   only that lane's sums are computed; in the others the mask makes the
//   result 0, or NaN where the pair holds a non-finite [t, px, py] entry
//   in that component (a non-finite factor makes every product of its
//   column non-finite, so every sum of the component is). Not modeled:
//   a finite member sum that overflows float32 (|sum| > 3.4e38) in a lane
//   the row is not in, which the plain version turns into NaN.
//
// Layout: masks (P, 3, H) bool bytes, t, px, py (P, H, 3) float32;
// seeds (P, 3, H) bool bytes, size (P, 3, H), sums (P, 3, H, 9) float32.
// H % B == 0, B <= 512. sub_lower (L, B, B), elig and seeds (L, B) bool
// bytes for the standalone walk; s_size (L, W) float32 (a slot is a seed
// cluster iff its size is > 0), cluster_num (L,) float32, emit (L, W)
// bool bytes for C2, which compares as the plain walk (Python floats):
// bit-equal on any float32 sizes, NaN and infinities included. L is
// every leading dim (pairs x 3 types) flattened.
//
// Bound. The member sums are the work: a ball predicate (18 operations)
// for every row of a lane against every column of that lane, and 10 adds
// for each pair in the ball (the products are by a 0/1 predicate: a
// select), on the float32 pipe (67 TFLOP/s on an H100 SXM); a column
// outside the row's lane adds an exact 0 (or a NaN, which one finiteness
// test a pool entry decides); the bytes (the pool, the outputs) are a
// few MB. The seeds are a chain in index order: a seed's ball
// decides whether every later hypothesis of its lane can still be one.
// C2's walk is a chain of rounds of 32 slots: neither its bytes nor its
// operations come near the card's rates, its time is the rounds'
// latency.
//
// Design of C1: one launch, two kinds of blocks, independent of each
// other, so that they run side by side:
//
// - the first 3P thread-block clusters of kScanCluster = 8 blocks scan
//   one (pair, type) lane each. Lanes are independent, so no grid barrier
//   is needed, and a cluster barrier orders a lane's blocks of B; a lane
//   can hold nearly a whole pool (the hypotheses of a pair are mostly of
//   one type), so its work is spread over the cluster's 8 SMs' worth of
//   blocks, which share their shared memory. For block i of the lane:
//   every rank stages the block's B hypotheses' geometry; the leader
//   (rank 0) marks the candidates, its eligible hypotheses not yet
//   covered; every rank computes a share of the candidates' rows of the
//   strictly lower (B, B) predicate block on the fly and packs them to
//   bits in the leader's shared memory (32 KB); one warp of the leader
//   walks the candidates in index order (walk(), as the standalone walk);
//   then every rank takes the later eligible, uncovered hypotheses whose
//   coverage word it keeps and marks one covered at the first seed of the
//   block whose ball holds it. Four cluster barriers a block.
// - the other blocks compute the member sums of 64 hypotheses of a pair
//   each: for every 512-column tile, the tile's geometry and its
//   stats_cols (30 floats a column) are staged in shared memory; a warp
//   takes a valid row at a time, thread x evaluates columns x, x + 32,
//   ..., x + 480 in fold_sum's tree order (fold_entry: the tree's first
//   four steps stay in the thread), then the last five steps are
//   shuffles at falling offsets; lane 0 adds the tile's sums to the
//   row's running totals in shared memory. A column outside the row's
//   lane keeps its place in the tree but its ball is not evaluated: its
//   entry is 0 times its masked stats_cols, an exact 0 (or a NaN where
//   it is not finite), as in the plain version; a tile with no column of
//   the row's lane and no non-finite entry adds only zeros and is
//   skipped. A row outside every lane needs no sums, only the pair's
//   non-finite flags, which every block gathers while it stages.
//
// Design of the standalone walk: one block a lane. Its threads pack the
// eligible rows of the lane's (B, B) bytes into bits in shared memory (32
// KB at B = 512, 16-byte loads); then one warp walks the rows in index
// order, lane l holding the block's coverage of columns 16l..16l+15 as 16
// bits. A candidate i is eligible and uncovered; the warp finds the next
// one with one shuffle and __ffs, ORs its row into the coverage (one
// shared load a lane) and skips every index that row covers, so a step is
// a seed, never a row that is not.
//
// Design of C2: a warp a lane (kWalkWarps lanes a block), 32 slots a
// round, slot c0 + l in lane l, the loads of the next kWalkBatch rounds
// in flight while these are decided. Non-seeds are skipped by a ballot;
// the round's emits are the fixpoint of one ballot a try (see the
// kernel), and its stop the first seed whose step stops (__ffs). A first
// floor of 2^24 or more (never a member count of a pool) takes the walk
// slot by slot with a double floor, as the plain walk runs it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlock = 512;          // B: the seed block of cluster.py
constexpr int kChunks = kMaxBlock / 16;  // 16-column chunks of a row
constexpr int kSeedThreads = 256;
constexpr int kWalkWarps = 4;            // C2: lanes a block, a warp each
constexpr int kWalkBatch = 4;            // C2: rounds of 32 slots loaded ahead
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanThreads = 256;        // threads of a C1 block
constexpr int kSumRows = 64;             // rows of a member-sum block
constexpr int kStats = 10;               // [t, px, py, 1]
constexpr int kTypes = 3;
constexpr int kFoldLevels = 4;           // fold steps in a thread: 512 -> 32
constexpr int kScanCluster = 8;          // blocks of a lane's scan cluster

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

// The greedy seeds of one block, by one warp, over its candidates'
// packed rows (rows[i][c]: bit b = the predicate of row i at column 16c +
// b, strictly lower: only for i < 16c + b) and the candidate bits elig
// (16 a chunk): lane l returns the seed bits of chunk l.
__device__ unsigned walk(const uint16_t (*rows)[kChunks],
                         const uint16_t* elig_bits, int nc) {
  const unsigned full = 0xffffffffu;
  const int l = threadIdx.x & 31;  // this lane's 16 columns: chunk l
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
  return mine;
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
  const unsigned mine = walk(rows, elig_bits, nc);
  const int l = t;
  for (int b = 0; b < 16 && 16 * l + b < B; ++b)
    seeds_l[16 * l + b] = (uint8_t)((mine >> b) & 1u);
}

// The plain walk's carry as it compares: `emitted` an integer against the
// budget and its half, which it holds as doubles (Python floats).
struct WalkBudget {
  double cn, half;
  __device__ bool over(int emitted) const { return (double)emitted > cn; }
  __device__ bool under_half(int emitted) const {
    return (double)emitted < half;
  }
};

// Zero emit[from .. to) by the warp, 16 bytes a store where the address
// is aligned.
__device__ void zero_tail(uint8_t* emit, long long from, long long to,
                          int l) {
  uint8_t* const p = emit + from;
  uint8_t* const e = emit + to;
  uint8_t* const a = p + min((long long)(to - from),
                             (long long)((16 - (uintptr_t)p % 16) % 16));
  uint8_t* const v = a + ((e - a) & ~15LL);
  for (uint8_t* x = p + l; x < a; x += 32) *x = 0;
  for (uint8_t* x = a + 16 * l; x < v; x += 16 * 32)
    *reinterpret_cast<uint4*>(x) = make_uint4(0u, 0u, 0u, 0u);
  for (uint8_t* x = v + l; x < e; x += 32) *x = 0;
}

// The walk one slot at a time with a double floor, as the plain walk
// runs it, by lane 0: for a first floor of 2^24 or more, where the
// float32 subtractions of the rounds would round.
__device__ void floor_walk_serial(const float* size_l, uint8_t* emit_l,
                                  long long W, double floor_,
                                  const WalkBudget& bud, int l) {
  if (l == 0) {
    int emitted = 0;
    bool stop = false;
    for (long long i = 0; i < W; ++i) {
      const float x = size_l[i];
      bool out = false;
      if (!stop && x > 0.0f) {
        if ((double)x >= floor_) {
          out = true;
          ++emitted;
          stop = bud.over(emitted);  // break after push (:1208-1211)
        } else if (bud.under_half(emitted)) {
          floor_ = floor_ - 1.0;
          stop = floor_ < 2.0;
        } else {
          stop = true;
        }
      }
      emit_l[i] = out;
    }
  }
}

__global__ void __launch_bounds__(32 * kWalkWarps)
cluster_floor_walk_kernel(const float* __restrict__ s_size,
                          const float* __restrict__ cluster_num,
                          uint8_t* __restrict__ emit, int L, int W) {
  const int l = threadIdx.x & 31;
  const long long lane_id =
      (long long)blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (lane_id >= L) return;  // the whole warp
  const float* size_l = s_size + lane_id * W;
  uint8_t* emit_l = emit + lane_id * W;
  const float cn = cluster_num[lane_id];
  const WalkBudget bud{(double)cn, (double)cn / 2.0};
  const float s0 = size_l[0];
  float f0 = 0.0f > s0 ? 0.0f : s0;  // max(sizes[0], 0.0)
  if (isfinite(f0) && !(f0 < 16777216.0f)) {
    floor_walk_serial(size_l, emit_l, W, f0, bud, l);
    return;
  }
  // Rounds of 32 slots, slot c0 + l in lane l, kWalkBatch rounds loaded
  // ahead of the ones decided. With the carry (emitted e0, floor f0) at a
  // round's start, its seed j (in slot order) is reached with e0 + E_j
  // emitted and the floor f0 - D_j, E_j and D_j the seeds before it that
  // emit and that do not (each of those lowered the floor by one, or
  // the walk stopped there). f0 - D_j is exact (f0 < 2^24 and every
  // floor the walk reaches before it stops is >= 2, or D_j = 0), so it
  // is the plain walk's floor. Seed j emits iff size_j >= f0 - D_j, which
  // depends only on the seeds before it: iterating the ballot from any
  // guess fixes one more seed each time, and a guess that does not change
  // is the walk's. The stop is then the first seed whose step stops.
  const unsigned lt = (1u << l) - 1u;
  int e0 = 0;
  float next[kWalkBatch];
#pragma unroll
  for (int k = 0; k < kWalkBatch; ++k)
    next[k] = 32 * k + l < W ? size_l[32 * k + l] : 0.0f;
  for (long long c0 = 0; c0 < W; c0 += 32 * kWalkBatch) {
    float cur[kWalkBatch];
#pragma unroll
    for (int k = 0; k < kWalkBatch; ++k) {
      cur[k] = next[k];
      const long long i = c0 + 32 * (kWalkBatch + k) + l;
      next[k] = i < W ? size_l[i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kWalkBatch; ++k) {
      const long long i = c0 + 32 * k + l;
      const float x = cur[k];
      const bool seed = x > 0.0f;  // else the carry is unchanged
      const unsigned sb = __ballot_sync(kFull, seed);
      unsigned g = 0;
      if (sb) {
        const int S = __popc(sb & lt);
        g = __ballot_sync(kFull, seed && x >= f0);
        for (int it = 0; it <= 32; ++it) {
          const float f = f0 - (float)(S - __popc(g & lt));
          const unsigned ng = __ballot_sync(kFull, seed && x >= f);
          if (ng == g) break;
          g = ng;
        }
        const int e = e0 + __popc(g & lt);  // emitted before this slot
        const int D = S - __popc(g & lt);
        bool stop;
        if ((g >> l) & 1u)
          stop = bud.over(e + 1);  // break after push (:1208-1211)
        else if (bud.under_half(e))
          stop = f0 - (float)(D + 1) < 2.0f;
        else
          stop = true;
        const unsigned sbits = __ballot_sync(kFull, seed && stop);
        if (sbits) {
          const int s = __ffs(sbits) - 1;
          g &= s == 31 ? kFull : (2u << s) - 1u;
          if (i < W) emit_l[i] = (g >> l) & 1u;
          zero_tail(emit_l, min((long long)W, c0 + 32 * (k + 1)), W, l);
          return;
        }
        e0 += __popc(g);
        f0 = f0 - (float)(__popc(sb) - __popc(g));
      }
      if (i < W) emit_l[i] = (g >> l) & 1u;
    }
  }
}

// ------------------------------------------------------------------ C1 --

// torch.sum of 3 entries on the card: block_width 2, thread 0 holds
// entries 0 and 2, thread 1 entry 1 (csrc/lm.cu's tsum3).
__device__ __forceinline__ float tsum3(float a0, float a1, float a2) {
  const float s0 = (((0.0f + a0) + (0.0f + a2)) + 0.0f) + 0.0f;
  const float s1 = (((0.0f + a1) + 0.0f) + 0.0f) + 0.0f;
  return s0 + s1;
}

// Hypothesis c of pair p: (t, sum(t * t)) and (px, 0).
__device__ __forceinline__ void load_geo(const float* __restrict__ t,
                                         const float* __restrict__ px,
                                         long long c, float4& tg,
                                         float4& pg) {
  const float a = t[3 * c], b = t[3 * c + 1], d = t[3 * c + 2];
  tg = make_float4(a, b, d, tsum3(a * a, b * b, d * d));
  pg = make_float4(px[3 * c], px[3 * c + 1], px[3 * c + 2], 0.0f);
}

// _ball_rows of row r against column c.
__device__ __forceinline__ bool ball(const float4& tr, const float4& pr,
                                     const float4& tc, const float4& pc,
                                     float r2, float cos_gate) {
  const float m = (tr.x * tc.x + tr.y * tc.y) + tr.z * tc.z;
  const float d2 = (tr.w + tc.w) - 2.0f * m;
  const float cm = (pr.x * pc.x + pr.y * pc.y) + pr.z * pc.z;
  // torch.clamp(cm, -1, 1) >= cos_gate; a NaN stays NaN and fails
  const bool cos_ok = !isnan(cm) && fminf(fmaxf(cm, -1.0f), 1.0f) >= cos_gate;
  return d2 <= r2 && cos_ok;
}

struct ScanArgs {
  const uint8_t* masks;
  const float *t, *px, *py;
  uint8_t* seeds;
  float *size, *sums;
  int P, H, B;
  float r2, cos_gate;
};

// One (pair, type) lane's block scan, by the kScanCluster blocks of one
// thread-block cluster: the seeds of every block of B in order. Rank 0
// (the leader) holds the candidates, the packed rows and the seeds of the
// block; every rank builds a share of the rows into the leader's shared
// memory and keeps the coverage of the columns whose 32-bit word w has w
// % kScanCluster == its rank.
__device__ void scan_lane(const ScanArgs& a, int p, int k,
                          unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int H = a.H, B = a.B, nb = H / B, nc = (B + 15) / 16;
  const int words = (H + 31) / 32;
  uint16_t(*rows)[kChunks] = reinterpret_cast<uint16_t(*)[kChunks]>(smem);
  float4* bt = reinterpret_cast<float4*>(smem + sizeof(uint16_t) * kMaxBlock *
                                         kChunks);
  float4* bp = bt + B;
  unsigned* mbits = reinterpret_cast<unsigned*>(bp + B);
  unsigned* cov = mbits + words;
  uint16_t* cand16 = reinterpret_cast<uint16_t*>(cov + words);
  uint16_t* seed16 = cand16 + kChunks;
  uint16_t* lead_rows = cluster.map_shared_rank(&rows[0][0], 0);
  const uint16_t* lead_cand = cluster.map_shared_rank(cand16, 0);
  const uint16_t* lead_seed = cluster.map_shared_rank(seed16, 0);
  __shared__ int last;
  const int tid = threadIdx.x;
  const uint8_t* mk = a.masks + ((long long)p * kTypes + k) * H;
  const float* t = a.t + (long long)p * H * 3;
  const float* px = a.px + (long long)p * H * 3;
  uint8_t* seeds = a.seeds + ((long long)p * kTypes + k) * H;

  if (tid == 0) last = -1;
  __syncthreads();
  int my_last = -1;
  for (int w = tid; w < words; w += kScanThreads) {
    unsigned bits = 0;
    for (int b = 0; b < 32 && 32 * w + b < H; ++b)
      if (mk[32 * w + b]) bits |= 1u << b;
    mbits[w] = bits;
    cov[w] = 0u;
    if (bits) my_last = 32 * w + 31 - __clz(bits);
  }
  atomicMax(&last, my_last);
  // Every rank has started and zeroed its coverage before any reads it.
  cluster.sync();
  const int last_idx = last;
  // eligible (in the lane, not its last index) and not covered, from the
  // coverage word's owner
  auto open_ = [&](int c, const unsigned* cw) {
    return ((mbits[c >> 5] & ~cw[c >> 5]) >> (c & 31)) & 1u && c != last_idx;
  };

  for (int i = 0; i < nb; ++i) {
    const int b0 = i * B;
    for (int e = tid; e < B; e += kScanThreads)
      load_geo(t, px, b0 + e, bt[e], bp[e]);
    if (rank == 0) {
      for (int q = tid; q < nc; q += kScanThreads) {
        unsigned bits = 0;
        for (int b = 0; b < 16 && 16 * q + b < B; ++b) {
          const int c = b0 + 16 * q + b;
          if (open_(c, cluster.map_shared_rank(cov, (c >> 5) % kScanCluster)))
            bits |= 1u << b;
        }
        cand16[q] = (uint16_t)bits;
      }
    }
    cluster.sync();
    // The candidates' rows of sub_lower, a share a rank, into the
    // leader's rows: column c of the block in the lane's mask, after the
    // row, in the row's ball.
    for (int e = rank * kScanThreads + tid; e < B * nc;
         e += kScanCluster * kScanThreads) {
      const int j = e / nc, q = e - (e / nc) * nc;
      if (!((lead_cand[j >> 4] >> (j & 15)) & 1u)) continue;
      unsigned bits = 0;
      for (int b = 0; b < 16; ++b) {
        const int c = 16 * q + b;
        if (c <= j || c >= B) continue;
        if (((mbits[(b0 + c) >> 5] >> ((b0 + c) & 31)) & 1u) &&
            ball(bt[j], bp[j], bt[c], bp[c], a.r2, a.cos_gate))
          bits |= 1u << b;
      }
      lead_rows[j * kChunks + q] = (uint16_t)bits;
    }
    cluster.sync();
    if (rank == 0 && tid < 32) {
      const unsigned mine = walk(rows, cand16, nc);
      if (tid < nc) seed16[tid] = (uint16_t)mine;
    }
    cluster.sync();
    uint16_t my_seed[kChunks];
    for (int q = 0; q < nc; ++q) my_seed[q] = lead_seed[q];
    if (rank == 0)
      for (int e = tid; e < B; e += kScanThreads)
        seeds[b0 + e] = (uint8_t)((my_seed[e >> 4] >> (e & 15)) & 1u);
    // Coverage of the later blocks' columns this rank keeps, by this
    // block's seeds.
    const int w0 = (b0 + B) >> 5;
    const int first = w0 + ((rank - w0 % kScanCluster) + kScanCluster) %
                               kScanCluster;
    const int owned = first < words ? (words - first + kScanCluster - 1) /
                                          kScanCluster
                                    : 0;
    for (int u = tid; u < 32 * owned; u += kScanThreads) {
      const int c = 32 * (first + (u >> 5) * kScanCluster) + (u & 31);
      if (c < b0 + B || c >= H || !open_(c, cov)) continue;
      float4 tc, pc;
      load_geo(t, px, c, tc, pc);
      bool hit = false;
      for (int q = 0; q < nc && !hit; ++q) {
        unsigned sd = my_seed[q];
        while (sd && !hit) {
          const int j = 16 * q + __ffs(sd) - 1;
          sd &= sd - 1;
          hit = ball(bt[j], bp[j], tc, pc, a.r2, a.cos_gate);
        }
      }
      if (hit) atomicOr(&cov[c >> 5], 1u << (c & 31));
    }
    cluster.sync();
  }
}

// The member sums' fold over one tile: thread x's entry of fold_sum's
// tree after its first D steps (sizes n[d], halves h[d]), from leaf(c),
// the products of column c.
struct Leaf {
  const float4 *ct, *cp;
  const float* sc;  // this row's lane: sc[m * B + c]
  float4 tr, pr;
  float r2, cos_gate;
  int B;
  __device__ __forceinline__ void operator()(int c, float out[kStats]) const {
    // sc[9 B + c] is the column's lane mask (its stats entry 1): outside
    // the lane every entry of the column is 0 or NaN whatever g is
    const float g = sc[(kStats - 1) * B + c] != 0.0f &&
                            ball(tr, pr, ct[c], cp[c], r2, cos_gate)
                        ? 1.0f
                        : 0.0f;
#pragma unroll
    for (int m = 0; m < kStats; ++m) out[m] = g * sc[m * B + c];
  }
};

struct FoldSizes {
  int n[kFoldLevels + 1], h[kFoldLevels + 1];
  int K;  // the steps before at most 32 entries are left
};

__device__ FoldSizes fold_sizes(int B) {
  FoldSizes f;
  f.n[0] = B;
  f.K = 0;
  for (int d = 0; d < kFoldLevels; ++d) {
    f.h[d] = f.n[d] >> 1;
    f.n[d + 1] = f.h[d] + (f.n[d] & 1);
    if (f.n[f.K] > 32) f.K = d + 1;
  }
  return f;
}

template <int D>
__device__ __forceinline__ void fold_entry(const FoldSizes& f, const Leaf& lf,
                                           int i, float out[kStats]) {
  const int h = f.h[D - 1];
  if (i < h) {
    float x[kStats], y[kStats];
    fold_entry<D - 1>(f, lf, i, x);
    fold_entry<D - 1>(f, lf, i + h, y);
#pragma unroll
    for (int m = 0; m < kStats; ++m) out[m] = x[m] + y[m];
  } else {  // the carried last entry
    fold_entry<D - 1>(f, lf, f.n[D - 1] - 1, out);
  }
}

template <>
__device__ __forceinline__ void fold_entry<0>(const FoldSizes&, const Leaf& lf,
                                              int i, float out[kStats]) {
  lf(i, out);
}

// fold_sum over the B columns of a tile; the sums end in lane 0.
__device__ void fold_tile(const FoldSizes& f, const Leaf& lf, int lane,
                          float x[kStats]) {
#pragma unroll
  for (int m = 0; m < kStats; ++m) x[m] = 0.0f;
  int n = f.n[f.K];
  if (lane < n) {
    switch (f.K) {
      case 0: fold_entry<0>(f, lf, lane, x); break;
      case 1: fold_entry<1>(f, lf, lane, x); break;
      case 2: fold_entry<2>(f, lf, lane, x); break;
      case 3: fold_entry<3>(f, lf, lane, x); break;
      default: fold_entry<4>(f, lf, lane, x); break;
    }
  }
  while (n > 1) {
    const int h = n >> 1;
    const bool carry = (n & 1) && lane == h;
#pragma unroll
    for (int m = 0; m < kStats; ++m) {
      const float o = __shfl_down_sync(0xffffffffu, x[m], h);
      x[m] = lane < h ? x[m] + o : (carry ? o : x[m]);
    }
    n = h + (n & 1);
  }
}

// Floats of a member-sum block's staged stats_cols, padded to 16 bytes.
__host__ __device__ __forceinline__ int sc_floats(int B) {
  return (kTypes * kStats * B + 3) & ~3;
}

// The member sums of rows r0 .. r0 + kSumRows - 1 of pair p.
__device__ void member_sums(const ScanArgs& a, int p, int r0,
                            unsigned char* smem) {
  const int H = a.H, B = a.B;
  float4* ct = reinterpret_cast<float4*>(smem);
  float4* cp = ct + B;
  float* sc = reinterpret_cast<float*>(cp + B);       // [3][10][B]
  float4* rt = reinterpret_cast<float4*>(sc + sc_floats(B));
  float4* rp = rt + kSumRows;
  float* tot = reinterpret_cast<float*>(rp + kSumRows);  // [rows][10]
  int* rk = reinterpret_cast<int*>(tot + kSumRows * kStats);
  __shared__ int bad;  // bit m: a non-finite entry of component m
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* mk = a.masks + (long long)p * kTypes * H;
  const float* t = a.t + (long long)p * H * 3;
  const float* px = a.px + (long long)p * H * 3;
  const float* py = a.py + (long long)p * H * 3;

  if (tid == 0) bad = 0;
  int any = 0;
  for (int e = tid; e < kSumRows; e += kScanThreads) {
    const int r = r0 + e;
    int k = -1;
    if (r < H) {
      for (int kk = 0; kk < kTypes; ++kk)
        if (mk[(long long)kk * H + r]) k = kk;
      load_geo(t, px, r, rt[e], rp[e]);
    }
    rk[e] = k;
    any |= k >= 0;
  }
  any = __syncthreads_or(any);

  const FoldSizes f = fold_sizes(B);
  int my_bad = 0;
  for (int j = 0; j < H / B; ++j) {
    const int c0 = j * B;
    if (!any) {  // no sums needed here: only the flags
      for (int e = tid; e < B; e += kScanThreads) {
        const long long c = (long long)(c0 + e) * 3;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          my_bad |= (!isfinite(t[c + q])) << q;
          my_bad |= (!isfinite(px[c + q])) << (3 + q);
          my_bad |= (!isfinite(py[c + q])) << (6 + q);
        }
      }
      continue;
    }
    int in_lane = 0, tile_bad = 0;  // bit kk: a column of lane kk
    for (int e = tid; e < B; e += kScanThreads) {
      const int c = c0 + e;
      load_geo(t, px, c, ct[e], cp[e]);
      float s[kStats];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        s[q] = t[3LL * c + q];
        s[3 + q] = px[3LL * c + q];
        s[6 + q] = py[3LL * c + q];
      }
      s[9] = 1.0f;
#pragma unroll
      for (int m = 0; m < kStats; ++m) tile_bad |= (!isfinite(s[m])) << m;
#pragma unroll
      for (int kk = 0; kk < kTypes; ++kk) {
        const bool in = mk[(long long)kk * H + c];
        in_lane |= in << kk;
        const float w = in ? 1.0f : 0.0f;
#pragma unroll
        for (int m = 0; m < kStats; ++m)
          sc[(kk * kStats + m) * B + e] = s[m] * w;
      }
    }
    my_bad |= tile_bad;
    // the tile's lanes, and whether it holds a non-finite entry
    const bool has[kTypes] = {__syncthreads_or(in_lane & 1) != 0,
                              __syncthreads_or(in_lane & 2) != 0,
                              __syncthreads_or(in_lane & 4) != 0};
    const bool bad_tile = __syncthreads_or(tile_bad) != 0;
    for (int e = warp; e < kSumRows; e += kScanThreads / 32) {
      const int k = rk[e];
      if (k < 0) continue;
      if (!has[k] && !bad_tile) {  // the tile adds only zeros
        if (lane == 0 && j == 0)
#pragma unroll
          for (int m = 0; m < kStats; ++m) tot[e * kStats + m] = 0.0f;
        continue;
      }
      Leaf lf{ct, cp, sc + k * kStats * B, rt[e], rp[e], a.r2, a.cos_gate, B};
      float x[kStats];
      fold_tile(f, lf, lane, x);
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < kStats; ++m)
          tot[e * kStats + m] =
              j == 0 ? 0.0f + x[m] : tot[e * kStats + m] + x[m];
      }
    }
    __syncthreads();  // the tile's staging is rewritten next
  }
  if (my_bad) atomicOr(&bad, my_bad);
  __syncthreads();
  const int flags = bad;
  const float qnan = __int_as_float(0x7fc00000);
  for (int e = tid; e < kSumRows * kTypes; e += kScanThreads) {
    const int rl = e / kTypes, k = e - rl * kTypes, r = r0 + rl;
    if (r >= H) continue;
    const long long o = ((long long)p * kTypes + k) * H + r;
    const bool own = rk[rl] == k;
    float v[kStats];
#pragma unroll
    for (int m = 0; m < kStats; ++m)
      v[m] = own ? tot[rl * kStats + m] * 1.0f
                 : ((flags >> m) & 1 ? qnan : 0.0f);
    a.size[o] = v[9];
#pragma unroll
    for (int m = 0; m < 9; ++m) a.sums[o * 9 + m] = v[m];
  }
}

// The first 3P clusters scan a lane each; the blocks after them compute
// member sums, each alone (the grid is padded to whole clusters).
__global__ void __cluster_dims__(kScanCluster, 1, 1)
    __launch_bounds__(kScanThreads) cluster_block_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lanes = a.P * kTypes;
  const int b = blockIdx.x;
  if (b < lanes * kScanCluster) {
    const int lane = b / kScanCluster;
    scan_lane(a, lane / kTypes, lane % kTypes, smem);
  } else {
    const int per_pair = (a.H + kSumRows - 1) / kSumRows;
    const int e = b - lanes * kScanCluster;
    if (e < a.P * per_pair)
      member_sums(a, e / per_pair, (e % per_pair) * kSumRows, smem);
  }
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
  cluster_floor_walk_kernel<<<(L + kWalkWarps - 1) / kWalkWarps,
                              32 * kWalkWarps, 0, (cudaStream_t)stream>>>(
      (const float*)s_size, (const float*)cluster_num, (uint8_t*)emit, L, W);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a C1 launch: the larger of a scan block's
// and a member-sum block's.
static size_t block_scan_smem(int H, int B) {
  const int words = (H + 31) / 32;
  const size_t scan = sizeof(uint16_t) * kMaxBlock * kChunks +
                      2 * sizeof(float4) * B + 2 * sizeof(unsigned) * words +
                      2 * sizeof(uint16_t) * kChunks;
  const size_t sums = 2 * sizeof(float4) * B +
                      sizeof(float) * sc_floats(B) +
                      2 * sizeof(float4) * kSumRows +
                      sizeof(float) * kSumRows * kStats +
                      sizeof(int) * kSumRows;
  return scan > sums ? scan : sums;
}

// The block scan of P pairs of H hypotheses in blocks of B (H % B == 0,
// B <= 512) on `stream`: seeds, size and the 9 member sums of every
// (pair, type) lane; r2 and cos_gate the float32 gates. Returns
// cudaGetLastError() of the launch (0 = launched), or the error of
// setting the kernel's shared memory.
extern "C" int fccf_cluster_block_scan(const void* masks, const void* t,
                                       const void* px, const void* py,
                                       void* seeds, void* size, void* sums,
                                       int P, int H, int B, float r2,
                                       float cos_gate, void* stream) {
  if (P <= 0 || H <= 0 || B <= 0 || B > kMaxBlock || H % B != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = block_scan_smem(H, B);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_block_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ScanArgs a{(const uint8_t*)masks, (const float*)t, (const float*)px,
             (const float*)py, (uint8_t*)seeds, (float*)size, (float*)sums,
             P, H, B, r2, cos_gate};
  const int sum_blocks = P * ((H + kSumRows - 1) / kSumRows);
  const int blocks = P * kTypes * kScanCluster +
                     (sum_blocks + kScanCluster - 1) / kScanCluster *
                         kScanCluster;
  cluster_block_scan_kernel<<<blocks, kScanThreads, smem,
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
