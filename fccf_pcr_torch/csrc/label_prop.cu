// Label propagation over the voxel affinity graph, for Hopper (sm_90a).
//
// Two entry points share one tile body:
//
// - fccf_label_prop_sweep: one launch is one sweep for every pair p of a
//   batch. Replaces fccf_pcr_tpu/ops/pallas/label_prop.py::_sweep_kernel.
// - fccf_label_prop_propagate: one launch is a whole propagation (sweep,
//   path halving, convergence test, repeated) as a persistent cooperative
//   kernel. The halving is the redesign of tools/probe_gather.py::kernel
//   (P1), the per-lane gather label[label] that the TPU could not lower
//   inside its sweep kernel and so ran between kernel calls; the loop is
//   the reference's device-side lax.while_loop (label_prop.py:294-306).
//
// A sweep is
//
//   labels[p, i] = min(labels[p, i], min over affine j < bound[p] of labels[p, j])
//
// for every valid row i < bound[p]. Affinity is the compare_normal &
// compare_plane predicate (FCCF.cpp:369-407) in the form of the JAX
// package's _pairwise_affinity (features/faces.py:58-82), evaluated on the
// fly from per-voxel stats, so no (V, V) matrix exists:
//
//   cos(nh_i, nh_j) >= cos_gate, and
//   |m1| < t*d and |m2| < t*d with t = l / (k*d + 1), or d <= 1e-9,
//   m1 = rn_i.(c_i - c_j), m2 = rn_j.(c_i - c_j), d = |c_i - c_j|,
//   both voxels valid.
//
// Layout: stats are field-major (P, NF, V) float32, fields
// [nhx, nhy, nhz, cx, cy, cz, rn.c, |c|^2, rnx, rny, rnz, valid]; labels
// (P, V) int32, invalid slots hold 2^30; bound (P,) int32; changed (P,)
// int32.
//
// Bound. A sweep needs the normal test (3 multiplies, 2 adds, a compare)
// for the pairs (i, j) below the bound whose j label is below i's, and
// the plane test (12 multiplies, 11 adds, fmaxf, sqrtf, the division and
// 3 compares: 29 operations) only for those among them that pass it,
// against 12 * V * 4 bytes of stats: it is bound by the float32 pipe
// (67 TFLOP/s on an H100 SXM), not by bytes. Built with --fmad=false,
// so that the predicate rounds like the plain version's separate
// multiplies and adds near its boundaries (cos 5 deg = 0.9962): every
// multiply and add issues alone, and at most half that peak is reachable.
// No tensor cores: the four dot products of a pair are K = 3 products,
// too shallow for wgmma, whose float32 input is TF32, and TF32 flips the
// cos-5 deg predicate (TF32 is off throughout the port). A halving round
// reads and writes V labels a pair: bound by bytes, far below a launch.
//
// Design of a sweep.
// - Fill the card: tiles of 64 rows x BJ columns (one row a thread). The
//   one-sweep entry takes BJ from the wrapper, sized from V and the SM
//   count (ops/label_prop.py::sweep_grid: 144 x 36 tiles of 64 x 256 at
//   V = 9216, 24 x 48 of 64 x 32 at V = 1536 on 132 SMs) and launches one
//   block a tile; tiles past bound[p] in either direction return at once.
//   The propagation sizes each pair's tiles from its bound instead (below).
//   Each row's partial minimum over its slice is merged with atomicMin;
//   changed[p] is set only where atomicMin lowered the label.
//   Min-relaxation is monotone, so any order of blocks reaches the same
//   fixpoint, and a sweep that lowered nothing is an exact fixpoint.
// - Skip work that cannot lower a label (exact): a row's candidate starts
//   at its current label and takes, before each 32-wide chunk of the
//   slice, whatever other blocks (read from L2) or its own plane tests
//   have lowered it to. A j whose label is >= the candidate cannot lower
//   it, so a warp walks only the j of the chunk whose label is below its
//   largest candidate (a ballot). A slice whose labels are all >= every
//   candidate of the block is skipped whole before anything is staged.
// - Full warps for the plane test: for each chunk of 32 j, every lane
//   runs its own row's cheap normal test against the chunk's j (two a
//   step, for their latency), and a ballot a j gives the rows that pass it
//   (and whose candidate is above j's label), kept by lane j of the
//   chunk. Then each lane runs the plane test (sqrtf and the division) of
//   its j against those rows only, the row's fields read from shared
//   memory, and a pair that passes lowers the row's candidate there with
//   a shared atomicMin. These are exactly the pairs the test ran for
//   before (a row's candidate only falls), so the labels do not change;
//   what changes is that the plane test runs only where it is needed
//   (a third of the normal test's pairs at heritage's first pass, where a
//   warp used to run it on all 32 rows for any row that needed it).
// - Asynchronous staging: the slice's 11 used fields (12 contiguous runs
//   of floats but the valid flag, which the labels encode) are copied into
//   shared memory with cp.async while the threads load their rows' fields:
//   the unit normals beside each label as one float4 for the cheap test,
//   the other 8 fields field-major (16-byte copies where V % 4 == 0). The
//   slice's labels are read once, at staging time; a stale label only
//   delays a lowering by one sweep.
//
// Design of a propagation (one cooperative launch of G blocks of 64
// threads, G = min(the tiles of the whole (V, V) square of every pair,
// co-resident blocks): the occupancy query at the launch's shared memory
// times the SM count). flags is (max_iters, P + 1) int32 zeros: row it
// holds sweep it's per-pair flags and, last, its tile counter. At the
// launch's start every block sizes each pair's slices from its bound nb
// (slice_width: the widest, up to the wrapper's BJ for V, that gives 32
// tiles per SM; 64 x 256 at heritage's nb ~ 8500 whether V is 9216 or
// 16384), so the tiles cover the pair's nb x nb square and no more.
// For it = 0, 1, ... while it < max_iters:
//   (a) sweep: the active tiles of the sweep's pairs (every pair in the
//       first sweep, then only the pairs whose flag the previous sweep
//       set: a pair whose sweep lowered nothing is at its fixpoint, where
//       sweeps and halving change nothing, so skipping it is exact),
//       counted by a prefix over the pairs, are handed out one at a time
//       by an atomicAdd on sweep it's tile counter, so a block that drew
//       cheap tiles takes more. A lowered label sets flags[it, p];
//   (b) grid barrier;
//   (c) every thread reads the flags of sweep it: if no pair's flag is
//       set, every thread leaves the loop alike (the labels are then a
//       fixpoint, which halving would not change);
//   (d) halving (P1): a grid-stride pass over the rows below the bound of
//       the pairs whose flag is set; each row whose label is not 2^30
//       takes jump_rounds rounds of l[i] = min(l[i], l[min(l[i], V - 1)]),
//       in place;
//   (e) grid barrier.
// The number of sweeps run is added to sweeps_out[0]. The labels are the
// host loop's: sweep, halve, stop after a sweep that lowered nothing, at
// most max_iters sweeps. (Folding the halving into the next sweep's
// staging, one barrier a sweep, measured slower on the H100: the sweep
// that verifies the fixpoint then lowers labels itself, so one more
// sweep runs, 5 instead of 4 at the heritage step's first launch.)
//
// Where it could go wrong, and why it does not:
// - Stale labels from L1. A persistent block keeps L1 lines from earlier
//   phases, and a stale, larger label of the slice could make a sweep
//   lower nothing too early: a wrong fixpoint, not a delay. So the slice's
//   labels are volatile loads (relaxed, system scope: served by L2, which
//   is coherent); the row's label before each chunk, the halving's loads
//   and the flags are __ldcg loads (L2); the halving's stores go to L2
//   (__stcg) and the merges are L2 atomics. The row's first read of its
//   own label stays a plain load: a stale value is larger, which only
//   narrows the block's test for a slice it can skip, and the candidate
//   takes the L2 value before it is compared with any j. (__ldcg loads
//   there and in the staging took 12 more registers a thread in ptxas.)
//   The rows' candidates live in shared memory, each lowered only by its
//   own warp. Stats are read-only.
// - Flags. Each iteration has its own flag slots and tile counter,
//   zeroed by the wrapper before the launch: one slot reused would need
//   zeroing while a slower block may still read it.
// - In-place halving races with other threads of the same phase. Only
//   row i's thread writes l[i] in that phase, and sweeps are fenced off
//   by the barriers. Every label is the index of a node of its row's
//   component and labels only fall, so whichever value of l[l[i]] a
//   thread reads, old or new, is a node of i's component no smaller than
//   the component minimum: the write keeps both invariants. A sweep that
//   lowers nothing then means l[i] <= l[j] on every edge, so labels are
//   constant on each component and equal its minimum, the plain version's
//   fixpoint. Labels after a max_iters cap may differ between schedules,
//   as they already do between the atomic sweep and the Jacobi plain one.
// - Co-residency: the grid barrier deadlocks if any block is not
//   resident, so G comes from the occupancy query, never from the tile
//   count alone, and cudaLaunchCooperativeKernel refuses a grid that does
//   not fit. A card without cooperative launch returns an error: the
//   wrapper raises and never falls back to the host loop.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NF = 12;  // fields per voxel in stats
constexpr int NS = 11;  // fields staged: all but the valid flag
constexpr int BIG = 1 << 30;
constexpr int BI = 64;   // rows of a tile, one thread each
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The plane test of row fields fi against staged voxel jj, in the
// expression order of the plain version (ops/label_prop.py::
// pairwise_affinity).
__device__ __forceinline__ bool plane_ok(const float* fi, const float* sh,
                                         int BJ, int jj, float l, float k) {
  const float cj3 = sh[3 * BJ + jj], cj4 = sh[4 * BJ + jj],
              cj5 = sh[5 * BJ + jj];
  const float cicj = fi[3] * cj3 + fi[4] * cj4 + fi[5] * cj5;
  const float d2 = fi[7] + sh[7 * BJ + jj] - 2.0f * cicj;
  const float dist = sqrtf(fmaxf(d2, 0.0f));
  const float m1 = fi[6] - (fi[8] * cj3 + fi[9] * cj4 + fi[10] * cj5);
  const float m2 = (fi[3] * sh[8 * BJ + jj] + fi[4] * sh[9 * BJ + jj] +
                    fi[5] * sh[10 * BJ + jj]) -
                   sh[6 * BJ + jj];
  const float t = l / (k * dist + 1.0f);
  const float td = t * dist;
  return !(dist > 1e-9f) || (fabsf(m1) < td && fabsf(m2) < td);
}

// Shared memory of a tile beside the staged slice: the rows' fields
// 3..10, each row's candidate and found flag, the block's reductions.
struct TileShared {
  float rowf[NS - 3][BI];
  int cand[BI];
  int found[BI];
  int red_min[BI / 32], red_max[BI / 32];
};

// One tile of a sweep of pair p: rows i0 .. i0 + 63 against the slice
// j0 .. j0 + BJ - 1, with nb = the pair's bound (i0 < nb and j0 < nb).
// Sets changed[p] where a label fell. Every thread of the block calls it,
// and its returns are uniform over the block. smem holds (NS + 1) * BJ
// floats; a caller that runs another tile after this one syncs the block
// first, as smem and ts are reused.
__device__ __forceinline__ void sweep_tile(
    const float* __restrict__ stats, int* labels, int* changed, int p,
    int nb, int V, int BJ, int i0, int j0, float cos_gate, float l, float k,
    float* smem, TileShared& ts) {
  const int jn = min(BJ, nb - j0);

  const float* s = stats + (size_t)p * NF * V;
  int* lab = labels + (size_t)p * V;
  // shq[jj] = (nh_j, label_j); then sh[f * BJ + jj] for the fields f >= 3
  float4* shq = reinterpret_cast<float4*>(smem);
  float* sh = smem + BJ;  // sh[f * BJ + jj], f >= 3, starts after shq
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // The slice's labels, and each row's candidate: its current label, or
  // -1 for a row that no label can lower (past the bound, or invalid).
  int lmin = BIG;
  for (int jj = tid; jj < jn; jj += BI) {
    const int v = *reinterpret_cast<const volatile int*>(&lab[j0 + jj]);
    shq[jj].w = __int_as_float(v);
    lmin = min(lmin, v);
  }
  const int i = i0 + tid;
  int cand = -1;
  if (i < nb) {
    const int li = lab[i];
    if (li < BIG) cand = li;
  }
  lmin = __reduce_min_sync(FULL, lmin);
  int cmax = __reduce_max_sync(FULL, cand);
  if (lane == 0) {
    ts.red_min[warp] = lmin;
    ts.red_max[warp] = cmax;
  }
  __syncthreads();
  for (int w = 0; w < BI / 32; ++w) {
    lmin = min(lmin, ts.red_min[w]);
    cmax = max(cmax, ts.red_max[w]);
  }
  if (lmin >= cmax) return;  // no label of the slice lowers any row

  // Stage the slice's fields asynchronously; meanwhile load the row's.
  for (int e = tid; e < 3 * jn; e += BI) {
    const int f = e / jn;
    const int jj = e - f * jn;
    cp_async4(reinterpret_cast<float*>(shq + jj) + f,
              s + (size_t)f * V + j0 + jj);
  }
  if ((V & 3) == 0 && (j0 & 3) == 0) {
    // 16-byte copies; the last may read up to 3 floats past jn, still
    // inside the field's run since nb <= V and V % 4 == 0.
    const int nv = (jn + 3) >> 2;
    for (int e = tid; e < (NS - 3) * nv; e += BI) {
      const int f = 3 + e / nv;
      const int q = 4 * (e - (f - 3) * nv);
      cp_async16(sh + f * BJ + q, s + (size_t)f * V + j0 + q);
    }
  } else {
    for (int e = tid; e < (NS - 3) * jn; e += BI) {
      const int f = 3 + e / jn;
      const int jj = e - (f - 3) * jn;
      cp_async4(sh + f * BJ + jj, s + (size_t)f * V + j0 + jj);
    }
  }
  float nh[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) nh[f] = cand >= 0 ? s[(size_t)f * V + i] : 0.0f;
#pragma unroll
  for (int f = 3; f < NS; ++f)
    ts.rowf[f - 3][tid] = cand >= 0 ? s[(size_t)f * V + i] : 0.0f;
  ts.cand[tid] = cand;
  ts.found[tid] = 0;
  cp_async_wait_all();
  __syncthreads();

  // A chunk of 32 j at a time: each lane runs the cheap normal test of
  // its row against the chunk's j whose label is below the warp's largest
  // candidate, two j a step; lane b keeps, as bits, the rows that passed
  // with j = c0 + b. Then each lane runs the plane test of its j against
  // those rows, the row's fields read from shared memory.
  volatile int* vcand = ts.cand;
  for (int c0 = 0; c0 < jn; c0 += 32) {
    if (cand >= 0) cand = min(min(cand, __ldcg(&lab[i])), vcand[tid]);
    const int wmax = __reduce_max_sync(FULL, cand);  // the warp's largest
    const int jl = c0 + lane;
    unsigned todo =
        __ballot_sync(FULL, jl < jn && __float_as_int(shq[jl].w) < wmax);
    unsigned rows_of_j = 0;
    while (todo) {  // warp-uniform
      const int ba = __ffs(todo) - 1;
      todo &= todo - 1;
      const bool two = todo != 0;
      const int bb = two ? __ffs(todo) - 1 : ba;
      todo &= todo - 1;
      const float4 qa = shq[c0 + ba], qb = shq[c0 + bb];
      const float ca = nh[0] * qa.x + nh[1] * qa.y + nh[2] * qa.z;
      const float cb = nh[0] * qb.x + nh[1] * qb.y + nh[2] * qb.z;
      const unsigned ma =
          __ballot_sync(FULL, __float_as_int(qa.w) < cand && ca >= cos_gate);
      const unsigned mb = __ballot_sync(
          FULL, two && __float_as_int(qb.w) < cand && cb >= cos_gate);
      if (lane == ba) rows_of_j = ma;
      if (two && lane == bb) rows_of_j = mb;
    }
    if (rows_of_j) {
      const int jj = c0 + lane;
      const int lj = __float_as_int(shq[jj].w);
      while (rows_of_j) {
        const int r = warp * 32 + __ffs(rows_of_j) - 1;
        rows_of_j &= rows_of_j - 1;
        float fi[NS];
#pragma unroll
        for (int f = 3; f < NS; ++f) fi[f] = ts.rowf[f - 3][r];
        if (plane_ok(fi, sh, BJ, jj, l, k)) {
          atomicMin(&ts.cand[r], lj);
          ts.found[r] = 1;
        }
      }
    }
    __syncwarp();
  }
  if (cand >= 0 && ts.found[tid]) {
    const int c = min(cand, vcand[tid]);
    if (atomicMin(&lab[i], c) > c) atomicOr(&changed[p], 1);
  }
}

// The slice width of a pair's tiles from its bound nb: the widest (<=
// cap) that still gives 32 tiles per SM, as ops/label_prop.py::sweep_grid
// sizes the one-sweep grid from V.
__device__ __forceinline__ int slice_width(int nb, int sms, int cap) {
  const int rows = (nb + BI - 1) / BI;
  int bj = cap;
  while (bj > 32 && rows * ((nb + bj - 1) / bj) < 32 * sms) bj >>= 1;
  return bj;
}

__global__ void __launch_bounds__(BI, 16)
label_prop_sweep_kernel(const float* __restrict__ stats,
                        const int* __restrict__ bound, int* labels,
                        int* changed, int V, int BJ, float cos_gate, float l,
                        float k) {
  extern __shared__ __align__(16) float smem[];
  __shared__ TileShared ts;

  const int p = blockIdx.z;
  const int nb = min(bound[p], V);
  const int i0 = blockIdx.x * BI;
  const int j0 = blockIdx.y * BJ;
  if (i0 >= nb || j0 >= nb) return;  // uniform over the block
  sweep_tile(stats, labels, changed, p, nb, V, BJ, i0, j0, cos_gate, l, k,
             smem, ts);
}

__global__ void __launch_bounds__(BI, 16)
label_prop_propagate_kernel(const float* __restrict__ stats,
                            const int* __restrict__ bound, int* labels,
                            int* flags, unsigned long long* sweeps_out,
                            int P, int V, int BJ, int sms, float cos_gate,
                            float l, float k, int max_iters,
                            int jump_rounds) {
  extern __shared__ __align__(16) float smem[];
  __shared__ TileShared ts;
  __shared__ int drawn;
  // After the slice: each pair's slice width, row tiles and the prefix of
  // the sweep's tiles over its pairs.
  int* bj = reinterpret_cast<int*>(smem + (NS + 1) * BJ);
  int* rows = bj + P;
  int* pre = rows + P;
  const cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int p = tid; p < P; p += BI) {
    const int nb = max(min(bound[p], V), 0);
    bj[p] = slice_width(nb, sms, BJ);
    rows[p] = (nb + BI - 1) / BI;
  }
  __syncthreads();

  int it = 0;
  while (it < max_iters) {
    int* flag = flags + (size_t)it * (P + 1);
    // The pairs this sweep works on: every pair in the first sweep, then
    // only those whose previous sweep lowered a label (the others are at
    // their fixpoint), and the prefix of their tiles.
    const int* prev = it > 0 ? flags + (size_t)(it - 1) * (P + 1) : nullptr;
    if (tid == 0) {
      int total = 0;
      for (int p = 0; p < P; ++p) {
        pre[p] = total;
        const int nb = min(bound[p], V);
        if (nb > 0 && (prev == nullptr || __ldcg(&prev[p]) != 0))
          total += rows[p] * ((nb + bj[p] - 1) / bj[p]);
      }
      pre[P] = total;
    }
    __syncthreads();
    // (a) Sweep: draw tiles from the counter flag[P] until none is left;
    // tile t of pair p is (row tile t % rows, slice t / rows), rows
    // fastest, as the one-sweep grid orders them.
    const int total = pre[P];
    for (;;) {
      if (tid == 0) drawn = atomicAdd(&flag[P], 1);
      __syncthreads();
      const int t = drawn;
      if (t >= total) break;  // uniform over the block
      int p = 0;
      while (pre[p + 1] <= t) ++p;
      const int u = t - pre[p];
      sweep_tile(stats, labels, flag, p, min(bound[p], V), V, bj[p],
                 (u % rows[p]) * BI, (u / rows[p]) * bj[p], cos_gate, l, k,
                 smem, ts);
      __syncthreads();  // smem, ts and drawn are reused by the next tile
    }
    grid.sync();
    ++it;
    // (c) Uniform over the grid: every thread reads the same flags.
    bool lowered = false;
    for (int p = 0; p < P; ++p) lowered |= __ldcg(&flag[p]) != 0;
    if (!lowered) break;
    // (d) Path halving, in place, of the rows below the bound of the
    // pairs this sweep lowered (at a fixpoint it changes nothing); invalid
    // slots stay at BIG.
    if (jump_rounds > 0) {
      const int G = gridDim.x;
      for (int e = b * BI + tid; e < P * V; e += G * BI) {
        const int p = e / V;
        if (e - p * V >= min(bound[p], V) || __ldcg(&flag[p]) == 0) continue;
        const int* row = labels + (size_t)p * V;
        const int x0 = __ldcg(&labels[e]);
        if (x0 >= BIG) continue;
        int x = x0;
        for (int r = 0; r < jump_rounds; ++r)
          x = min(x, __ldcg(&row[min(x, V - 1)]));
        if (x < x0) __stcg(&labels[e], x);
      }
    }
    grid.sync();
  }
  if (b == 0 && tid == 0) atomicAdd(sweeps_out, (unsigned long long)it);
}

}  // namespace

// One sweep for P pairs on `stream`, in (ceil(V / 64), ceil(V / BJ), P)
// blocks of 64 threads (BJ a multiple of 32, at most 512).
// Returns cudaGetLastError() of the launch (0 = launched).
extern "C" int fccf_label_prop_sweep(const void* stats, const void* bound,
                                     void* labels, void* changed, int P,
                                     int V, int BJ, float cos_gate,
                                     float l, float k, void* stream) {
  if (P <= 0 || V <= 0 || BJ < 32 || BJ > 512 || BJ % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((V + BI - 1) / BI, (V + BJ - 1) / BJ, P);
  const size_t shmem = (size_t)(NS + 1) * BJ * sizeof(float);
  label_prop_sweep_kernel<<<grid, BI, shmem, (cudaStream_t)stream>>>(
      (const float*)stats, (const int*)bound, (int*)labels, (int*)changed, V,
      BJ, cos_gate, l, k);
  return (int)cudaGetLastError();
}

// A whole propagation for P pairs on `stream`, as one cooperative launch
// on the current device: at most max_iters sweeps, each followed by
// jump_rounds path-halving rounds, until a sweep lowers no label. flags
// is (max_iters, P + 1) int32, all zero; sweeps_out one uint64 to which
// the number of sweeps run is added. BJ as for fccf_label_prop_sweep.
// Returns 0 once launched, else the CUDA error: cudaErrorNotSupported on
// a device without cooperative launch, the launch's own error where it
// is refused.
extern "C" int fccf_label_prop_propagate(const void* stats, const void* bound,
                                         void* labels, void* flags,
                                         void* sweeps_out, int P, int V,
                                         int BJ, float cos_gate, float l,
                                         float k, int max_iters,
                                         int jump_rounds, void* stream) {
  if (P <= 0 || V <= 0 || BJ < 32 || BJ > 512 || BJ % 32 != 0 ||
      max_iters < 0 || jump_rounds < 0 || (long long)P * V > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t shmem =
      (size_t)(NS + 1) * BJ * sizeof(float) + (size_t)(3 * P + 1) * sizeof(int);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, label_prop_propagate_kernel, BI, shmem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return (int)err;

  const long long tiles =
      (long long)P * ((V + BI - 1) / BI) * ((V + BJ - 1) / BJ);
  const int G = (int)(tiles < (long long)per_sm * sms ? tiles
                                                      : (long long)per_sm * sms);
  const float* stats_ = (const float*)stats;
  const int* bound_ = (const int*)bound;
  int* labels_ = (int*)labels;
  int* flags_ = (int*)flags;
  unsigned long long* sweeps_ = (unsigned long long*)sweeps_out;
  void* args[] = {&stats_, &bound_, &labels_,   &flags_,      &sweeps_,
                  &P,      &V,      &BJ,        &sms,         &cos_gate,
                  &l,      &k,      &max_iters, &jump_rounds};
  err = cudaLaunchCooperativeKernel((const void*)label_prop_propagate_kernel,
                                    dim3(G), dim3(BI), args, shmem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
