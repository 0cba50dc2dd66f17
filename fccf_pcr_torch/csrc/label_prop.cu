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
// - Fill the card: tiles of 64 rows x BJ columns (one row a thread), BJ
//   picked by the wrapper from V and the SM count
//   (ops/label_prop.py::sweep_grid): 144 x 36 tiles of 64 x 256 at
//   V = 9216, 24 x 48 of 64 x 32 at V = 1536 on 132 SMs. The sweep entry
//   launches one block a tile, several waves on every SM; tiles past
//   bound[p] in either direction return at once.
//   Each row's partial minimum over its slice is merged with atomicMin;
//   changed[p] is set only where atomicMin lowered the label.
//   Min-relaxation is monotone, so any order of blocks reaches the same
//   fixpoint, and a sweep that lowered nothing is an exact fixpoint.
// - Skip work that cannot lower a label (exact): a row's candidate starts
//   at its current label and takes, before each 32-wide chunk of the
//   slice, whatever other blocks have lowered the label to (read from L2).
//   A j whose label is >= the candidate cannot lower it, so a warp walks
//   only the j of the chunk whose label is below its largest candidate (a
//   ballot), two at a time, tests the cheap normal predicate first, and
//   evaluates sqrtf and the division only where some lane still needs
//   them (the two j's chains interleave, which hides their latency). A
//   slice whose labels are all >= every candidate of the block is skipped
//   whole before anything is staged.
// - Asynchronous staging: the slice's 11 used fields (12 contiguous runs
//   of floats but the valid flag, which the labels encode) are copied into
//   shared memory with cp.async while the threads load their rows' fields
//   into registers: the unit normals beside each label as one float4 for
//   the cheap test, the other 8 fields field-major (16-byte copies where
//   V % 4 == 0). The slice's labels are read once, at staging time; a
//   stale label only delays a lowering by one sweep.
//
// Design of a propagation (one cooperative launch of G blocks of 64
// threads, G = min(the tiles of the whole (V, V) square of every pair,
// co-resident blocks): the occupancy query at the launch's shared memory
// times the SM count; tiles are those of the sweep entry, so a tile's
// work is the same). flags is (max_iters, P + 1) int32 zeros: row it
// holds sweep it's per-pair flags and, last, its tile counter.
// For it = 0, 1, ... while it < max_iters:
//   (a) sweep: the active tiles (ceil(nb/64) x ceil(nb/BJ), counted by
//       each block from bound[p]) of the sweep's pairs (every pair in
//       the first sweep, then only the pairs whose flag the previous
//       sweep set: a pair whose sweep lowered nothing is at its
//       fixpoint, where sweeps and halving change nothing, so skipping
//       it is exact) are handed out one at a time by an atomicAdd on
//       sweep it's tile counter, so a block that drew cheap tiles takes
//       more, as the hardware hands out the blocks of the one-sweep grid
//       (a fixed share per block, b, b + G, ..., left the phase as slow
//       as its slowest block: 53 us a heritage sweep over the one-sweep
//       grid's time on an H100). A lowered label sets flags[it, p];
//   (b) grid barrier;
//   (c) every thread reads the flags of sweep it: if no pair's flag is
//       set, every thread leaves the loop alike (the labels are then a
//       fixpoint, which halving would not change);
//   (d) halving (P1): a grid-stride pass over the P x V labels; each row
//       of a pair whose flag is set, and whose label is not 2^30, takes
//       jump_rounds rounds of l[i] = min(l[i], l[min(l[i], V - 1)]), in
//       place;
//   (e) grid barrier.
// The number of sweeps run is added to sweeps_out[0]. The labels are the
// host loop's: sweep, halve, stop after a sweep that lowered nothing,
// at most max_iters sweeps.
//
// Where it could go wrong, and why it does not:
// - Stale labels from L1. A persistent block keeps L1 lines from earlier
//   phases, and a stale, larger label of the slice could make a sweep
//   lower nothing too early: a wrong fixpoint, not a delay. So the slice's
//   labels are volatile loads (relaxed, system scope: served by L2, which
//   is coherent); the row's label before each chunk, the halving's loads
//   and the flags are __ldcg loads (L2); stores go to L2 (__stcg) and the
//   merges are L2 atomics. The row's first read of its own label stays a
//   plain load: a stale value is larger, which only narrows the block's
//   test for a slice it can skip, and the candidate takes the L2 value
//   before it is compared with any j. (__ldcg loads there and in the
//   staging took 12 more registers a thread in ptxas.) Stats are
//   read-only.
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

// One tile of a sweep of pair p: rows i0 .. i0 + 63 against the slice
// j0 .. j0 + BJ - 1, with nb = the pair's bound (i0 < nb and j0 < nb).
// Sets changed[p] where a label fell. Every thread of the block calls it,
// and its returns are uniform over the block. smem holds (NS + 1) * BJ
// floats, red_min and red_max BI / 32 ints each; a caller that runs
// another tile after this one syncs the block first, as both are reused.
__device__ __forceinline__ void sweep_tile(
    const float* __restrict__ stats, int* labels, int* changed, int p,
    int nb, int V, int BJ, int i0, int j0, float cos_gate, float l, float k,
    float* smem, int* red_min, int* red_max) {
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
    red_min[warp] = lmin;
    red_max[warp] = cmax;
  }
  __syncthreads();
  for (int w = 0; w < BI / 32; ++w) {
    lmin = min(lmin, red_min[w]);
    cmax = max(cmax, red_max[w]);
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
  float fi[NS];
#pragma unroll
  for (int f = 0; f < NS; ++f) fi[f] = cand >= 0 ? s[(size_t)f * V + i] : 0.0f;
  cp_async_wait_all();
  __syncthreads();

  bool found = false;
  for (int c0 = 0; c0 < jn; c0 += 32) {
    if (cand >= 0) cand = min(cand, __ldcg(&lab[i]));
    const int wmax = __reduce_max_sync(FULL, cand);  // the warp's largest
    const int jl = c0 + lane;
    unsigned todo =
        __ballot_sync(FULL, jl < jn && __float_as_int(shq[jl].w) < wmax);
    while (todo) {  // warp-uniform: two j a step
      const int ja = c0 + __ffs(todo) - 1;
      todo &= todo - 1;
      const bool two = todo != 0;
      const int jb = two ? c0 + __ffs(todo) - 1 : ja;
      todo &= todo - 1;
      const float4 qa = shq[ja], qb = shq[jb];
      const int la = __float_as_int(qa.w), lb = __float_as_int(qb.w);
      const float ca = fi[0] * qa.x + fi[1] * qa.y + fi[2] * qa.z;
      const float cb = fi[0] * qb.x + fi[1] * qb.y + fi[2] * qb.z;
      const bool na = la < cand && ca >= cos_gate;
      const bool nb2 = two && lb < cand && cb >= cos_gate;
      if (!__any_sync(FULL, na || nb2)) continue;
      const bool pa = plane_ok(fi, sh, BJ, ja, l, k);
      const bool pb = plane_ok(fi, sh, BJ, jb, l, k);
      if (na && pa) {
        cand = min(cand, la);
        found = true;
      }
      if (nb2 && pb) {
        cand = min(cand, lb);
        found = true;
      }
    }
  }

  if (found && atomicMin(&lab[i], cand) > cand) atomicOr(&changed[p], 1);
}

__global__ void __launch_bounds__(BI, 16)
label_prop_sweep_kernel(const float* __restrict__ stats,
                        const int* __restrict__ bound, int* labels,
                        int* changed, int V, int BJ, float cos_gate, float l,
                        float k) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int red_min[BI / 32], red_max[BI / 32];

  const int p = blockIdx.z;
  const int nb = min(bound[p], V);
  const int i0 = blockIdx.x * BI;
  const int j0 = blockIdx.y * BJ;
  if (i0 >= nb || j0 >= nb) return;  // uniform over the block
  sweep_tile(stats, labels, changed, p, nb, V, BJ, i0, j0, cos_gate, l, k,
             smem, red_min, red_max);
}

__global__ void __launch_bounds__(BI, 16)
label_prop_propagate_kernel(const float* __restrict__ stats,
                            const int* __restrict__ bound, int* labels,
                            int* flags, unsigned long long* sweeps_out,
                            int P, int V, int BJ, float cos_gate, float l,
                            float k, int max_iters, int jump_rounds) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int red_min[BI / 32], red_max[BI / 32];
  __shared__ int drawn;
  const cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  const int b = blockIdx.x;

  int it = 0;
  while (it < max_iters) {
    int* flag = flags + (size_t)it * (P + 1);
    // The pairs this sweep works on: every pair in the first sweep, then
    // only those whose previous sweep lowered a label (the others are at
    // their fixpoint). Their tiles, counted alike by every block.
    const int* prev = it > 0 ? flags + (size_t)(it - 1) * (P + 1) : nullptr;
    int total = 0;
    for (int p = 0; p < P; ++p) {
      const int nb = min(bound[p], V);
      if (nb > 0 && (prev == nullptr || __ldcg(&prev[p]) != 0))
        total += ((nb + BI - 1) / BI) * ((nb + BJ - 1) / BJ);
    }
    // (a) Sweep: draw tiles from the counter flag[P] until none is left;
    // tile t of pair p is (row tile t % rows, slice t / rows), rows
    // fastest, as the one-sweep grid orders them.
    for (;;) {
      if (threadIdx.x == 0) drawn = atomicAdd(&flag[P], 1);
      __syncthreads();
      int t = drawn;
      if (t >= total) break;  // uniform over the block
      int p = 0, nb = 0, rows = 1;
      for (;; ++p) {
        nb = min(bound[p], V);
        if (nb <= 0 || (prev != nullptr && __ldcg(&prev[p]) == 0)) continue;
        rows = (nb + BI - 1) / BI;
        const int n = rows * ((nb + BJ - 1) / BJ);
        if (t < n) break;
        t -= n;
      }
      sweep_tile(stats, labels, flag, p, nb, V, BJ, (t % rows) * BI,
                 (t / rows) * BJ, cos_gate, l, k, smem, red_min, red_max);
      __syncthreads();  // smem, red_* and drawn are reused by the next tile
    }
    grid.sync();
    ++it;
    // (c) Uniform over the grid: every thread reads the same flags.
    bool lowered = false;
    for (int p = 0; p < P; ++p) lowered |= __ldcg(&flag[p]) != 0;
    if (!lowered) break;
    // (d) Path halving, in place, of the pairs this sweep lowered (at a
    // fixpoint it changes nothing); invalid slots stay at BIG.
    if (jump_rounds > 0) {
      const int n = P * V;
      for (int e = b * BI + threadIdx.x; e < n; e += G * BI) {
        const int p = e / V;
        if (__ldcg(&flag[p]) == 0) continue;
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
  if (b == 0 && threadIdx.x == 0) atomicAdd(sweeps_out, (unsigned long long)it);
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
  const size_t shmem = (size_t)(NS + 1) * BJ * sizeof(float);
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
  void* args[] = {&stats_, &bound_,   &labels_, &flags_,    &sweeps_,
                  &P,      &V,        &BJ,      &cos_gate,  &l,
                  &k,      &max_iters, &jump_rounds};
  err = cudaLaunchCooperativeKernel((const void*)label_prop_propagate_kernel,
                                    dim3(G), dim3(BI), args, shmem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
