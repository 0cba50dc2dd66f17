// Label-propagation sweep over the voxel affinity graph, for Hopper (sm_90a).
//
// Replaces fccf_pcr_tpu/ops/pallas/label_prop.py::_sweep_kernel. One launch
// is one sweep for every pair p of a batch:
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
// cos-5 deg predicate (TF32 is off throughout the port).
//
// Design.
// - Fill the card: grid (row tiles, j slices, P) of 64-row x BJ-column
//   tiles (one row a thread), BJ picked by the wrapper from V and the SM
//   count (ops/label_prop.py::sweep_grid): 144 x 36 tiles of 64 x 256 at
//   V = 9216, 24 x 48 of 64 x 32 at V = 1536 on 132 SMs, several waves of
//   blocks on every SM. Blocks past bound[p] in either direction return
//   at once.
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

#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(BI, 16)
label_prop_sweep_kernel(const float* __restrict__ stats,
                        const int* __restrict__ bound, int* labels,
                        int* changed, int V, int BJ, float cos_gate, float l,
                        float k) {
  // shq[jj] = (nh_j, label_j); then sh[f * BJ + jj] for the fields f >= 3
  extern __shared__ __align__(16) float smem[];
  __shared__ int red_min[BI / 32], red_max[BI / 32];

  const int p = blockIdx.z;
  const int nb = min(bound[p], V);
  const int i0 = blockIdx.x * BI;
  const int j0 = blockIdx.y * BJ;
  if (i0 >= nb || j0 >= nb) return;  // uniform over the block
  const int jn = min(BJ, nb - j0);

  const float* s = stats + (size_t)p * NF * V;
  int* lab = labels + (size_t)p * V;
  float4* shq = reinterpret_cast<float4*>(smem);
  float* sh = smem + BJ;  // sh[f * BJ + jj], f >= 3, starts after shq
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // The slice's labels, and each row's candidate: its current label, or
  // -1 for a row that no label can lower (past the bound, or invalid).
  int lmin = BIG;
  for (int jj = tid; jj < jn; jj += BI) {
    const int v = lab[j0 + jj];
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
