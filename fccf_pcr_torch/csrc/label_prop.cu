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
// (P, V) int32; bound (P,) int32; changed (P,) int32.
//
// Design. Grid (ceil(V / BI), P); each thread owns one row i and keeps its
// fields in registers; the block stages j-chunks of BI voxels' fields and
// labels in shared memory and walks them up to bound[p]. Rows at or past
// the bound and invalid rows are skipped; the tail of V is masked, so V
// needs no multiple of any block size. Blocks run in any order and race
// on labels: min-relaxation is monotone, so every interleaving reaches
// the same fixpoint, and a sweep in which no thread lowered a label is an
// exact fixpoint. A thread that lowers its label sets changed[p] with
// atomicOr; the wrapper stops when a whole sweep leaves every flag 0.
//
// Cost. At the office preset (V = 1536) a sweep evaluates V^2 pairs at
// ~30 flops each and reads only V * NF * 4 bytes per block, so it is bound
// by predicate arithmetic, not bytes. Build with --fmad=false so the
// predicate rounds like the plain version's separate multiplies and adds
// near its boundaries (cos 5 deg = 0.9962). Tiling rows over more threads,
// and moving the dot products onto wgmma, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BI = 64;  // rows per block == j-chunk width
constexpr int NF = 12;  // fields per voxel
constexpr int BIG = 1 << 30;

__global__ void __launch_bounds__(BI)
label_prop_sweep_kernel(const float* __restrict__ stats,
                        const int* __restrict__ bound, int* labels,
                        int* changed, int V, float cos_gate, float l,
                        float k) {
  const int p = blockIdx.y;
  const int nb = min(bound[p], V);
  const int i0 = blockIdx.x * BI;
  if (i0 >= nb) return;  // uniform over the block: no barrier is skipped

  const float* s = stats + (size_t)p * NF * V;
  int* lab = labels + (size_t)p * V;
  const int tid = threadIdx.x;
  const int i = i0 + tid;

  __shared__ float sh[NF][BI];
  __shared__ int shl[BI];

  float fi[NF];
  const bool row = i < nb && s[11 * V + i] > 0.5f;
#pragma unroll
  for (int f = 0; f < NF; ++f) fi[f] = row ? s[f * V + i] : 0.0f;

  int cand = BIG;
  for (int j0 = 0; j0 < nb; j0 += BI) {
    const int j = j0 + tid;
    if (j < nb) {
#pragma unroll
      for (int f = 0; f < NF; ++f) sh[f][tid] = s[f * V + j];
      shl[tid] = lab[j];
    } else {
      sh[11][tid] = 0.0f;
      shl[tid] = BIG;
    }
    __syncthreads();
    if (row) {
      const int jn = min(BI, nb - j0);
      for (int jj = 0; jj < jn; ++jj) {
        if (!(sh[11][jj] > 0.5f)) continue;
        const float cosm =
            fi[0] * sh[0][jj] + fi[1] * sh[1][jj] + fi[2] * sh[2][jj];
        const float cicj =
            fi[3] * sh[3][jj] + fi[4] * sh[4][jj] + fi[5] * sh[5][jj];
        const float d2 = fi[7] + sh[7][jj] - 2.0f * cicj;
        const float dist = sqrtf(fmaxf(d2, 0.0f));
        const float m1 =
            fi[6] - (fi[8] * sh[3][jj] + fi[9] * sh[4][jj] + fi[10] * sh[5][jj]);
        const float m2 =
            (fi[3] * sh[8][jj] + fi[4] * sh[9][jj] + fi[5] * sh[10][jj]) - sh[6][jj];
        const float t = l / (k * dist + 1.0f);
        const float td = t * dist;
        const bool plane = !(dist > 1e-9f) || (fabsf(m1) < td && fabsf(m2) < td);
        if (cosm >= cos_gate && plane) cand = min(cand, shl[jj]);
      }
    }
    __syncthreads();
  }

  if (row && cand < lab[i]) {  // only this thread writes lab[i]
    lab[i] = cand;
    atomicOr(&changed[p], 1);
  }
}

}  // namespace

// One sweep for P pairs on `stream`. Returns cudaGetLastError() of the
// launch (0 = launched).
extern "C" int fccf_label_prop_sweep(const void* stats, const void* bound,
                                     void* labels, void* changed, int P,
                                     int V, float cos_gate, float l, float k,
                                     void* stream) {
  if (P <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((V + BI - 1) / BI, P);
  label_prop_sweep_kernel<<<grid, BI, 0, (cudaStream_t)stream>>>(
      (const float*)stats, (const int*)bound, (int*)labels, (int*)changed, V,
      cos_gate, l, k);
  return (int)cudaGetLastError();
}
