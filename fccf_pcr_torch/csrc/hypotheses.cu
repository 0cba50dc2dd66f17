// The hypotheses stage on Hopper (sm_90a), with a plain C interface bound
// with ctypes by fccf_pcr_torch/ops/hypotheses_kernels.py. It replaces no
// Pallas kernel: the JAX package's compiled program runs the stage
// (fccf_pcr_tpu/hypotheses/bases.py:40 select_bases and
// fccf_pcr_tpu/hypotheses/transforms.py:161 generate_hypotheses, with
// _match_one at :78 vmapped over the matches and lax.top_k at :217) as
// fused XLA loops, where the port ran it as some 450 PyTorch kernels a
// step, a stable sort of every match's F * F + 1 slots among them.
//
// H1, fccf_hyp_matches, a cluster of kMatchRanks (8) blocks a pair: both
// clouds' bases formed from their faces (the face pairs i < j in
// triu_indices order, their angle, type and validity), the B x B
// compatibility mask in b1-major order (both valid, |angle difference| <
// angle_same, the same type) and its stable compaction to M matches.
// What bounded a block a pair: 8 SMs busy at batch 8, 240 of 1024
// threads forming bases, the mask walked twice by runs of entries with a
// division an entry. Here rank r takes the b1 rows [r rows, (r + 1) rows)
// and forms cloud 2's B bases and its own rows of cloud 1's; a warp a row
// holds the row's angle and type in registers and ballots over cloud 2's
// bases 32 a round (no division), counting the row and keeping its
// ballot words where they fit in shared memory (else the write pass takes
// them again: F = 96; kept, ~0.2 us faster at the presets, PERF.md); a
// block scan of the rows' counts gives each row's place in the rank, and
// the ranks' totals, read through the cluster's shared memory, the ranks
// before it; the write pass places each match at its row's place plus the
// set lanes below it, drops places past M, and the ranks share the empty
// places' fill. By phase (PERF.md): launch
// ~2 us, then the cluster barrier the largest, then the bases.
// fccf_hyp_bases writes the bases alone (select_bases on a card), one
// block a face set, with the same device code.
//
// H2, fccf_hyp_slots, a block of kSlotThreads (256) a chunk of up to
// kSlotChunk (32) consecutive matches of a pair (fewer where F needs more
// shared memory), grid (M / C, P). What bounded a warp a match: the
// prelude on one lane while 31 waited, each match's source faces formed
// anew, all F x F slots tested. Here:
//   - the runs of equal source bases (i1, j1) are found from the matches
//     given (a chunk's first match starts one), so any Matches will do;
//     per run the source faces' third-plane tests and P = inv(A^T A) A^T,
//     per chunk each source face's |normal| and d13, formed once;
//   - warp 0, a lane a match, forms the chunk's preludes (R = R2 R1 with
//     R1 m2, n2 x m2r normalized, the offsets d11 - d21 and d12 - d22, the
//     fallback translation, the quaternion) while the other warps form
//     the runs' source faces; then a thread a (match, target face) the
//     rotated normal, its test, norm and d23;
//   - a warp a match (w, w + 8, ...) lists the source faces of its run and
//     its target faces that pass (two ballots), and tests only the (s, t)
//     slots both pass, s-major, which is slot order, 32 at a time (slot e
//     is list entries (e / nt, e % nt), moved by 32 a round without a
//     division), ranked by the warp's ballot: the first PER_MATCH have
//     their translation T3 written to (M, PER_MATCH); the fallback slot
//     F * F is valid where no slot is. No round begins once more than
//     PER_MATCH slots are valid (an ineligible slot is never valid, so
//     the kept hits, counts and overflow are the full test's). A row's
//     entries past its count are not written (H3 reads none).
// By phase (PERF.md): launch ~2 us; of a block's cycles the slot
// rounds over half, not their arithmetic (acosf, the division and the
// hits' stores out of them change little), then the preludes and the
// target faces.
//
// H3, fccf_hyp_emit, a block of kEmitThreads (128) a run of as many
// matches of a pair, a thread a match, grid (M / 128, P). What bounded a
// thread a place of H: every block of a pair scanned all M counts again
// by loads 32 B apart, three barriers before a place was written, and
// each place paid a binary search over M ends in shared memory (which
// also capped M). Here each block starts all its loads of the pair's
// counts at once (int4 where a row is 16-byte aligned), a warp scans its
// 32 matches' counts by shuffles, and one barrier gives each warp where
// its run of places starts. Which match and hit a place of the run takes
// does not depend on that start, so the run's first 64 places are
// gathered before the barrier: lane l takes places l, l + 32, ...
// (kEmitPlaces rounds at once), each place's match the first lane whose
// scanned end is past it (5 shuffles), its quaternion one float4. The
// places past the kept hits hold +0.0 and 0, split over the pair's
// blocks and stored while the gathers are in flight; block 0 also reads
// the rows' overflow flags and writes the count and the overflow (H's,
// the matches' or any row's). A run past 64 places takes its later
// rounds in turn, each loaded then stored. In turns (PERF.md): blocks of
// 128 as fast as 64 and faster than 256, 512 and 1024; two rounds at once
// faster than four at office, as fast at heritage; loading a later round
// before storing the one before no faster on a step's calls.
//
// Bit for bit the plain versions' operations on the card, in their order
// (ops/hypotheses_kernels.py; ops/geometry.py, ops/batch.py):
//   - a 3- or 4-entry torch.sum over the last axis (geometry.dot, norm,
//     matvec, angle_deg; the quaternion's norm) adds as torch's CUDA
//     reduce does for rows that short (tsum3, tsum4, as csrc/lm.cu's;
//     tools/torch_sum_order.py probes it), and small_matmul in index
//     order;
//   - acosf is CUDA's, as torch.arccos calls it (fccf_hyp_acos_probe holds
//     it to torch's at every float32 in [-1, 1]); degrees is a product by
//     the float32 value of 180 / pi;
//   - clamp keeps a NaN and is fmaxf / fminf otherwise, as torch's;
//     _safe_denom and _inv3x3's determinant test |x| > floor, so a NaN
//     takes the floor;
//   - rodrigues multiplies the identity's and the skew matrix's zeros and
//     ones (a product, never a select: cos * 0.0 is -0.0 for a negative
//     cos, and NaN stays NaN);
//   - matrix_to_quat takes torch.argmax's candidate: the first NaN, else
//     the first largest;
//   - built with nvcc --fmad=false and no fast math; the arithmetic is
//     written with the _rn intrinsics besides.
// Bound: H2's operations (a slot's test ~12, a source face's ~150, a
// target face's ~50, a match's prelude ~400: chip_smoke.py counts every
// face of a valid match and the slots a full walk's rounds test); H1 the
// mask's few operations an entry; H3 the bytes of H.
//
// Every entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// geometry._EPS and _inv3x3's floor as torch casts them to float32, and
// geometry.degrees' factor (Python's 180 / math.pi) as float32.
constexpr float kEps = static_cast<float>(1e-12);
constexpr float kDetFloor = static_cast<float>(1e-20);
constexpr float kDegrees = static_cast<float>(180.0 / 3.141592653589793);

constexpr int kBasesThreads = 128;
// H1: a cluster of kMatchRanks blocks a pair, a warp a base row.
constexpr int kMatchRanks = 8;
constexpr int kMatchThreads = 512;
// H2: a block a chunk of at most kSlotChunk consecutive matches (fewer
// where F needs more shared memory), a warp a match in the slot rounds.
constexpr int kSlotThreads = 256;
constexpr int kSlotWarps = kSlotThreads / 32;
constexpr int kSlotChunk = 32;
// H3: a block a run of kEmitThreads matches of a pair, a thread a match
// (a multiple of 32, at most 1024); a thread's loads of the pair's counts
// started at once, and the rounds of 32 places a warp takes at once.
constexpr int kEmitThreads = 128;
constexpr int kEmitLoads = 4;
constexpr int kEmitPlaces = 2;
// Dynamic shared memory a block may have on the card.
constexpr long long kMaxShared = 232448;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dv(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.clamp(v, min=lo) / torch.clamp(v, lo, hi) on the card.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.sum of 3 entries on the card: block_width 2, thread 0 holds
// entries 0 and 2, thread 1 entry 1 (csrc/lm.cu's tsum3).
__device__ __forceinline__ float tsum3(float a0, float a1, float a2) {
  const float s0 = add(add(add(add(0.0f, a0), add(0.0f, a2)), 0.0f), 0.0f);
  const float s1 = add(add(add(add(0.0f, a1), 0.0f), 0.0f), 0.0f);
  return add(s0, s1);
}

// torch.sum of 4 entries on the card: block_width 4, one entry a thread,
// then the shuffle tree (0 + 2) + (1 + 3) (csrc/lm.cu's tsum4).
__device__ __forceinline__ float tsum4(float a0, float a1, float a2,
                                       float a3) {
  const float s0 = add(add(add(add(0.0f, a0), 0.0f), 0.0f), 0.0f);
  const float s1 = add(add(add(add(0.0f, a1), 0.0f), 0.0f), 0.0f);
  const float s2 = add(add(add(add(0.0f, a2), 0.0f), 0.0f), 0.0f);
  const float s3 = add(add(add(add(0.0f, a3), 0.0f), 0.0f), 0.0f);
  return add(add(s0, s2), add(s1, s3));
}

// geometry.dot / norm / cross / normalize of 3-vectors.
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return tsum3(mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2]));
}
__device__ __forceinline__ float norm3(const float a[3]) {
  return __fsqrt_rn(dot3(a, a));
}
__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float c[3]) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}
__device__ __forceinline__ void normalize3(const float v[3], float u[3]) {
  const float n = clamp_min(norm3(v), kEps);
#pragma unroll
  for (int k = 0; k < 3; ++k) u[k] = dv(v[k], n);
}

// geometry.angle_deg from the dot product and the two norms.
__device__ __forceinline__ float angle_of(float num, float na, float nb) {
  const float c =
      clamp_to(dv(num, clamp_min(mul(na, nb), kEps)), -1.0f, 1.0f);
  return mul(acosf(c), kDegrees);
}

// geometry.matvec: out[i] = sum_k R[i][k] v[k] (a 3-entry torch.sum).
__device__ __forceinline__ void matvec3(const float R[9], const float v[3],
                                        float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = tsum3(mul(R[3 * i], v[0]), mul(R[3 * i + 1], v[1]),
                   mul(R[3 * i + 2], v[2]));
}

// ops/batch.small_matmul of two 3 x 3 matrices: index order.
__device__ __forceinline__ void matmul3(const float a[9], const float b[9],
                                        float out[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = add(
          add(mul(a[3 * i], b[j]), mul(a[3 * i + 1], b[3 + j])),
          mul(a[3 * i + 2], b[6 + j]));
}

// geometry.rodrigues: cos * I + (1 - cos) * r r^T + sin * [r]_x, entry by
// entry ((c I + (1 - c) r r^T) + s K), the zeros and ones multiplied.
__device__ __forceinline__ void rodrigues(const float r[3], float c, float s,
                                          float R[9]) {
  const float omc = sub(1.0f, c);
  const float K[9] = {0.0f, -r[2], r[1], r[2], 0.0f, -r[0], -r[1], r[0],
                      0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = add(add(mul(c, i == j ? 1.0f : 0.0f),
                             mul(omc, mul(r[i], r[j]))),
                         mul(s, K[3 * i + j]));
}

// geometry._safe_denom.
__device__ __forceinline__ float safe_denom(float d) {
  return fabsf(d) > kEps ? d : kEps;
}

// geometry.rotation_between_planes: R = R2 R1 and m2r = R1 m2.
__device__ void rotation_between_planes(const float n1[3], const float m1[3],
                                        const float n2[3], const float m2[3],
                                        float R[9], float m2r[3]) {
  float c[3], r1[3], R1[9];
  cross3(n2, n1, c);
  normalize3(c, r1);
  const float cos1 = dot3(n2, n1);
  cross3(r1, n2, c);
  const float sin1 = dot3(c, n1);
  rodrigues(r1, cos1, sin1, R1);
  matvec3(R1, m2, m2r);
  const float m2dm1 = dot3(m2r, m1);
  const float m2dr2 = dot3(m2r, n1);
  const float m1dr2 = dot3(m1, n1);
  const float p = mul(m2dr2, m1dr2);
  const float denom = safe_denom(sub(1.0f, p));
  const float cos2 = dv(sub(m2dm1, p), denom);
  cross3(n1, m2r, c);
  const float sin2 = dv(dot3(c, m1), denom);
  float R2[9];
  rodrigues(n1, cos2, sin2, R2);
  matmul3(R2, R1, R);
}

// geometry.matrix_to_quat: torch.argmax's candidate (the first NaN, else
// the first largest), normalized.
__device__ void matrix_to_quat(const float R[9], float q[4]) {
  const float m00 = R[0], m01 = R[1], m02 = R[2];
  const float m10 = R[3], m11 = R[4], m12 = R[5];
  const float m20 = R[6], m21 = R[7], m22 = R[8];
  const float tr = add(add(m00, m11), m22);
  const float d0 = add(tr, 1.0f);
  const float d1 = sub(sub(add(m00, 1.0f), m11), m22);
  const float d2 = sub(add(sub(1.0f, m00), m11), m22);
  const float d3 = add(sub(sub(1.0f, m00), m11), m22);
  const float mags[4] = {d0, d1, d2, d3};
  int best = 0;
  float top = mags[0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (!isnan(top) && (isnan(mags[k]) || mags[k] > top)) {
      best = k;
      top = mags[k];
    }
  const float a21 = sub(m21, m12), a02 = sub(m02, m20), a10 = sub(m10, m01);
  const float s01 = add(m01, m10), s02 = add(m02, m20), s12 = add(m12, m21);
  float c[4];
  if (best == 0) {
    c[0] = d0; c[1] = a21; c[2] = a02; c[3] = a10;
  } else if (best == 1) {
    c[0] = a21; c[1] = d1; c[2] = s01; c[3] = s02;
  } else if (best == 2) {
    c[0] = a02; c[1] = s01; c[2] = d2; c[3] = s12;
  } else {
    c[0] = a10; c[1] = s02; c[2] = s12; c[3] = d3;
  }
  const float n = clamp_min(
      __fsqrt_rn(tsum4(mul(c[0], c[0]), mul(c[1], c[1]), mul(c[2], c[2]),
                       mul(c[3], c[3]))),
      kEps);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = dv(c[k], n);
}

// Base b of F faces, i < j in triu_indices order.
__device__ __forceinline__ void base_pair(int b, int F, int* i, int* j) {
  int r = 0, rest = b;
  while (rest >= F - 1 - r) {
    rest -= F - 1 - r;
    ++r;
  }
  *i = r;
  *j = r + 1 + rest;
}

struct BaseOut {
  float angle;
  int type;
  bool valid;
};

// select_bases' base (i, j) of one face set: the included angle, the
// validity (both faces valid, angle_min < angle < angle_max) and the
// roughness type (0 both smooth, 1 both rough, 2 mixed).
__device__ BaseOut form_base(const float* normal, const float* theta,
                             const unsigned char* valid, int i, int j,
                             float angle_min, float angle_max,
                             float rough_threshold) {
  float a[3], b[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = normal[3 * i + k];
    b[k] = normal[3 * j + k];
  }
  BaseOut out;
  out.angle = angle_of(dot3(a, b), norm3(a), norm3(b));
  out.valid = valid[i] && valid[j] && out.angle > angle_min &&
              out.angle < angle_max;
  const bool ri = theta[i] > rough_threshold;
  const bool rj = theta[j] > rough_threshold;
  out.type = ri == rj ? (ri ? 1 : 0) : 2;
  return out;
}

// Exclusive prefix of x over the block (blockDim.x a multiple of 32, at
// most 1024), and the block's total; wsum is 32 ints of shared memory.
__device__ int block_exclusive_scan(int x, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int v = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? wsum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += u;
    }
    wsum[lane] = s;
  }
  __syncthreads();
  const int before = (w > 0 ? wsum[w - 1] : 0) + v - x;
  *total = wsum[nw - 1];
  __syncthreads();
  return before;
}

// ------------------------------------------------------------- bases --

// select_bases on a card: one block a face set.
__global__ void __launch_bounds__(kBasesThreads)
hyp_bases_kernel(const float* __restrict__ normal,
                 const float* __restrict__ theta,
                 const unsigned char* __restrict__ valid, long long* bi,
                 long long* bj, float* angle, int* type,
                 unsigned char* bvalid, int F, int B, float angle_min,
                 float angle_max, float rough_threshold) {
  const long long c = blockIdx.x;
  const float* n = normal + c * F * 3;
  const float* th = theta + c * F;
  const unsigned char* v = valid + c * F;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    int i, j;
    base_pair(b, F, &i, &j);
    const BaseOut o =
        form_base(n, th, v, i, j, angle_min, angle_max, rough_threshold);
    const long long at = c * B + b;
    bi[at] = i;
    bj[at] = j;
    angle[at] = o.angle;
    type[at] = o.type;
    bvalid[at] = o.valid;
  }
}

// ---------------------------------------------------------------- H1 --

struct CloudFaces {
  const float* normal;  // (P, F, 3)
  const float* theta;   // (P, F)
  const unsigned char* valid;
};

// A base's key in H1's tables: its type where it is valid, else a value no
// row's key equals (kNoTarget for cloud 2, kNoRow for cloud 1's rows).
constexpr unsigned char kNoTarget = 3;
constexpr unsigned char kNoRow = 4;

// H1's shared memory, byte offsets: cloud 2's B bases (angle, faces i | j
// << 16, key) and this rank's `rows` bases of cloud 1 (the same, and each
// row's count, then its first place among the rank's matches), with `keep`
// each row's W = ceil(B / 32) ballot words.
struct MatchLayout {
  long long a2, ij2, ra1, rij1, rpos, words, k2, rk1, bytes;
};

__host__ __device__ inline MatchLayout match_layout(int B, int rows,
                                                   bool keep) {
  const long long W = (B + 31) / 32;
  MatchLayout l;
  l.a2 = 0;
  l.ij2 = l.a2 + 4LL * B;
  l.ra1 = l.ij2 + 4LL * B;
  l.rij1 = l.ra1 + 4LL * rows;
  l.rpos = l.rij1 + 4LL * rows;
  l.words = l.rpos + 4LL * rows;
  l.k2 = l.words + (keep ? 4LL * rows * W : 0);
  l.rk1 = l.k2 + B;
  l.bytes = (l.rk1 + rows + 15) / 16 * 16;
  return l;
}

// Mask entry (row, b) of the b1-major mask: both bases valid, the same
// type, their angles less than angle_same apart.
__device__ __forceinline__ bool mask_entry(int key, float angle, int b, int B,
                                           const unsigned char* k2,
                                           const float* a2,
                                           float angle_same) {
  return b < B && k2[b] == key && fabsf(sub(angle, a2[b])) < angle_same;
}

// The cluster barrier in halves: a block arrives once its reads of the
// other ranks' shared memory are done and waits before it exits, so no
// block's shared memory goes while another reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Pair blockIdx.x / K on a cluster of K blocks; rank r takes the b1 rows
// [r * rows, (r + 1) * rows).
__global__ void __launch_bounds__(kMatchThreads)
hyp_matches_kernel(CloudFaces c1, CloudFaces c2, int F, int B, int rows,
                   bool keep, long long M, float angle_min, float angle_max,
                   float rough_threshold, float angle_same, int* count,
                   unsigned char* overflow, unsigned char* mvalid,
                   long long* mi1, long long* mj1, long long* mi2,
                   long long* mj2, int* mtype) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[32];
  __shared__ int s_total;
  __shared__ int s_before, s_all;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long p = blockIdx.x / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int W = (B + 31) / 32;
  const MatchLayout l = match_layout(B, rows, keep);
  float* a2 = reinterpret_cast<float*>(smem + l.a2);
  int* ij2 = reinterpret_cast<int*>(smem + l.ij2);
  float* ra1 = reinterpret_cast<float*>(smem + l.ra1);
  int* rij1 = reinterpret_cast<int*>(smem + l.rij1);
  int* rpos = reinterpret_cast<int*>(smem + l.rpos);
  unsigned* words = reinterpret_cast<unsigned*>(smem + l.words);
  unsigned char* k2 = smem + l.k2;
  unsigned char* rk1 = smem + l.rk1;
  const int row0 = rank * rows;
  const int nrows = max(0, min(rows, B - row0));

  // Cloud 2's bases and this rank's rows of cloud 1's, a thread a base.
  for (int x = threadIdx.x; x < B + nrows; x += blockDim.x) {
    const bool target = x < B;
    const int b = target ? x : row0 + x - B;
    int i, j;
    base_pair(b, F, &i, &j);
    const BaseOut o = form_base(
        (target ? c2.normal : c1.normal) + p * F * 3,
        (target ? c2.theta : c1.theta) + p * F,
        (target ? c2.valid : c1.valid) + p * F, i, j, angle_min, angle_max,
        rough_threshold);
    if (target) {
      a2[b] = o.angle;
      ij2[b] = i | j << 16;
      k2[b] = o.valid ? (unsigned char)o.type : kNoTarget;
    } else {
      ra1[x - B] = o.angle;
      rij1[x - B] = i | j << 16;
      rk1[x - B] = o.valid ? (unsigned char)o.type : kNoRow;
    }
  }
  __syncthreads();

  // A warp a row: its entries 32 a round by a ballot, counted (and the
  // words kept where they fit).
  for (int a = warp; a < nrows; a += warps) {
    const int key = rk1[a];
    const float angle = ra1[a];
    int n = 0;
    if (key != kNoRow)
      for (int k = 0; k < W; ++k) {
        const unsigned word = __ballot_sync(
            0xffffffffu,
            mask_entry(key, angle, 32 * k + lane, B, k2, a2, angle_same));
        if (keep && lane == 0) words[(long long)a * W + k] = word;
        n += __popc(word);
      }
    if (lane == 0) rpos[a] = n;
  }
  __syncthreads();

  // Each row's first place among the rank's matches (a run of rows a
  // thread, scanned over the block), then the ranks before this one and
  // all K through the cluster's shared memory.
  const int run = (nrows + (int)blockDim.x - 1) / (int)blockDim.x;
  const int lo = min((int)threadIdx.x * run, nrows);
  const int hi = min(lo + run, nrows);
  int n = 0;
  for (int a = lo; a < hi; ++a) n += rpos[a];
  int total;
  int pos = block_exclusive_scan(n, wsum, &total);
  for (int a = lo; a < hi; ++a) {
    const int c = rpos[a];
    rpos[a] = pos;
    pos += c;
  }
  if (threadIdx.x == 0) s_total = total;
  cluster.sync();
  if (warp == 0) {  // lane r reads rank r's total (all K: B * B < 2^31)
    const int v = lane < K ? *cluster.map_shared_rank(&s_total, lane) : 0;
    int before = lane < rank ? v : 0, all = v;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, d);
      all += __shfl_xor_sync(0xffffffffu, all, d);
    }
    if (lane == 0) {
      s_before = before;
      s_all = all;
    }
  }
  cluster_arrive();
  __syncthreads();

  // A warp a row again: each match at its row's first place plus the
  // matches before it in the row; places past M are dropped.
  const long long before = s_before, all = s_all;
  const long long kept = all < M ? all : M;
  const long long base = p * M;
  for (int a = warp; a < nrows; a += warps) {
    const int key = rk1[a];
    long long at0 = before + rpos[a];
    if (key == kNoRow || at0 >= M) continue;
    const float angle = ra1[a];
    const int ij = rij1[a];
    for (int k = 0; k < W && at0 < M; ++k) {
      const int b = 32 * k + lane;
      const unsigned word =
          keep ? words[(long long)a * W + k]
               : __ballot_sync(0xffffffffu, mask_entry(key, angle, b, B, k2,
                                                       a2, angle_same));
      const long long at = at0 + __popc(word & ((1u << lane) - 1u));
      if ((word >> lane & 1u) && at < M) {
        const long long o = base + at;
        mvalid[o] = 1;
        mi1[o] = ij & 0xffff;
        mj1[o] = ij >> 16;
        mi2[o] = ij2[b] & 0xffff;
        mj2[o] = ij2[b] >> 16;
        mtype[o] = key;
      }
      at0 += __popc(word);
    }
  }
  // The empty places past the matches, split over the ranks.
  for (long long m = kept + (long long)rank * blockDim.x + threadIdx.x;
       m < M; m += (long long)K * blockDim.x) {
    const long long o = base + m;
    mvalid[o] = 0;
    mi1[o] = 0;
    mj1[o] = 0;
    mi2[o] = 0;
    mj2[o] = 0;
    mtype[o] = 0;
  }
  if (rank == 0 && threadIdx.x == 0) {
    count[p] = (int)kept;
    overflow[p] = all > M;
  }
  cluster_wait();
}

// ---------------------------------------------------------------- H2 --

struct Faces {
  const float* normal;      // (P, F, 3)
  const float* centroid;    // (P, F, 3)
  const float* point_size;  // (P, F)
  const unsigned char* valid;
};

// A match's prelude: R = R2 R1, its quaternion, the fallback translation,
// n2 x m2r normalized, the two fixed offsets d11 - d21 and d12 - d22, the
// target base's faces and the match's run in its chunk.
struct MatchPrelude {
  float R[9];
  float quat[4];
  float t_fb[3];
  float n2cm2[3];
  float D0, D1;
  int i2, j2, run;
};

// H2's shared memory for a chunk of C matches of F faces, byte offsets:
// each match's prelude; each run's source base (i1 | j1 << 16); per source
// face its normal, |normal| and d13; per run and source face P = inv(A^T
// A) A^T (row-major); per match and target face its rotated normal, its
// norm and d23; the source and target faces a warp's match lets through
// (16 bits each, for the min(C, kSlotWarps) warps that take matches); per
// run and source face, and per match and target face, the test.
struct SlotLayout {
  long long pre, run_ij, s_n, s_norm, s_d13, r_P, t_n, t_norm, t_d23, lists,
      r_ok, t_ok, bytes;
};

__host__ __device__ inline SlotLayout slot_layout(int F, int C) {
  const int warps = C < kSlotWarps ? C : kSlotWarps;
  SlotLayout l;
  l.pre = 0;
  l.run_ij = l.pre + (long long)sizeof(MatchPrelude) * C;
  l.s_n = l.run_ij + 4LL * C;
  l.s_norm = l.s_n + 12LL * F;
  l.s_d13 = l.s_norm + 4LL * F;
  l.r_P = l.s_d13 + 4LL * F;
  l.t_n = l.r_P + 36LL * F * C;
  l.t_norm = l.t_n + 12LL * F * C;
  l.t_d23 = l.t_norm + 4LL * F * C;
  l.lists = l.t_d23 + 4LL * F * C;
  l.r_ok = l.lists + 4LL * F * warps;
  l.t_ok = l.r_ok + (long long)F * C;
  l.bytes = (l.t_ok + (long long)F * C + 15) / 16 * 16;
  return l;
}

// Match (i1, j1, i2, j2)'s prelude (pair p's faces at N1, C1, W1 and N2,
// C2, W2).
__device__ void match_prelude(const float* N1, const float* C1,
                              const float* W1, const float* N2,
                              const float* C2, const float* W2, int i1,
                              int j1, int i2, int j2, MatchPrelude& pre) {
  float n1[3], m1[3], n2[3], m2[3], c11[3], c12[3], c21[3], c22[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    n1[k] = N1[3 * i1 + k];
    m1[k] = N1[3 * j1 + k];
    n2[k] = N2[3 * i2 + k];
    m2[k] = N2[3 * j2 + k];
    c11[k] = C1[3 * i1 + k];
    c12[k] = C1[3 * j1 + k];
    c21[k] = C2[3 * i2 + k];
    c22[k] = C2[3 * j2 + k];
  }
  float R[9], m2r[3], c[3], n2cm2[3];
  rotation_between_planes(n1, m1, n2, m2, R, m2r);
  cross3(n2, m2r, c);
  normalize3(c, n2cm2);
  // The fallback translation: the point-size-weighted base centroids.
  const float w11 = W1[i1], w12 = W1[j1], w21 = W2[i2], w22 = W2[j2];
  const float sden = clamp_min(add(w11, w12), kEps);
  const float tden = clamp_min(add(w21, w22), kEps);
  float sc[3], tc[3], Rtc[3], q[4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sc[k] = dv(add(mul(c11[k], w11), mul(c12[k], w12)), sden);
    tc[k] = dv(add(mul(c21[k], w21), mul(c22[k], w22)), tden);
  }
  matvec3(R, tc, Rtc);
  matrix_to_quat(R, q);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pre.t_fb[k] = sub(sc[k], Rtc[k]);
    pre.n2cm2[k] = n2cm2[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) pre.R[k] = R[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) pre.quat[k] = q[k];
  pre.D0 = sub(dot3(c11, n1), dot3(c21, n2));
  pre.D1 = sub(dot3(c12, m1), dot3(c22, m2r));
  pre.i2 = i2;
  pre.j2 = j2;
}

// Source face s's third-plane test against base (i1, j1), and where it
// passes P = inv(A^T A) A^T (A's rows n1, m1, n_s; each product in index
// order, small_matmul's, the inverse by the adjugate, _inv3x3's).
__device__ void source_plane(const float* N1, const unsigned char* V1, int s,
                             int i1, int j1, float plane_threshold,
                             unsigned char* ok_out, float* P_out) {
  float n1[3], m1[3], ns[3], c[3], n1cm1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    n1[k] = N1[3 * i1 + k];
    m1[k] = N1[3 * j1 + k];
    ns[k] = N1[3 * s + k];
  }
  cross3(n1, m1, c);
  normalize3(c, n1cm1);
  const bool ok = V1[s] && fabsf(dot3(ns, n1cm1)) > plane_threshold &&
                  s != i1 && s != j1;
  *ok_out = ok;
  if (!ok) return;
  const float* A[3] = {n1, m1, ns};
  float G[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      G[3 * i + j] = add(add(mul(A[0][i], A[0][j]), mul(A[1][i], A[1][j])),
                         mul(A[2][i], A[2][j]));
  const float a = G[0], b = G[1], cc = G[2], d = G[3], e = G[4], f = G[5],
              g = G[6], h = G[7], i = G[8];
  const float co[9] = {
      sub(mul(e, i), mul(f, h)), sub(mul(cc, h), mul(b, i)),
      sub(mul(b, f), mul(cc, e)), sub(mul(f, g), mul(d, i)),
      sub(mul(a, i), mul(cc, g)), sub(mul(cc, d), mul(a, f)),
      sub(mul(d, h), mul(e, g)),  sub(mul(b, g), mul(a, h)),
      sub(mul(a, e), mul(b, d))};
  float det = add(add(mul(a, co[0]), mul(b, co[3])), mul(cc, co[6]));
  det = fabsf(det) > kDetFloor ? det : kDetFloor;
  float inv[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) inv[k] = dv(co[k], det);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      P_out[3 * r + q] =
          add(add(mul(inv[3 * r], A[q][0]), mul(inv[3 * r + 1], A[q][1])),
              mul(inv[3 * r + 2], A[q][2]));
}

// Target face t rotated by the match's R (small_matmul with R^T): its
// normal, norm, offset d23 and test.
__device__ void target_plane(const float* N2, const float* C2,
                             const unsigned char* V2, int t,
                             const MatchPrelude& pre, float plane_threshold,
                             float* n_out, float* norm_out, float* d23_out,
                             unsigned char* ok_out) {
  float nt[3], ct[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    nt[r] = add(add(mul(N2[3 * t], pre.R[3 * r]),
                    mul(N2[3 * t + 1], pre.R[3 * r + 1])),
                mul(N2[3 * t + 2], pre.R[3 * r + 2]));
    ct[r] = add(add(mul(C2[3 * t], pre.R[3 * r]),
                    mul(C2[3 * t + 1], pre.R[3 * r + 1])),
                mul(C2[3 * t + 2], pre.R[3 * r + 2]));
  }
  const bool ok = V2[t] && fabsf(dot3(nt, pre.n2cm2)) > plane_threshold &&
                  t != pre.i2 && t != pre.j2;
  *ok_out = ok;
  if (!ok) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) n_out[k] = nt[k];
  *norm_out = norm3(nt);
  *d23_out = dot3(ct, nt);
}

// Chunk blockIdx.x of pair blockIdx.y: its matches [C x, C (x + 1)).
__global__ void __launch_bounds__(kSlotThreads)
hyp_slots_kernel(Faces f1, Faces f2, const int* __restrict__ mcount,
                 const long long* __restrict__ mi1,
                 const long long* __restrict__ mj1,
                 const long long* __restrict__ mi2,
                 const long long* __restrict__ mj2, int F, long long M, int K,
                 int C, float plane_threshold, float normal_threshold,
                 float* quat_out, float* t_out, int* hit_count,
                 unsigned char* row_overflow) {
  extern __shared__ __align__(16) unsigned char shm[];
  __shared__ int s_runs;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long p = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * C;
  const int in_chunk = M - m0 < C ? (int)(M - m0) : C;
  const long long left = mcount[p] - m0;
  const int n = left <= 0 ? 0 : left < in_chunk ? (int)left : in_chunk;
  for (int c = n + threadIdx.x; c < in_chunk; c += blockDim.x) {
    const long long pm = p * M + m0 + c;  // no match: the empty outputs
#pragma unroll
    for (int r = 0; r < 4; ++r) quat_out[pm * 4 + r] = 0.0f;
    hit_count[pm] = 0;
    row_overflow[pm] = 0;
  }
  if (n == 0) return;

  const SlotLayout l = slot_layout(F, C);
  MatchPrelude* pres = reinterpret_cast<MatchPrelude*>(shm + l.pre);
  int* run_ij = reinterpret_cast<int*>(shm + l.run_ij);
  float* s_n = reinterpret_cast<float*>(shm + l.s_n);
  float* s_norm = reinterpret_cast<float*>(shm + l.s_norm);
  float* s_d13 = reinterpret_cast<float*>(shm + l.s_d13);
  float* r_P = reinterpret_cast<float*>(shm + l.r_P);
  float* t_n = reinterpret_cast<float*>(shm + l.t_n);
  float* t_norm = reinterpret_cast<float*>(shm + l.t_norm);
  float* t_d23 = reinterpret_cast<float*>(shm + l.t_d23);
  short* lists = reinterpret_cast<short*>(shm + l.lists);
  unsigned char* r_ok = shm + l.r_ok;
  unsigned char* t_ok = shm + l.t_ok;
  const float* N1 = f1.normal + p * F * 3;
  const float* C1 = f1.centroid + p * F * 3;
  const float* N2 = f2.normal + p * F * 3;
  const float* C2 = f2.centroid + p * F * 3;
  const long long first = p * M + m0;

  // The runs of equal source bases (i1, j1) among the chunk's matches (C
  // <= 32, a lane a match).
  if (w == 0) {
    const int ij = lane < n ? ((int)mi1[first + lane] |
                               (int)mj1[first + lane] << 16)
                            : -1;
    const int before = __shfl_up_sync(0xffffffffu, ij, 1);
    const bool start = lane < n && (lane == 0 || ij != before);
    const unsigned starts = __ballot_sync(0xffffffffu, start);
    const int run = __popc(starts & (0xffffffffu >> (31 - lane))) - 1;
    if (lane < n) pres[lane].run = run;
    if (start) run_ij[run] = ij;
    if (lane == 0) s_runs = __popc(starts);
  }
  __syncthreads();

  // Warp 0 a lane a match: its prelude. The other warps meanwhile: each
  // source face's own values, then each run's source-face tests and P.
  const int runs = s_runs;
  if (w == 0) {
    if (lane < n) {
      const long long pm = first + lane;
      match_prelude(N1, C1, f1.point_size + p * F, N2, C2,
                    f2.point_size + p * F, (int)mi1[pm], (int)mj1[pm],
                    (int)mi2[pm], (int)mj2[pm], pres[lane]);
    }
  } else {
    for (int x = threadIdx.x - 32; x < F * (runs + 1);
         x += blockDim.x - 32) {
      if (x < F) {
        float ns[3], cs[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ns[k] = N1[3 * x + k];
          cs[k] = C1[3 * x + k];
          s_n[3 * x + k] = ns[k];
        }
        s_norm[x] = norm3(ns);
        s_d13[x] = dot3(cs, ns);
      } else {
        const int q = x / F - 1, s = x - (q + 1) * F;
        const int ij = run_ij[q];
        source_plane(N1, f1.valid + p * F, s, ij & 0xffff, ij >> 16,
                     plane_threshold, r_ok + q * F + s,
                     r_P + 9LL * (q * F + s));
      }
    }
  }
  __syncthreads();

  // Each match's target faces, a thread a (match, face).
  for (int x = threadIdx.x; x < n * F; x += blockDim.x) {
    const int c = x / F;
    target_plane(N2, C2, f2.valid + p * F, x - c * F, pres[c],
                 plane_threshold, t_n + 3LL * x, t_norm + x, t_d23 + x,
                 t_ok + x);
  }
  __syncthreads();

  // A warp a match: the (s, t) slots whose faces both pass, s-major (slot
  // order), a lane each, 32 at a time, ranked by the warp's ballot; past
  // K + 1 valid slots the rest cannot change the kept hits or the
  // overflow.
  short* s_list = lists + 2LL * w * F;
  short* t_list = s_list + F;
  const unsigned below = (1u << lane) - 1u;
  for (int c = w; c < n; c += kSlotWarps) {
    const MatchPrelude& pre = pres[c];
    const unsigned char* sok = r_ok + pre.run * F;
    const unsigned char* tok = t_ok + c * F;
    int ns = 0, nt = 0;
    for (int f0 = 0; f0 < F; f0 += 32) {
      const int f = f0 + lane;
      const bool so = f < F && sok[f], to = f < F && tok[f];
      const unsigned bs = __ballot_sync(0xffffffffu, so);
      const unsigned bt = __ballot_sync(0xffffffffu, to);
      if (so) s_list[ns + __popc(bs & below)] = (short)f;
      if (to) t_list[nt + __popc(bt & below)] = (short)f;
      ns += __popc(bs);
      nt += __popc(bt);
    }
    __syncwarp();
    const long long pm = first + c;
    float* to_ = t_out + pm * K * 3;
    const float* tn = t_n + 3LL * c * F;
    const float* tnorm = t_norm + c * F;
    const int E = ns * nt;
    // The lane's slot e is list entries (si, ti) = (e / nt, e % nt); a
    // round moves e by 32 = dq nt + dr.
    int si = 0, ti = 0, dq = 0, dr = 0;
    if (E > 0) {
      si = lane / nt;
      ti = lane - si * nt;
      dq = 32 / nt;
      dr = 32 - dq * nt;
    }
    int running = 0;
    for (int e0 = 0; e0 < E && running <= K; e0 += 32) {
      bool ok = false;
      int s = 0, t = 0;
      if (e0 + lane < E) {
        s = s_list[si];
        t = t_list[ti];
        ok = angle_of(dot3(s_n + 3 * s, tn + 3 * t), s_norm[s], tnorm[t]) <
             normal_threshold;
      }
      si += dq;
      ti += dr;
      if (ti >= nt) {
        ti -= nt;
        ++si;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      const int rank = running + __popc(bal & below);
      if (ok && rank < K) {
        const float* P = r_P + 9LL * (pre.run * F + s);
        const float D2 = sub(s_d13[s], t_d23[c * F + t]);
#pragma unroll
        for (int r = 0; r < 3; ++r)
          to_[3 * rank + r] =
              add(add(mul(pre.D0, P[3 * r]), mul(pre.D1, P[3 * r + 1])),
                  mul(D2, P[3 * r + 2]));
      }
      running += __popc(bal);
    }
    // The fallback slot F * F: valid where no (s, t) slot is.
    const int total = running + (running == 0);
    if (lane == 0) {
      if (running == 0 && K > 0) {
#pragma unroll
        for (int r = 0; r < 3; ++r) to_[r] = pre.t_fb[r];
      }
      hit_count[pm] = total < K ? total : K;
      row_overflow[pm] = total > K;
    }
    if (lane < 4) quat_out[pm * 4 + lane] = pre.quat[lane];
    __syncwarp();
  }
}

// ---------------------------------------------------------------- H3 --

// A match's hits as H3 takes them: its count held to [0, K], as
// emit_plain's arange(K) < count.
__device__ __forceinline__ int kept_count(int c, int K) {
  return c < 0 ? 0 : (c > K ? K : c);
}

// The sum of a group of counts, each held to [0, K].
__device__ __forceinline__ int group_hits(int4 v, int K) {
  return kept_count(v.x, K) + kept_count(v.y, K) + kept_count(v.z, K) +
         kept_count(v.w, K);
}

// kEmitPlaces places of each lane (rounds of 32 places of a warp's run
// at once), loaded before they are stored.
struct EmitRound {
  float4 q[kEmitPlaces];
  float t[kEmitPlaces][3];
  int type[kEmitPlaces];
};

// Loads places r0 + 32 u + lane below lim of the warp's run: place r's
// match is the first lane whose end is past r (the ends rise with the
// lane: 5 shuffles), its hit r - beg of that lane. Every lane calls it.
__device__ __forceinline__ void emit_load(EmitRound& e, int r0, int lim,
                                          int end, int beg, long long m0,
                                          int K, bool vec,
                                          const float* __restrict__ quat,
                                          const float* __restrict__ hit_t,
                                          const int* __restrict__ mtype) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kEmitPlaces; ++u) {
    const int r = r0 + 32 * u + lane;
    int j = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      if (__shfl_sync(0xffffffffu, end, j + s - 1) <= r) j += s;
    const int k = r - __shfl_sync(0xffffffffu, beg, j);
    if (r < lim) {
      const long long pm = m0 + j;
      if (vec) {
        e.q[u] = reinterpret_cast<const float4*>(quat)[pm];
      } else {
        e.q[u] = make_float4(quat[4 * pm], quat[4 * pm + 1], quat[4 * pm + 2],
                             quat[4 * pm + 3]);
      }
      const float* src = hit_t + (pm * K + k) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) e.t[u][c] = src[c];
      e.type[u] = mtype[pm];
    }
  }
}

// Stores the places of emit_load's round below n, at h0 + r.
__device__ __forceinline__ void emit_store(const EmitRound& e, int r0, int n,
                                           long long h0, bool vec,
                                           float* __restrict__ q_out,
                                           float* __restrict__ t_out,
                                           int* __restrict__ type_out,
                                           unsigned char* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kEmitPlaces; ++u) {
    const int r = r0 + 32 * u + lane;
    if (r < n) {
      const long long h = h0 + r;
      if (vec) {
        reinterpret_cast<float4*>(q_out)[h] = e.q[u];
      } else {
        q_out[4 * h] = e.q[u].x;
        q_out[4 * h + 1] = e.q[u].y;
        q_out[4 * h + 2] = e.q[u].z;
        q_out[4 * h + 3] = e.q[u].w;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) t_out[3 * h + c] = e.t[u][c];
      type_out[h] = e.type[u];
      valid[h] = 1;
    }
  }
}

// Block b of pair p owns the matches [b T, (b + 1) T), a thread a match.
__global__ void __launch_bounds__(kEmitThreads)
hyp_emit_kernel(const int* __restrict__ hit_count,
                const unsigned char* __restrict__ row_overflow,
                const float* __restrict__ quat,
                const float* __restrict__ hit_t,
                const int* __restrict__ mtype,
                const unsigned char* __restrict__ m_overflow, long long M,
                int K, long long H, float* __restrict__ q_out,
                float* __restrict__ t_out, int* __restrict__ type_out,
                unsigned char* __restrict__ valid_out, int* count_out,
                unsigned char* overflow_out) {
  constexpr int kWarps = kEmitThreads / 32;
  __shared__ int s_before[kWarps], s_all[kWarps], s_own[kWarps];
  const long long p = blockIdx.y;
  const long long start = (long long)blockIdx.x * kEmitThreads;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int* cnt = hit_count + p * M;
  const unsigned char* rows = row_overflow + p * M;
  const long long m = start + threadIdx.x;
  // Every load of the counts (and block 0's of the rows' flags) is started
  // before any is summed: groups of 4 where the row is 16-byte aligned
  // (start is a multiple of 4), kEmitLoads a thread at once, then any
  // further ones in turn.
  const bool vec_c =
      (M & 3) == 0 && (reinterpret_cast<size_t>(cnt) & 15) == 0;
  const bool vec_r =
      (M & 3) == 0 && (reinterpret_cast<size_t>(rows) & 3) == 0;
  const long long n_c = vec_c ? M >> 2 : M;
  const long long n_r = vec_r ? M >> 2 : M;
  const bool flags = blockIdx.x == 0;
  const int own = m < M ? kept_count(cnt[m], K) : 0;
  int4 v[kEmitLoads];
  unsigned f[kEmitLoads];
#pragma unroll
  for (int u = 0; u < kEmitLoads; ++u) {
    const long long i = threadIdx.x + (long long)u * kEmitThreads;
    v[u] = make_int4(0, 0, 0, 0);
    f[u] = 0u;
    if (i < n_c) {
      if (vec_c) v[u] = reinterpret_cast<const int4*>(cnt)[i];
      else v[u].x = cnt[i];
    }
    if (flags && i < n_r)
      f[u] = vec_r ? reinterpret_cast<const unsigned*>(rows)[i] : rows[i];
  }
  const int m_over = flags && threadIdx.x == 0 ? m_overflow[p] : 0;
  // The warp's scan of its matches' counts: each lane's match ends at
  // place `end` of the warp's run of wsum places.
  int end = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, end, d);
    if (lane >= d) end += u;
  }
  const int beg = end - own;
  const int wsum = __shfl_sync(0xffffffffu, end, 31);
  // The pair's hits before the block's matches and all of them.
  const int width = vec_c ? 4 : 1;
  int before = 0, all = 0;
  unsigned any = 0u;
#pragma unroll
  for (int u = 0; u < kEmitLoads; ++u) {
    const long long i = threadIdx.x + (long long)u * kEmitThreads;
    const int s = group_hits(v[u], K);
    all += s;
    if (i * width < start) before += s;
    any |= f[u];
  }
  for (long long i = threadIdx.x + (long long)kEmitLoads * kEmitThreads;
       i < n_c; i += kEmitThreads) {
    const int s = vec_c ? group_hits(reinterpret_cast<const int4*>(cnt)[i], K)
                        : kept_count(cnt[i], K);
    all += s;
    if (i * width < start) before += s;
  }
  if (flags)
    for (long long i = threadIdx.x + (long long)kEmitLoads * kEmitThreads;
         i < n_r; i += kEmitThreads)
      any |= vec_r ? reinterpret_cast<const unsigned*>(rows)[i] : rows[i];
  before = __reduce_add_sync(0xffffffffu, before);
  all = __reduce_add_sync(0xffffffffu, all);
  if (lane == 0) {
    s_before[w] = before;
    s_all[w] = all;
    s_own[w] = wsum;
  }
  // The run's first round is gathered before the barrier: which match
  // and hit a place takes does not depend on where the run starts.
  const long long m0 = p * M + start + (w << 5);
  const bool vec = ((reinterpret_cast<size_t>(quat) |
                     reinterpret_cast<size_t>(q_out)) & 15) == 0;
  EmitRound e;
  emit_load(e, 0, wsum, end, beg, m0, K, vec, quat, hit_t, mtype);
  const bool any_row = __syncthreads_or(any != 0u);
  // The warps' sums, read by every thread; the warp's run of places
  // [ws, ws + n), clipped to the kept ones.
  int total = 0;
  long long ws = 0;
#pragma unroll
  for (int x = 0; x < kWarps; ++x) {
    total += s_all[x];
    ws += s_before[x] + (x < w ? s_own[x] : 0);
  }
  const long long kept = total < H ? total : H;
  const long long room = kept - ws;
  const int n = room <= 0 ? 0 : (room < wsum ? (int)room : wsum);
  const long long h0 = p * H + ws;
  // The places past the kept hits, split over the pair's blocks, stored
  // while the first round's gathers are in flight.
  const long long stride = (long long)gridDim.x * kEmitThreads;
  for (long long x = kept + start + threadIdx.x; x < H; x += stride) {
    const long long h = p * H + x;
    if (vec) {
      reinterpret_cast<float4*>(q_out)[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) q_out[4 * h + c] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) t_out[3 * h + c] = 0.0f;
    type_out[h] = 0;
    valid_out[h] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    count_out[p] = (int)kept;
    overflow_out[p] = total > H || m_over != 0 || any_row;
  }
  emit_store(e, 0, n, h0, vec, q_out, t_out, type_out, valid_out);
  // Later rounds (a run past 32 kEmitPlaces places), in turn.
  constexpr int kStep = 32 * kEmitPlaces;
  for (int r0 = kStep; r0 < n; r0 += kStep) {
    emit_load(e, r0, n, end, beg, m0, K, vec, quat, hit_t, mtype);
    emit_store(e, r0, n, h0, vec, q_out, t_out, type_out, valid_out);
  }
}

__global__ void hyp_acos_probe_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = acosf(x[i]);
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

// select_bases over C face sets of F faces: normal (C, F, 3), theta (C, F)
// float32, valid (C, F) bool, contiguous; out i, j (C, B) int64, angle
// (C, B) float32, type (C, B) int32, valid (C, B) bool, B = F (F - 1) / 2.
int fccf_hyp_bases(const void* normal, const void* theta, const void* valid,
                   void* bi, void* bj, void* angle, void* type, void* bvalid,
                   long long C, int F, float angle_min, float angle_max,
                   float rough_threshold, void* stream) {
  const int B = F * (F - 1) / 2;
  if (C <= 0 || B <= 0) return 0;
  if (C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hyp_bases_kernel<<<(unsigned)C, kBasesThreads, 0, (cudaStream_t)stream>>>(
      (const float*)normal, (const float*)theta, (const unsigned char*)valid,
      (long long*)bi, (long long*)bj, (float*)angle, (int*)type,
      (unsigned char*)bvalid, F, B, angle_min, angle_max, rough_threshold);
  return (int)cudaGetLastError();
}

// H1 over P pairs. Each cloud c = 1, 2: its faces, normal (P, F, 3),
// theta (P, F) float32, valid (P, F) bool. Out: count (P) int32, overflow
// (P) bool, valid (P, M) bool, i1, j1, i2, j2 (P, M) int64, type (P, M)
// int32.
int fccf_hyp_matches(const void* n1, const void* th1, const void* v1,
                     const void* n2, const void* th2, const void* v2,
                     void* count, void* overflow, void* mvalid, void* mi1,
                     void* mj1, void* mi2, void* mj2, void* mtype,
                     long long P, int F, long long M, float angle_min,
                     float angle_max, float rough_threshold, float angle_same,
                     void* stream) {
  const int B = F * (F - 1) / 2;
  if (P <= 0) return 0;
  if (P > 0x7fffffffLL / kMatchRanks || (long long)B * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int rows = (B + kMatchRanks - 1) / kMatchRanks;
  bool keep = match_layout(B, rows, true).bytes <= kMaxShared;
  const long long bytes = match_layout(B, rows, keep).bytes;
  cudaError_t err = allow_shared(hyp_matches_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  CloudFaces c1{(const float*)n1, (const float*)th1,
                (const unsigned char*)v1};
  CloudFaces c2{(const float*)n2, (const float*)th2,
                (const unsigned char*)v2};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(P * kMatchRanks));
  cfg.blockDim = dim3(kMatchThreads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMatchRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int* cnt = (int*)count;
  unsigned char *ovf = (unsigned char*)overflow, *mv = (unsigned char*)mvalid;
  long long *i1 = (long long*)mi1, *j1 = (long long*)mj1;
  long long *i2 = (long long*)mi2, *j2 = (long long*)mj2;
  int* mt = (int*)mtype;
  int b = B, r = rows;
  void* args[] = {&c1, &c2, &F, &b, &r, &keep, &M, &angle_min, &angle_max,
                  &rough_threshold, &angle_same, &cnt, &ovf, &mv, &i1, &j1,
                  &i2, &j2, &mt};
  err = cudaLaunchKernelExC(&cfg, (const void*)hyp_matches_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// H2 over P pairs of M matches: faces 1 and 2 (normal, centroid (P, F, 3),
// point_size (P, F) float32, valid (P, F) bool), the matches' count (P)
// int32 and i1, j1, i2, j2 (P, M) int64; out quat (P, M, 4), t (P, M, K,
// 3) float32 (a row's first hit_count entries), hit_count (P, M) int32,
// row_overflow (P, M) bool. K = PER_MATCH <= F * F + 1.
int fccf_hyp_slots(const void* n1, const void* c1, const void* w1,
                   const void* v1, const void* n2, const void* c2,
                   const void* w2, const void* v2, const void* mcount,
                   const void* mi1, const void* mj1, const void* mi2,
                   const void* mj2, void* quat, void* t, void* hit_count,
                   void* row_overflow, long long P, int F, long long M, int K,
                   float plane_threshold, float normal_threshold,
                   void* stream) {
  if (P <= 0 || M <= 0) return 0;
  int C = kSlotChunk;
  while (C > 1 && slot_layout(F, C).bytes > kMaxShared) C >>= 1;
  const long long bytes = slot_layout(F, C).bytes;
  const long long blocks = (M + C - 1) / C;
  if (P > 65535 || F > 32767 || bytes > kMaxShared || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_shared(hyp_slots_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const Faces f1{(const float*)n1, (const float*)c1, (const float*)w1,
                 (const unsigned char*)v1};
  const Faces f2{(const float*)n2, (const float*)c2, (const float*)w2,
                 (const unsigned char*)v2};
  hyp_slots_kernel<<<dim3((unsigned)blocks, (unsigned)P), kSlotThreads, bytes,
                     (cudaStream_t)stream>>>(
      f1, f2, (const int*)mcount, (const long long*)mi1,
      (const long long*)mj1, (const long long*)mi2, (const long long*)mj2, F,
      M, K, C, plane_threshold, normal_threshold, (float*)quat, (float*)t,
      (int*)hit_count, (unsigned char*)row_overflow);
  return (int)cudaGetLastError();
}

// H3 over P pairs: hit_count (P, M) int32, row_overflow (P, M) bool, quat
// (P, M, 4), t (P, M, K, 3) float32, mtype (P, M) int32, m_overflow (P)
// bool; out quat (P, H, 4), t (P, H, 3) float32, type (P, H) int32, valid
// (P, H) bool, count (P) int32, overflow (P) bool.
int fccf_hyp_emit(const void* hit_count, const void* row_overflow,
                  const void* quat, const void* hit_t, const void* mtype,
                  const void* m_overflow, void* q_out, void* t_out,
                  void* type_out, void* valid_out, void* count_out,
                  void* overflow_out, long long P, long long M, int K,
                  long long H, void* stream) {
  if (P <= 0) return 0;
  const long long blocks = (M + kEmitThreads - 1) / kEmitThreads;
  if (P > 65535 || M <= 0 || K < 0 || H < 0 || M * K > 0x7fffffffLL ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  hyp_emit_kernel<<<dim3((unsigned)blocks, (unsigned)P), kEmitThreads, 0,
                    (cudaStream_t)stream>>>(
      (const int*)hit_count, (const unsigned char*)row_overflow,
      (const float*)quat, (const float*)hit_t, (const int*)mtype,
      (const unsigned char*)m_overflow, M, K, H, (float*)q_out,
      (float*)t_out, (int*)type_out, (unsigned char*)valid_out,
      (int*)count_out, (unsigned char*)overflow_out);
  return (int)cudaGetLastError();
}

// acosf of n float32 (the function H1 and H2 call), for tests to hold to
// torch.arccos.
int fccf_hyp_acos_probe(const void* x, void* out, long long n,
                        void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hyp_acos_probe_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
