// The hypotheses stage on Hopper (sm_90a), with a plain C interface bound
// with ctypes by fccf_pcr_torch/ops/hypotheses_kernels.py. It replaces no
// Pallas kernel: the JAX package's compiled program runs the stage
// (fccf_pcr_tpu/hypotheses/bases.py:40 select_bases and
// fccf_pcr_tpu/hypotheses/transforms.py:161 generate_hypotheses, with
// _match_one at :78 vmapped over the matches and lax.top_k at :217) as
// fused XLA loops, where the port ran it as some 450 PyTorch kernels a
// step, a stable sort of every match's F * F + 1 slots among them.
//
// H1, fccf_hyp_matches, one block a pair: both clouds' bases formed from
// their faces (the face pairs i < j in triu_indices order, their angle,
// type and validity), the B x B compatibility mask in b1-major order (both
// valid, |angle difference| < angle_same, the same type) and its stable
// compaction to M matches: each thread counts a contiguous run of the
// mask, an exclusive scan of the counts gives each run its first place,
// and the entries past M are dropped (overflow). fccf_hyp_bases writes
// the bases alone (select_bases on a card), one block a face set, with
// the same device code.
//
// H2, fccf_hyp_slots, one warp a match, up to eight matches a block (a
// grid of (M / 8, P)): warps past the pair's match count write their
// empty outputs and return. Lane 0 forms the match's rotation R = R2 R1
// (with R1 m2), its quaternion, the fallback translation and the two
// fixed offsets d11 - d21 and d12 - d22 into the warp's shared memory;
// lanes then form, a face each, source face s's third-plane test, its
// offset d13 and P = inv(A^T A) A^T, and target face t's rotated normal,
// its test and offset d23. Then a lane a (s, t) slot, 32 at a time, tests
// the slot (pair_ok) and the warp's ballot ranks the valid slots in slot
// order: the first PER_MATCH have their translation T3 formed and written
// to (M, PER_MATCH); the fallback slot F * F is valid where no slot is.
// No sort, and the loop stops once PER_MATCH + 1 slots are valid: the
// per-match hit count and the row's overflow bit go beside the hits, and
// a row's entries past its count are not written (H3 reads none).
//
// H3, fccf_hyp_emit, one thread a place of H (a grid of (H / 256, P)):
// each block scans the pair's per-match hit counts over M into shared
// memory (a run of matches a thread), and place e takes hit k of the
// first match whose scanned end is past e (a binary search); its
// quaternion, translation and type are written there, the places past
// the count hold +0.0 and 0, and the overflow is H's, the matches' or any
// row's.
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
// target face's ~50, a match's prelude ~400); H1 the mask's few
// operations an entry; H3 the bytes of H.
//
// Every entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

// geometry._EPS and _inv3x3's floor as torch casts them to float32, and
// geometry.degrees' factor (Python's 180 / math.pi) as float32.
constexpr float kEps = static_cast<float>(1e-12);
constexpr float kDetFloor = static_cast<float>(1e-20);
constexpr float kDegrees = static_cast<float>(180.0 / 3.141592653589793);

constexpr int kBasesThreads = 128;
constexpr int kMatchThreads = 1024;
// H2's matches a block (a warp each), fewer where F needs more shared
// memory.
constexpr int kSlotWarps = 8;
constexpr int kEmitThreads = 256;
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

// One cloud's B bases of pair p, formed from its faces into shared memory.
__device__ void load_bases(const CloudFaces& cf, long long p, int F, int B,
                           float angle_min, float angle_max,
                           float rough_threshold, long long* si,
                           long long* sj, float* sa, int* st,
                           unsigned char* sv) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    int i, j;
    base_pair(b, F, &i, &j);
    const BaseOut o = form_base(cf.normal + p * F * 3, cf.theta + p * F,
                                cf.valid + p * F, i, j, angle_min, angle_max,
                                rough_threshold);
    si[b] = i;
    sj[b] = j;
    sa[b] = o.angle;
    st[b] = o.type;
    sv[b] = o.valid;
  }
}

__global__ void __launch_bounds__(kMatchThreads)
hyp_matches_kernel(CloudFaces c1, CloudFaces c2, int F, int B, long long M,
                   float angle_min, float angle_max, float rough_threshold,
                   float angle_same, int* count, unsigned char* overflow,
                   unsigned char* mvalid, long long* mi1, long long* mj1,
                   long long* mi2, long long* mj2, int* mtype) {
  extern __shared__ long long smem[];
  __shared__ int wsum[32];
  const long long p = blockIdx.x;
  long long* si1 = smem;
  long long* sj1 = si1 + B;
  long long* si2 = sj1 + B;
  long long* sj2 = si2 + B;
  float* sa1 = reinterpret_cast<float*>(sj2 + B);
  float* sa2 = sa1 + B;
  int* st1 = reinterpret_cast<int*>(sa2 + B);
  int* st2 = st1 + B;
  unsigned char* sv1 = reinterpret_cast<unsigned char*>(st2 + B);
  unsigned char* sv2 = sv1 + B;
  load_bases(c1, p, F, B, angle_min, angle_max, rough_threshold, si1, sj1,
             sa1, st1, sv1);
  load_bases(c2, p, F, B, angle_min, angle_max, rough_threshold, si2, sj2,
             sa2, st2, sv2);
  __syncthreads();

  // A contiguous run of the b1-major mask a thread.
  // (B * B below 2^31: the entry checks it.)
  const int L = B * B;
  const int run = (L + (int)blockDim.x - 1) / (int)blockDim.x;
  const int lo = threadIdx.x * run;
  const int hi = lo + run < L ? lo + run : L;
  int n = 0;
  for (int e = lo; e < hi; ++e) {
    const int a = e / B, b = e - a * B;
    n += sv1[a] && sv2[b] && fabsf(sub(sa1[a], sa2[b])) < angle_same &&
         st1[a] == st2[b];
  }
  int total;
  long long pos = block_exclusive_scan(n, wsum, &total);
  const long long base = p * M;
  for (int e = lo; e < hi && pos < M; ++e) {
    const int a = e / B, b = e - a * B;
    if (sv1[a] && sv2[b] && fabsf(sub(sa1[a], sa2[b])) < angle_same &&
        st1[a] == st2[b]) {
      const long long at = base + pos;
      mvalid[at] = 1;
      mi1[at] = si1[a];
      mj1[at] = sj1[a];
      mi2[at] = si2[b];
      mj2[at] = sj2[b];
      mtype[at] = st1[a];
      ++pos;
    }
  }
  const long long kept = total < M ? total : M;
  for (long long m = kept + threadIdx.x; m < M; m += blockDim.x) {
    const long long at = base + m;
    mvalid[at] = 0;
    mi1[at] = 0;
    mj1[at] = 0;
    mi2[at] = 0;
    mj2[at] = 0;
    mtype[at] = 0;
  }
  if (threadIdx.x == 0) {
    count[p] = (int)kept;
    overflow[p] = total > M;
  }
}

// ---------------------------------------------------------------- H2 --

struct Faces {
  const float* normal;      // (P, F, 3)
  const float* centroid;    // (P, F, 3)
  const float* point_size;  // (P, F)
  const unsigned char* valid;
};

// The per-match values lane 0 forms, in the warp's shared memory.
struct MatchPrelude {
  float R[9];
  float quat[4];
  float t_fb[3];
  float n1[3];
  float m1[3];
  float n1cm1[3];
  float n2cm2[3];
  float D0, D1;
  int i1, j1, i2, j2;
};

constexpr long long kPreludeBytes = (sizeof(MatchPrelude) + 15) / 16 * 16;

// A warp's shared memory: the prelude, then per source face s its normal,
// |normal|, d13, P (row-major) and test, per target face t its rotated
// normal, its norm, d23 and test; a multiple of 16 bytes.
long long slot_warp_bytes(int F) {
  return kPreludeBytes + ((long long)F * (4 * 19 + 2) + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kSlotWarps * 32)
hyp_slots_kernel(Faces f1, Faces f2, const int* __restrict__ mcount,
                 const long long* __restrict__ mi1,
                 const long long* __restrict__ mj1,
                 const long long* __restrict__ mi2,
                 const long long* __restrict__ mj2, int F, long long M, int K,
                 float plane_threshold, float normal_threshold,
                 long long warp_bytes, float* quat_out, float* t_out,
                 int* hit_count, unsigned char* row_overflow) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long m = (long long)blockIdx.x * (blockDim.x >> 5) + w;
  const long long p = blockIdx.y;
  if (m >= M) return;
  const long long pm = p * M + m;
  if (m >= mcount[p]) {  // no match: the empty outputs
    if (lane < 4) quat_out[pm * 4 + lane] = 0.0f;
    if (lane == 0) {
      hit_count[pm] = 0;
      row_overflow[pm] = 0;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char shm[];
  unsigned char* region = shm + w * warp_bytes;
  MatchPrelude& pre = *reinterpret_cast<MatchPrelude*>(region);
  float* s_n = reinterpret_cast<float*>(region + kPreludeBytes);
  float* s_norm = s_n + 3 * F;
  float* s_d13 = s_norm + F;
  float* s_P = s_d13 + F;
  float* t_n = s_P + 9 * F;
  float* t_norm = t_n + 3 * F;
  float* t_d23 = t_norm + F;
  unsigned char* s_ok = reinterpret_cast<unsigned char*>(t_d23 + F);
  unsigned char* t_ok = s_ok + F;

  const float* N1 = f1.normal + p * F * 3;
  const float* C1 = f1.centroid + p * F * 3;
  const float* N2 = f2.normal + p * F * 3;
  const float* C2 = f2.centroid + p * F * 3;

  if (lane == 0) {
    const int i1 = (int)mi1[pm], j1 = (int)mj1[pm];
    const int i2 = (int)mi2[pm], j2 = (int)mj2[pm];
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
    float R[9], m2r[3], c[3];
    rotation_between_planes(n1, m1, n2, m2, R, m2r);
    cross3(n1, m1, c);
    normalize3(c, pre.n1cm1);
    cross3(n2, m2r, c);
    normalize3(c, pre.n2cm2);
    pre.D0 = sub(dot3(c11, n1), dot3(c21, n2));
    pre.D1 = sub(dot3(c12, m1), dot3(c22, m2r));
    // The fallback translation: the point-size-weighted base centroids.
    const float* W1 = f1.point_size + p * F;
    const float* W2 = f2.point_size + p * F;
    const float w11 = W1[i1], w12 = W1[j1], w21 = W2[i2], w22 = W2[j2];
    const float sden = clamp_min(add(w11, w12), kEps);
    const float tden = clamp_min(add(w21, w22), kEps);
    float sc[3], tc[3], Rtc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sc[k] = dv(add(mul(c11[k], w11), mul(c12[k], w12)), sden);
      tc[k] = dv(add(mul(c21[k], w21), mul(c22[k], w22)), tden);
    }
    matvec3(R, tc, Rtc);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pre.t_fb[k] = sub(sc[k], Rtc[k]);
      pre.n1[k] = n1[k];
      pre.m1[k] = m1[k];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) pre.R[k] = R[k];
    matrix_to_quat(R, pre.quat);
    pre.i1 = i1;
    pre.j1 = j1;
    pre.i2 = i2;
    pre.j2 = j2;
  }
  __syncwarp();

  for (int x = lane; x < 2 * F; x += 32) {
    if (x < F) {  // source face s
      const int s = x;
      float ns[3], cs[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ns[k] = N1[3 * s + k];
        cs[k] = C1[3 * s + k];
      }
      const bool ok = f1.valid[p * F + s] &&
                      fabsf(dot3(ns, pre.n1cm1)) > plane_threshold &&
                      s != pre.i1 && s != pre.j1;
      s_ok[s] = ok;
      if (ok) {
#pragma unroll
        for (int k = 0; k < 3; ++k) s_n[3 * s + k] = ns[k];
        s_norm[s] = norm3(ns);
        s_d13[s] = dot3(cs, ns);
        // A's rows n1, m1, n_s; P = inv(A^T A) A^T, each product in index
        // order (small_matmul), the inverse by the adjugate (_inv3x3).
        const float* A[3] = {pre.n1, pre.m1, ns};
        float G[9];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            G[3 * i + j] =
                add(add(mul(A[0][i], A[0][j]), mul(A[1][i], A[1][j])),
                    mul(A[2][i], A[2][j]));
        const float a = G[0], b = G[1], c = G[2], d = G[3], e = G[4],
                    f = G[5], g = G[6], h = G[7], i = G[8];
        const float co[9] = {
            sub(mul(e, i), mul(f, h)), sub(mul(c, h), mul(b, i)),
            sub(mul(b, f), mul(c, e)), sub(mul(f, g), mul(d, i)),
            sub(mul(a, i), mul(c, g)), sub(mul(c, d), mul(a, f)),
            sub(mul(d, h), mul(e, g)), sub(mul(b, g), mul(a, h)),
            sub(mul(a, e), mul(b, d))};
        float det = add(add(mul(a, co[0]), mul(b, co[3])), mul(c, co[6]));
        det = fabsf(det) > kDetFloor ? det : kDetFloor;
        float inv[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) inv[k] = dv(co[k], det);
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            s_P[9 * s + 3 * r + q] = add(
                add(mul(inv[3 * r], A[q][0]), mul(inv[3 * r + 1], A[q][1])),
                mul(inv[3 * r + 2], A[q][2]));
      }
    } else {  // target face t, rotated by R (small_matmul with R^T)
      const int t = x - F;
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
      const bool ok = f2.valid[p * F + t] &&
                      fabsf(dot3(nt, pre.n2cm2)) > plane_threshold &&
                      t != pre.i2 && t != pre.j2;
      t_ok[t] = ok;
      if (ok) {
#pragma unroll
        for (int k = 0; k < 3; ++k) t_n[3 * t + k] = nt[k];
        t_norm[t] = norm3(nt);
        t_d23[t] = dot3(ct, nt);
      }
    }
  }
  __syncwarp();

  // The (s, t) slots in slot order, a lane each, 32 at a time, ranked by
  // the warp's ballot; past K + 1 valid slots the rest cannot change the
  // kept hits or the overflow.
  float* to = t_out + pm * K * 3;
  const int FF = F * F;
  int running = 0;
  for (int first = 0; first < FF && running <= K; first += 32) {
    const int slot = first + lane;
    bool ok = false;
    int s = 0, t = 0;
    if (slot < FF) {
      s = slot / F;
      t = slot - s * F;
      if (s_ok[s] && t_ok[t]) {
        const float* ns = s_n + 3 * s;
        const float* nt = t_n + 3 * t;
        ok = angle_of(dot3(ns, nt), s_norm[s], t_norm[t]) < normal_threshold;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    const int rank = running + __popc(bal & ((1u << lane) - 1u));
    if (ok && rank < K) {
      const float* P = s_P + 9 * s;
      const float D2 = sub(s_d13[s], t_d23[t]);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        to[3 * rank + r] =
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
      for (int r = 0; r < 3; ++r) to[r] = pre.t_fb[r];
    }
    hit_count[pm] = total < K ? total : K;
    row_overflow[pm] = total > K;
  }
  if (lane < 4) quat_out[pm * 4 + lane] = pre.quat[lane];
}

// ---------------------------------------------------------------- H3 --

__global__ void __launch_bounds__(kEmitThreads)
hyp_emit_kernel(const int* __restrict__ hit_count,
                const unsigned char* __restrict__ row_overflow,
                const float* __restrict__ quat,
                const float* __restrict__ hit_t,
                const int* __restrict__ mtype,
                const unsigned char* __restrict__ m_overflow, long long M,
                int K, long long H, float* q_out, float* t_out, int* type_out,
                unsigned char* valid_out, int* count_out,
                unsigned char* overflow_out) {
  extern __shared__ int ends[];  // (M) each match's last place + 1
  __shared__ int wsum[32];
  const long long p = blockIdx.y;
  const int* cnt = hit_count + p * M;
  // A contiguous run of matches a thread, scanned over the block.
  const long long run = (M + blockDim.x - 1) / blockDim.x;
  const long long lo = threadIdx.x * run;
  const long long hi = lo + run < M ? lo + run : M;
  int n = 0;
  bool over = false;
  for (long long m = lo; m < hi; ++m) {
    n += cnt[m];
    over |= row_overflow[p * M + m] != 0;
  }
  const bool any_row = __syncthreads_or(over);
  int total;
  int end = block_exclusive_scan(n, wsum, &total);
  for (long long m = lo; m < hi; ++m) {
    end += cnt[m];
    ends[m] = end;
  }
  __syncthreads();
  const long long kept = total < H ? total : H;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < H) {
    const long long h = p * H + e;
    if (e < kept) {
      // Place e is hit k of the first match whose end is past e.
      long long a = 0, b = M - 1;
      while (a < b) {
        const long long mid = (a + b) >> 1;
        if (ends[mid] > e) b = mid; else a = mid + 1;
      }
      const long long pm = p * M + a;
      const long long k = e - (ends[a] - cnt[a]);
#pragma unroll
      for (int r = 0; r < 4; ++r) q_out[4 * h + r] = quat[4 * pm + r];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        t_out[3 * h + r] = hit_t[(pm * K + k) * 3 + r];
      type_out[h] = mtype[pm];
      valid_out[h] = 1;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) q_out[4 * h + r] = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r) t_out[3 * h + r] = 0.0f;
      type_out[h] = 0;
      valid_out[h] = 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    count_out[p] = (int)kept;
    overflow_out[p] = total > H || m_overflow[p] != 0 || any_row;
  }
}

__global__ void hyp_acos_probe_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = acosf(x[i]);
}

long long match_shared_bytes(int B) { return (long long)B * 50; }

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
  if (P > 0x7fffffffLL || (long long)B * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long bytes = match_shared_bytes(B);
  cudaError_t err = allow_shared(hyp_matches_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const CloudFaces c1{(const float*)n1, (const float*)th1,
                      (const unsigned char*)v1};
  const CloudFaces c2{(const float*)n2, (const float*)th2,
                      (const unsigned char*)v2};
  hyp_matches_kernel<<<(unsigned)P, kMatchThreads, bytes,
                       (cudaStream_t)stream>>>(
      c1, c2, F, B, M, angle_min, angle_max, rough_threshold, angle_same,
      (int*)count, (unsigned char*)overflow, (unsigned char*)mvalid,
      (long long*)mi1, (long long*)mj1, (long long*)mi2, (long long*)mj2,
      (int*)mtype);
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
  const long long warp_bytes = slot_warp_bytes(F);
  long long warps = kMaxShared / warp_bytes;
  warps = warps < kSlotWarps ? warps : kSlotWarps;
  const long long blocks = (M + warps - 1) / (warps > 0 ? warps : 1);
  if (P > 65535 || warps < 1 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long bytes = warps * warp_bytes;
  cudaError_t err = allow_shared(hyp_slots_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const Faces f1{(const float*)n1, (const float*)c1, (const float*)w1,
                 (const unsigned char*)v1};
  const Faces f2{(const float*)n2, (const float*)c2, (const float*)w2,
                 (const unsigned char*)v2};
  hyp_slots_kernel<<<dim3((unsigned)blocks, (unsigned)P),
                     (unsigned)(32 * warps), bytes, (cudaStream_t)stream>>>(
      f1, f2, (const int*)mcount, (const long long*)mi1,
      (const long long*)mj1, (const long long*)mi2, (const long long*)mj2, F,
      M, K, plane_threshold, normal_threshold, warp_bytes, (float*)quat,
      (float*)t, (int*)hit_count, (unsigned char*)row_overflow);
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
  const long long blocks = H > 0 ? (H + kEmitThreads - 1) / kEmitThreads : 1;
  const long long bytes = M * (long long)sizeof(int);
  if (P > 65535 || M <= 0 || M * K > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_shared(hyp_emit_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  hyp_emit_kernel<<<dim3((unsigned)blocks, (unsigned)P), kEmitThreads, bytes,
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
