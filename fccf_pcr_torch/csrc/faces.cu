// The faces stage's plane fit and label segment sums on Hopper (sm_90a),
// with a plain C interface bound with ctypes by
// fccf_pcr_torch/ops/faces_kernels.py. Neither replaces a Pallas kernel:
// the JAX package's compiled program runs both as fused XLA loops, where
// the port ran them as chains of some 500 PyTorch kernels a step.
//
// F1, fccf_faces_plane_fit: the voxel plane fit of features/faces.py, one
// thread a voxel: ops/eigen3.py::plane_fit_from_cov (the JAX package's
// fccf_pcr_tpu/ops/eigen3.py::plane_fit_from_cov), the point-count and
// curvature gates, the orientation of each normal toward its cloud's
// centroid and the residual gate. Bit for bit the plain version's
// operations on the card, in their order:
//   - eigen3's _fma and _sqrt run in float64 and round to float32 (two
//     roundings, not one fused multiply-add), as fma_d / f64_sqrt do;
//   - cosf and atan2f are CUDA's, as torch.cos / torch.atan2 call them
//     (no fast math; faces_kernels.math_probe holds them to torch's);
//   - clamp keeps a NaN and is fmaxf / fminf otherwise, as torch's;
//   - A - lam * I subtracts lam * 0.0 off the diagonal too (with lam < 0
//     that is -0.0, which turns a -0.0 entry into +0.0);
//   - the best cross product is torch.argmax's: the first NaN, else the
//     first largest;
//   - the orientation's 3-entry torch.sum adds as torch's CUDA reduce
//     does for rows that short (tsum3, as csrc/lm.cu's;
//     tools/torch_sum_order.py probes it).
// Bound: the bytes (53 read and 18 written a voxel); its ~420 operations
// a voxel (float64 ones counted twice) take less at the card's rate. Its
// time goes to instructions, most of it to the float64 chain (its ~100
// float32 <-> float64 conversions issue at an eighth of float32's rate),
// less to the float32 divisions, cosf and atan2f (timing builds without
// either, PERF.md section 6). Each float operand is converted to float64
// once and reused (the chosen normal's squared length is the sum of
// squares already formed), the cloud's index is a 32-bit division, and
// the blocks are 64 threads, with 128 the fastest of 32-256 in turns;
// staging the loads through shared memory was slower.
//
// F2, fccf_faces_segment_sum / fccf_faces_face_stats: the per-label sums
// of features/faces.py's face statistics and roughness, from the labels
// as they come (int64, unsorted) and the valid flags: seg = valid ?
// min(label, V - 1) : V, and the sums are those of the plain version's
// doubling scan over the rows sorted stably by seg (torch.sort(seg,
// stable=True)), which replace the JAX package's one-hot contraction
// (fccf_pcr_tpu/features/faces.py:163-197) in the port. At step d = 1, 2,
// 4, ... < n every sorted row i >= d becomes x[i] + (same label as row i
// - d ? x[i - d] : +0.0), rows below d kept as they are (so a -0.0 turns
// +0.0 wherever the +0.0 is added, and a row's NaN keeps its bits where
// no add touches it); each label's last row holds its sum, which goes to
// the label's slot; slots no label runs to are +0.0, and rows of seg V
// or of a negative seg are dropped. Only a label's last row is read, so
// only the tree of adds it depends on is made: numbering a label's rows
// m = 0, 1, ... from its last, step d adds node m + d into node m where
// m = 0 mod 2d and m + d is a row of the label, and +0.0 where it is not
// and the node's sorted position is at least d (a +0.0 added twice gives
// the bits of one). That tree needs a label's rows and its last row's
// position among all of the cloud's sorted rows, nothing else.
//
// One launch a call: a grid of (S, B) blocks of 1024 threads, S blocks
// a cloud, one a kSplitRows = 1152 rows up to kMaxSplits = 8 (8 at
// heritage's 9216 rows, one wave of 128 blocks on the card's 132 SMs; 2
// at office's 1536):
//   1. every block reads its cloud's labels and valid flags (through L2
//      after the first block) into 32-bit keys (seg as int32, at least
//      -2^31, sign flipped, so their unsigned order is seg's) and counts
//      them by bucket (negative segs, each slot, the invalid rows) in
//      shared memory, an atomic a run of one bucket in a thread's rows;
//      an atomic adds a count and decides no position. Scanned, the
//      counts give every bucket's first row in the cloud's stable order;
//   2. block r takes the slots from the one whose rows start at or after
//      the r-th S-th of the slots' rows, so whole labels, balanced by
//      rows; it compacts its rows in row order (warp ballots) and sorts
//      them stably by key: least-significant-digit passes over the 6-bit
//      digits in which they differ (two at the presets), each pass a
//      warp's chunk counted by __match_any_sync and a popcount, the
//      (digit, warp) counts scanned digit-major and the rows placed. Row q
//      of that order is row start[k_lo] + q of the cloud's: torch.sort's
//      stable order (a seg below -2^31 sorts as -2^31, among its peers by
//      row; the sum forms drop the negative and the invalid rows and never
//      sort them, so no sum depends on it);
//   3. a label inside the 32-row aligned window of its last row is summed
//      by the window's warp, all such labels of a window at once by
//      shuffles; a longer one is cut into 128-row chunks from its end,
//      4 rows a lane summed in registers and the lanes by shuffles, and
//      the chunk totals are reduced by the same tree 32 at a time by one
//      warp a label. The sources are gathered by row as they are summed,
//      each row read once by the block that sums it; the face statistics'
//      columns (centroid * w, normal * w, w with w = float(count) of a
//      valid row) are formed from them and never written, the count
//      column is the label's length (its sum of ones is exact below 2^24
//      rows), and the tail is done at the slot: a centroid or normal sum
//      divided by max(psize, 1e-12), psize as it is, and the count as
//      int32. The slots no label runs to are zeros, written without a
//      division (0 / 1e-12 takes __fdiv_rn's slow path), the cloud's
//      slots split evenly over its blocks.
// The work a block does is the keys, counts and compaction of all of its
// cloud's rows (every block of a cloud reads them) and the sort and sums
// of 1/S of them; a label is summed whole by one block, so a face that
// covers most of a cloud sets its block's time. The bound counts the
// labels, the valid flags and the sources read once and the outputs
// written once (PERF.md section 6). The order form
// (fccf_faces_label_order), for tests to hold to torch.sort, writes the
// order and seg_s instead of sums: each block its range of slots as the
// sum forms sort it, then the rows they drop, the negative segs sorted
// by the first block and the invalid rows by the last, each bucket's
// rows at its start.
//
// Every entry launches on the given stream, allocates nothing and
// returns cudaGetLastError() after its launch. Built with nvcc
// --fmad=false and no fast math; the arithmetic is written with the _rn
// intrinsics besides.

#include <cuda_runtime.h>

#include <climits>

namespace {

// eigen3.py's constants: float32(1 / 3), float32(1 / 6), float32(2 pi / 3)
// and the Python floats 1e-20 and 1e-12 as torch casts them to float32.
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kSixth = static_cast<float>(1.0 / 6.0);
constexpr float kTwoPi3 = static_cast<float>(2.0 * 3.141592653589793 / 3.0);
constexpr float kEps = static_cast<float>(1e-20);
constexpr float kNormalFloor = static_cast<float>(1e-12);
constexpr float kPsizeFloor = static_cast<float>(1e-12);

// F1's block size: with 128 the fastest of 32-256 in turns.
constexpr int kFitThreads = 64;

// ------------------------------------------------------------------ F1 --

// eigen3._fma with its operands already in float64: a * b + c (a * b is
// exact there), rounded to float32.
__device__ __forceinline__ float fma_d(double a, double b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

__device__ __forceinline__ double f2d(float x) { return (double)x; }

// eigen3._sqrt: the float64 square root rounded to float32.
__device__ __forceinline__ float f64_sqrt(float x) {
  return __double2float_rn(__dsqrt_rn((double)x));
}

// torch.clamp(v, min=lo) / torch.clamp(v, lo, hi) on the card.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// eigen3._sum_sq: x^2 + y^2 + z^2 as _fma(z, z, _fma(y, y, x * x)), with
// y and z given in float64.
__device__ __forceinline__ float sum_sq(float x, double y, double z) {
  return fma_d(z, z, f2d(fma_d(y, y, f2d(__fmul_rn(x, x)))));
}

// eigen3._cross of rows a and b, given in float32 and float64.
__device__ __forceinline__ void cross(const float a[3], const double da[3],
                                      const float b[3], const double db[3],
                                      float c[3]) {
  c[0] = fma_d(da[1], db[2], f2d(-__fmul_rn(a[2], b[1])));
  c[1] = fma_d(da[2], db[0], f2d(-__fmul_rn(a[0], b[2])));
  c[2] = fma_d(da[0], db[1], f2d(-__fmul_rn(a[1], b[0])));
}

// torch.sum of 3 entries on the card: block_width 2, thread 0 holds
// entries 0 and 2, thread 1 entry 1 (csrc/lm.cu's tsum3).
__device__ __forceinline__ float tsum3(float a0, float a1, float a2) {
  const float s0 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(0.0f, a0), __fadd_rn(0.0f, a2)), 0.0f),
      0.0f);
  const float s1 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(0.0f, a1), 0.0f), 0.0f), 0.0f);
  return __fadd_rn(s0, s1);
}

// A thread a voxel.
__global__ void __launch_bounds__(kFitThreads)
faces_plane_fit_kernel(const float* __restrict__ cov,
                       const float* __restrict__ centroid,
                       const int* __restrict__ count,
                       const unsigned char* __restrict__ valid,
                       const float* __restrict__ gcent,
                       float* __restrict__ normal_out,
                       float* __restrict__ curv_out,
                       unsigned char* __restrict__ vvalid_out,
                       unsigned char* __restrict__ gate_out, long long total,
                       long long V, int point_threshold,
                       float curvature_threshold) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < total) {
    // The cloud: a 32-bit division where the voxels fit in 32 bits.
    const long long b = total <= 0x7fffffffLL
                            ? (long long)((unsigned)i / (unsigned)V)
                            : i / V;

    // covn = cov / clamp(amax(|cov|), 1e-20); amax keeps a NaN.
    float A[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) A[k] = cov[i * 9 + k];
    float scale = fabsf(A[0]);
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      const float a = fabsf(A[k]);
      scale = (isnan(scale) || scale > a) ? scale : a;
    }
    scale = clamp_min(scale, kEps);
#pragma unroll
    for (int k = 0; k < 9; ++k) A[k] = __fdiv_rn(A[k], scale);

    // eigen3._trig_form.
    const float a00 = A[0], a01 = A[1], a02 = A[2];
    const float a11 = A[4], a12 = A[5], a22 = A[8];
    const float trace = __fadd_rn(__fadd_rn(a00, a11), a22);
    const double dtrace = f2d(trace), third = f2d(kThird);
    const float q = __fmul_rn(trace, kThird);
    const float b00 = fma_d(-dtrace, third, f2d(a00));
    const float b11 = fma_d(-dtrace, third, f2d(a11));
    const float b22 = fma_d(-dtrace, third, f2d(a22));
    const float p2 =
        __fadd_rn(sum_sq(b11, f2d(b00), f2d(b22)),
                  __fmul_rn(sum_sq(a02, f2d(a01), f2d(a12)), 2.0f));
    const float p = f64_sqrt(clamp_min(__fmul_rn(p2, kSixth), 0.0f));
    const float p_safe = clamp_min(p, kEps);
    const float c00 = __fdiv_rn(b00, p_safe), c01 = __fdiv_rn(a01, p_safe);
    const float c02 = __fdiv_rn(a02, p_safe), c11 = __fdiv_rn(b11, p_safe);
    const float c12 = __fdiv_rn(a12, p_safe), c22 = __fdiv_rn(b22, p_safe);
    const double dc01 = f2d(c01), dc12 = f2d(c12), dc22 = f2d(c22);
    const float m0 = fma_d(f2d(c11), dc22, f2d(-__fmul_rn(c12, c12)));
    const float m1 = fma_d(dc01, dc22, f2d(-__fmul_rn(c12, c02)));
    const float m2 = fma_d(dc01, dc12, f2d(-__fmul_rn(c11, c02)));
    const float det =
        fma_d(f2d(c02), f2d(m2),
              f2d(fma_d(f2d(c00), f2d(m0), f2d(-__fmul_rn(c01, m1)))));
    const float r = clamp_to(__fmul_rn(det, 0.5f), -1.0f, 1.0f);
    const float acos_r = atan2f(
        f64_sqrt(__fmul_rn(__fsub_rn(1.0f, r), __fadd_rn(r, 1.0f))), r);
    const float two_p = __fmul_rn(p, 2.0f);

    // eigen3._eigvals and the curvature.
    const double dtwo_p = f2d(two_p), dq = f2d(q);
    const float phi = __fmul_rn(acos_r, kThird);
    const float l0 = fma_d(dtwo_p, f2d(cosf(__fadd_rn(phi, kTwoPi3))), dq);
    const float l2 = fma_d(dtwo_p, f2d(cosf(phi)), dq);
    const float l1 = __fsub_rn(__fsub_rn(trace, l0), l2);
    const float lsum = __fadd_rn(__fadd_rn(l0, l1), l2);
    const float alsum = fabsf(lsum);
    const float curv = alsum > kEps
                           ? __fdiv_rn(fabsf(l0), clamp_min(alsum, kEps))
                           : 0.0f;

    // The eigenvector's copy of l0, then eigen3._eigvec_for.
    const float lam = fma_d(
        dtrace, third,
        f2d(__fmul_rn(two_p,
                    cosf(fma_d(f2d(acos_r), third, f2d(kTwoPi3))))));
    float B[3][3];
    double dB[3][3];
#pragma unroll
    for (int rr = 0; rr < 3; ++rr)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        B[rr][cc] = __fsub_rn(A[rr * 3 + cc],
                              __fmul_rn(lam, rr == cc ? 1.0f : 0.0f));
        dB[rr][cc] = f2d(B[rr][cc]);
      }
    float cand[3][3];
    cross(B[0], dB[0], B[1], dB[1], cand[0]);
    cross(B[0], dB[0], B[2], dB[2], cand[1]);
    cross(B[1], dB[1], B[2], dB[2], cand[2]);
    int best = 0;
    float best_norm = sum_sq(cand[0][0], f2d(cand[0][1]), f2d(cand[0][2]));
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      const float nk = sum_sq(cand[k][0], f2d(cand[k][1]), f2d(cand[k][2]));
      if (!isnan(best_norm) && (isnan(nk) || nk > best_norm)) {
        best = k;
        best_norm = nk;
      }
    }
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[c] = best == 0 ? cand[0][c] : (best == 1 ? cand[1][c] : cand[2][c]);
    // sum_sq of the chosen row is best_norm itself: the same operations.
    const float nrm = f64_sqrt(best_norm);
    float nv3[3];
    if (nrm > kNormalFloor) {
      const float dd = clamp_min(nrm, kEps);
#pragma unroll
      for (int c = 0; c < 3; ++c) nv3[c] = __fdiv_rn(v[c], dd);
    } else {
      nv3[0] = 0.0f;
      nv3[1] = 0.0f;
      nv3[2] = 1.0f;
    }

    // The gates and the orientation toward the cloud's centroid.
    const bool enough = count[i] > point_threshold;
    const bool planar = curv < curvature_threshold;
    const bool ok = valid[i] != 0;
    float to_c[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      to_c[c] = __fsub_rn(centroid[i * 3 + c], gcent[b * 3 + c]);
    const bool flip =
        tsum3(__fmul_rn(to_c[0], nv3[0]), __fmul_rn(to_c[1], nv3[1]),
              __fmul_rn(to_c[2], nv3[2])) < 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) normal_out[i * 3 + c] = flip ? nv3[c] : -nv3[c];
    curv_out[i] = curv;
    vvalid_out[i] = ok && enough && planar;
    gate_out[i] = ok && enough && !planar;
  }
}

// cosf(x) and atan2f(y, x) of each entry: the functions F1 calls, for
// faces_kernels.math_probe to hold to torch.cos and torch.atan2.
__global__ void faces_math_probe_kernel(const float* __restrict__ x,
                                        const float* __restrict__ y,
                                        float* __restrict__ cos_out,
                                        float* __restrict__ atan2_out,
                                        long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  cos_out[i] = cosf(x[i]);
  atan2_out[i] = atan2f(y[i], x[i]);
}

// ------------------------------------------------------------------ F2 --

enum Form { kValues = 0, kFaceStats = 1, kOrder = 2 };
// Sums of a face-statistics label: centroid * w (3), normal * w (3), w.
constexpr int kStatSums = 7;
constexpr int kSegThreads = 1024;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kDigitBits = 6;
constexpr int kBuckets = 1 << kDigitBits;
// The radix counts, a row a digit and a column a warp, padded so the
// warps' columns fall in different banks.
constexpr int kHistStride = kSegWarps + 1;
constexpr int kHistWords = kBuckets * kHistStride;
// Blocks a cloud: one a kSplitRows rows, up to kMaxSplits.
constexpr int kMaxSplits = 8;
constexpr int kSplitRows = 1152;
constexpr unsigned kFlip = 0x80000000u;
// Rows of a long label's chunk: 4 a lane.
constexpr int kChunk = 128;
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory an F2 block may take on an H100: 227 KB less its
// static words (the radix counts and a few reductions).
constexpr long long kMaxSmem = 232448 - 4LL * kHistWords - 1024;

template <int FORM>
struct Columns {
  static constexpr int D = FORM == kFaceStats ? kStatSums : 1;
};

struct Sources {
  const long long* labels;      // (B, n)
  const unsigned char* valid;   // (B, n)
  const float* values;          // kValues: (B, n)
  const int* count;             // kFaceStats: (B, n)
  const float* centroid;        // (B, n, 3)
  const float* normal;          // (B, n, 3)
};

struct Outputs {
  float* sums;        // kValues: (B, V)
  float* c;           // kFaceStats: (B, V, 3)
  float* nrm;         // (B, V, 3)
  float* psize;       // (B, V)
  int* vcount;        // (B, V)
  long long* seg_s;   // kOrder: (B, n)
  long long* order;   // (B, n)
};

__host__ __device__ __forceinline__ long long align16(long long x) {
  return (x + 15) & ~15LL;
}

// Bytes a block works in: the keys (by row), the buckets' counts then
// starts (V + 3), two index buffers of idx_bytes a row (the block's rows,
// then the radix passes' spare), a long label's end, start, first chunk
// and first total by 32-row window, and the chunk totals (a long label of
// L > kChunk rows has ceil(L / kChunk) <= L / 64 chunks).
__host__ __device__ __forceinline__ long long layout_bytes(long long n,
                                                           long long V, int D,
                                                           int idx_bytes) {
  return align16(4 * n) + align16(4 * (V + 3)) + 2 * align16(idx_bytes * n) +
         align16(16 * (n / 32 + 3)) + align16(4LL * D * (n / 64 + 2));
}

// seg of source row r, and its sort key: seg as int32 (at least -2^31),
// sign flipped, so the keys' unsigned order is seg's.
__device__ __forceinline__ long long seg_of(const Sources& s, long long r,
                                            long long V) {
  const long long label = s.labels[r];
  return s.valid[r] ? min(label, V - 1) : V;
}
__device__ __forceinline__ unsigned key_of(long long seg) {
  return (unsigned)(int)max(seg, (long long)INT_MIN) ^ kFlip;
}
// A key's bucket: 0 for a negative seg, seg + 1 for seg in [0, V] (slot
// s is bucket s + 1; V, the invalid rows, is bucket V + 1).
__device__ __forceinline__ int bucket_of(unsigned k) {
  return k < kFlip ? 0 : (int)(k - kFlip) + 1;
}

// Block-wide exclusive sum of one value a thread (kSegThreads threads);
// ``*total`` gets the sum of all.
__device__ __forceinline__ unsigned block_exclusive(unsigned x, unsigned* s,
                                                    unsigned* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s[w] = inc;
  __syncthreads();
  unsigned tot = s[lane];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, tot, o);
    if (lane >= o) tot += y;
  }
  const unsigned before = __shfl_sync(kFull, tot, (w + 31) & 31);
  *total = __shfl_sync(kFull, tot, 31);
  __syncthreads();
  return (w == 0 ? 0u : before) + inc - x;
}

// One stable pass of the radix sort by the digit at ``shift``: the m
// entries of ``in`` to ``out`` (row indices; the keys by row). Warp w
// takes the w-th chunk of entries, 32 at a time in order; lanes of one
// digit find each other by __match_any_sync (a little faster here than a
// ballot a bit of the digit), and a lane's place among them is the count
// of lower lanes; the per-(digit, warp) counts are scanned digit-major.
template <typename IDX>
__device__ void radix_pass(const unsigned* key, const IDX* in, IDX* out,
                           unsigned* hist, unsigned* s_red, int m,
                           int shift) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  for (int j = t; j < kHistWords; j += kSegThreads) hist[j] = 0;
  __syncthreads();
  const int C = ((m + kSegWarps - 1) / kSegWarps + 31) & ~31;
  const int lo = min(w * C, m), hi = min(lo + C, m);
  const unsigned lower = (1u << lane) - 1u;
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int p = p0 + lane;
    const unsigned dg =
        p < hi ? (key[in[p]] >> shift) & (kBuckets - 1) : kBuckets + lane;
    const unsigned peers = __match_any_sync(kFull, dg);
    if (p < hi && (peers & lower) == 0)
      hist[dg * kHistStride + w] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  {
    // Thread t: digit t / 16, warps 2 (t % 16) and 2 (t % 16) + 1.
    constexpr int kPer = kBuckets * kSegWarps / kSegThreads;
    const int dg = t / (kSegWarps / kPer), w0 = (t % (kSegWarps / kPer)) * kPer;
    unsigned v[kPer], sum = 0, total;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      v[k] = hist[dg * kHistStride + w0 + k];
      sum += v[k];
    }
    unsigned run = block_exclusive(sum, s_red, &total);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      hist[dg * kHistStride + w0 + k] = run;
      run += v[k];
    }
  }
  __syncthreads();
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int p = p0 + lane;
    const IDX row = p < hi ? in[p] : (IDX)0;
    const unsigned dg =
        p < hi ? (key[row] >> shift) & (kBuckets - 1) : kBuckets + lane;
    const unsigned peers = __match_any_sync(kFull, dg);
    unsigned base = 0;
    if (p < hi) base = hist[dg * kHistStride + w];
    __syncwarp();
    if (p < hi && (peers & lower) == 0)
      hist[dg * kHistStride + w] = base + __popc(peers);
    __syncwarp();
    if (p < hi) out[base + __popc(peers & lower)] = row;
  }
  __syncthreads();
}

// The cloud's rows of buckets [k_lo, k_hi) in row order, to ``rows``: a
// stable compaction, warp w a chunk of the n rows, 32 at a time, placed
// by ballots. Returns the bits in which their keys differ.
template <typename IDX>
__device__ unsigned compact_rows(const unsigned* key, int n, int k_lo,
                                 int k_hi, IDX* rows, unsigned* hist,
                                 unsigned* s_red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned kor = 0, kand = ~0u;
  {
    const int C = ((n + kSegWarps - 1) / kSegWarps + 31) & ~31;
    const int lo = min(w * C, n), hi = min(lo + C, n);
    const unsigned lower = (1u << lane) - 1u;
    unsigned mine = 0, total;
    for (int p0 = lo; p0 < hi; p0 += 32) {
      const int i = p0 + lane;
      const int bk = i < hi ? bucket_of(key[i]) : -1;
      mine += __popc(__ballot_sync(kFull, bk >= k_lo && bk < k_hi));
    }
    // mine is the warp's count on every lane; lane 0 speaks for it.
    unsigned at = block_exclusive(lane == 0 ? mine : 0u, s_red, &total);
    at = __shfl_sync(kFull, at, 0);
    for (int p0 = lo; p0 < hi; p0 += 32) {
      const int i = p0 + lane;
      const unsigned k = i < hi ? key[i] : 0u;
      const int bk = i < hi ? bucket_of(k) : -1;
      const bool in = bk >= k_lo && bk < k_hi;
      const unsigned ballot = __ballot_sync(kFull, in);
      if (in) {
        rows[at + __popc(ballot & lower)] = (IDX)i;
        kor |= k;
        kand &= k;
      }
      at += __popc(ballot);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    kor |= __shfl_xor_sync(kFull, kor, o);
    kand &= __shfl_xor_sync(kFull, kand, o);
  }
  if (lane == 0) {
    hist[w] = kor;
    hist[kSegWarps + w] = kand;
  }
  __syncthreads();
  unsigned o_all = 0, a_all = ~0u;
#pragma unroll 8
  for (int k = 0; k < kSegWarps; ++k) {
    o_all |= hist[k];
    a_all &= hist[kSegWarps + k];
  }
  __syncthreads();
  return o_all ^ a_all;
}

// The m entries of ``rows`` sorted stably by key: LSD passes over the
// digits in which the keys differ (``diff``), ``spare`` the other buffer.
// Returns the buffer that holds them.
template <typename IDX>
__device__ const IDX* sort_rows(const unsigned* key, IDX* rows, IDX* spare,
                                unsigned* hist, unsigned* s_red, int m,
                                unsigned diff) {
  for (int shift = 0; shift < 32; shift += kDigitBits) {
    if (((diff >> shift) & (kBuckets - 1)) == 0) continue;
    radix_pass(key, rows, spare, hist, s_red, m, shift);
    IDX* x = rows;
    rows = spare;
    spare = x;
  }
  return rows;
}

// The columns of source row r (a row of a slot, so valid): the value, or
// centroid * w, normal * w and w with w = float(count).
template <int FORM>
__device__ __forceinline__ void columns(const Sources& s, long long r,
                                        float* x) {
  if constexpr (FORM == kValues) {
    x[0] = s.values[r];
  } else {
    const float w = __int2float_rn(s.count[r]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x[k] = __fmul_rn(s.centroid[r * 3 + k], w);
      x[3 + k] = __fmul_rn(s.normal[r * 3 + k], w);
    }
    x[6] = w;
  }
}

// Writes slot s of cloud b: the sums x of a label of L rows.
template <int FORM>
__device__ __forceinline__ void put(const Outputs& o, long long b, int V,
                                    int s, const float* x, int L) {
  const long long slot = b * V + s;
  if constexpr (FORM == kValues) {
    o.sums[slot] = x[0];
    return;
  }
  const float den = clamp_min(x[6], kPsizeFloor);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.c[slot * 3 + k] = __fdiv_rn(x[k], den);
    o.nrm[slot * 3 + k] = __fdiv_rn(x[3 + k], den);
  }
  o.psize[slot] = x[6];
  o.vcount[slot] = L;
}

// Writes slot s of cloud b, which no label runs to: zeros (0 / 1e-12 is
// +0.0, and __fdiv_rn takes its slow path for that divisor).
template <int FORM>
__device__ __forceinline__ void put_zero(const Outputs& o, long long b,
                                         int V, int s) {
  const long long slot = b * V + s;
  if constexpr (FORM == kValues) {
    o.sums[slot] = 0.0f;
    return;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.c[slot * 3 + k] = 0.0f;
    o.nrm[slot * 3 + k] = 0.0f;
  }
  o.psize[slot] = 0.0f;
  o.vcount[slot] = 0;
}

// One level of a label's tree on a warp's nodes: lane l holds node m (its
// rows' sum so far), the partner node sits ``dd`` lanes up (UP) or down;
// a node adds its partner where that is a row of the label, else +0.0
// where its sorted position is at least the step (``zero``).
template <int D, bool UP>
__device__ __forceinline__ void tree_level(float* x, bool node, int dd,
                                           bool partner, bool zero) {
  float pv[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    pv[k] = UP ? __shfl_up_sync(kFull, x[k], dd)
               : __shfl_down_sync(kFull, x[k], dd);
  if (!node) return;
  if (partner) {
#pragma unroll
    for (int k = 0; k < D; ++k) x[k] = __fadd_rn(x[k], pv[k]);
  } else if (zero) {
#pragma unroll
    for (int k = 0; k < D; ++k) x[k] = __fadd_rn(x[k], 0.0f);
  }
}

template <int FORM, typename IDX, bool SHARED>
__global__ void __launch_bounds__(kSegThreads)
faces_segment_sum_kernel(Sources src, Outputs out, unsigned char* scratch,
                         int n, int V, long long block_bytes) {
  constexpr int D = Columns<FORM>::D;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned hist[kHistWords];
  __shared__ unsigned s_red[kSegWarps];
  __shared__ int s_range[2];
  const int S = gridDim.x, r = blockIdx.x;
  const long long b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  unsigned char* base =
      SHARED ? smem : scratch + (b * S + r) * block_bytes;
  unsigned* key = reinterpret_cast<unsigned*>(base);
  unsigned* start = reinterpret_cast<unsigned*>(base + align16(4LL * n));
  IDX* sub0 = reinterpret_cast<IDX*>(reinterpret_cast<unsigned char*>(start) +
                                     align16(4LL * (V + 3)));
  IDX* sub1 = reinterpret_cast<IDX*>(reinterpret_cast<unsigned char*>(sub0) +
                                     align16((long long)sizeof(IDX) * n));
  int* l_end = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(sub1) +
                                      align16((long long)sizeof(IDX) * n));
  const int nwin_max = n / 32 + 2;
  int* l_start = l_end + (nwin_max + 1);
  int* l_item = l_start + (nwin_max + 1);
  int* l_tot = l_item + (nwin_max + 1);
  float* tot = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(l_end) + align16(16LL * (n / 32 + 3)));
  const long long row0 = b * n;
  const int nb = V + 2;  // buckets

  // 1. The keys, then their buckets' counts: a thread a run of rows, an
  // atomic a run of one bucket (an atomic adds a count; no atomic decides
  // a position); the invalid rows (bucket V + 1, the last) are the rows
  // left over.
  for (int j = t; j <= nb; j += kSegThreads) start[j] = 0;
  if ((n & 1) == 0 &&
      (reinterpret_cast<unsigned long long>(src.labels + row0) & 15) == 0 &&
      (reinterpret_cast<unsigned long long>(src.valid + row0) & 1) == 0) {
    // Two rows a thread a load: 16 bytes of labels, 2 of flags.
    const longlong2* lab2 =
        reinterpret_cast<const longlong2*>(src.labels + row0);
    const uchar2* val2 = reinterpret_cast<const uchar2*>(src.valid + row0);
#pragma unroll 4
    for (int i = t; i < n / 2; i += kSegThreads) {
      const longlong2 l = lab2[i];
      const uchar2 v = val2[i];
      const unsigned k0 = key_of(v.x ? min(l.x, (long long)V - 1) : V);
      const unsigned k1 = key_of(v.y ? min(l.y, (long long)V - 1) : V);
      key[2 * i] = k0;
      key[2 * i + 1] = k1;
    }
  } else {
#pragma unroll 4
    for (int i = t; i < n; i += kSegThreads) {
      key[i] = key_of(seg_of(src, row0 + i, V));
    }
  }
  __syncthreads();
  {
    const int c = (n + kSegThreads - 1) / kSegThreads;
    const int i0 = min(t * c, n), i1 = min(i0 + c, n);
    int run_bk = -1;
    unsigned run = 0;
    for (int i = i0; i < i1; ++i) {
      const int bk = bucket_of(key[i]);
      if (bk != run_bk) {
        if (run_bk >= 0 && run_bk <= V) atomicAdd(&start[run_bk], run);
        run_bk = bk;
        run = 0;
      }
      ++run;
    }
    if (run_bk >= 0 && run_bk <= V) atomicAdd(&start[run_bk], run);
  }
  __syncthreads();
  // 2. The counts scanned: start[j] is bucket j's first sorted row.
  {
    const int c = (nb + kSegThreads - 1) / kSegThreads;
    const int j0 = min(t * c, nb), j1 = min(j0 + c, nb);
    unsigned sum = 0, total;
    for (int j = j0; j < j1; ++j) sum += start[j];
    unsigned run = block_exclusive(sum, s_red, &total);
    for (int j = j0; j < j1; ++j) {
      const unsigned x = start[j];
      start[j] = run;
      run += x;
    }
    if (t == 0) start[nb] = n;
  }
  __syncthreads();

  // 3. This block's buckets [k_lo, k_hi): the rows of the slots (buckets
  // 1 .. V) split into S ranges of whole slots, balanced by rows (a range
  // starts at the first bucket that starts at or after its share of the
  // rows, found by warp 0 in 32-way steps).
  {
    const long long first = start[1], rows = (long long)start[V + 1] - first;
    auto bucket_at = [&](long long pos) {
      int a = 1, c = V + 1;  // the bucket is in [a, c]; start[c] >= pos
      while (a < c) {
        const long long span = c - a;
        const int q = a + (int)(span * (lane + 1) / 32);
        const unsigned ge = __ballot_sync(kFull, (long long)start[q] >= pos);
        const int f = __ffs(ge) - 1;
        const int a2 = f == 0 ? a : a + (int)(span * f / 32) + 1;
        c = a + (int)(span * (f + 1) / 32);
        a = a2;
      }
      return a;
    };
    if (w == 0) {
      const int lo = r == 0 ? 1 : bucket_at(first + rows * r / S);
      const int hi =
          r == S - 1 ? V + 1 : bucket_at(first + rows * (r + 1) / S);
      if (lane == 0) {
        s_range[0] = lo;
        s_range[1] = hi;
      }
    }
    __syncthreads();
  }
  const int k_lo = s_range[0], k_hi = s_range[1];
  const int P0 = (int)start[k_lo], P1 = (int)start[k_hi];
  const int m_rows = P1 - P0;

  // 4. The block's rows in row order, with the bits in which their keys
  // differ.
  const unsigned diff =
      compact_rows(key, n, k_lo, k_hi, sub0, hist, s_red);

  // 5. Their stable order: LSD passes over the digits that differ.
  const IDX* ord = sort_rows(key, sub0, sub1, hist, s_red, m_rows, diff);
  auto skey = [&](int p) { return key[ord[p - P0]]; };

  if constexpr (FORM == kOrder) {
    // The block's sorted rows, then the rows the sum forms drop: the
    // negative segs (bucket 0) sorted by the first block, the invalid rows
    // (bucket V + 1) by the last; each bucket's rows from its start.
    for (int part = 0; part < 3; ++part) {
      int lo = k_lo, hi = k_hi;
      const IDX* o = ord;
      if (part > 0) {
        lo = part == 1 ? 0 : V + 1;
        hi = lo + 1;
        if (r != (part == 1 ? 0 : S - 1) || start[hi] == start[lo]) continue;
        const unsigned d = compact_rows(key, n, lo, hi, sub0, hist, s_red);
        o = sort_rows(key, sub0, sub1, hist, s_red,
                      (int)(start[hi] - start[lo]), d);
      }
      const int at = (int)start[lo], m = (int)start[hi] - at;
      for (int q = t; q < m; q += kSegThreads) {
        const int i = (int)o[q];
        out.order[row0 + at + q] = i;
        out.seg_s[row0 + at + q] = seg_of(src, row0 + i, V);
      }
    }
    return;
  }

  // 6. Slots that no label runs to: zeros, the cloud's slots split
  // evenly over its blocks (every block has every count).
  for (int s = (int)((long long)V * r / S) + t;
       s < (int)((long long)V * (r + 1) / S); s += kSegThreads)
    if (start[s + 2] == start[s + 1]) put_zero<FORM>(out, b, V, s);

  // 7. Window j is sorted rows [32 (P0 / 32 + j), + 32). A long label ends
  // in window j and starts before it: its end, start, first chunk item
  // and first chunk total by j (end -1: none).
  const int w_first = P0 >> 5;
  const int nwin = P1 > P0 ? ((P1 - 1) >> 5) - w_first + 1 : 0;
  unsigned items = 0, totals = 0;
  for (int j0 = 0; j0 < nwin; j0 += kSegThreads) {
    const int j = j0 + t;
    int e = -1, s0 = 0;
    if (j < nwin) {
      const int bw = (w_first + j) << 5;
      if (bw > P0 && bw < P1) {
        const unsigned k = skey(bw);
        if (skey(bw - 1) == k) {
          const int bk = bucket_of(k);
          const int last = (int)start[bk + 1] - 1;
          if ((last >> 5) == (bw >> 5)) {
            e = last;
            s0 = (int)start[bk];
          }
        }
      }
    }
    const int L = e >= 0 ? e - s0 + 1 : 0;
    const unsigned nch = (unsigned)(L + kChunk - 1) / kChunk;
    unsigned sum_ch, sum_mt;
    const unsigned ex_ch = block_exclusive(nch, s_red, &sum_ch);
    const unsigned ex_mt = block_exclusive(nch > 1 ? nch : 0, s_red, &sum_mt);
    if (j < nwin) {
      l_end[j] = e;
      l_start[j] = s0;
      l_item[j] = (int)(items + ex_ch);
      l_tot[j] = (int)(totals + ex_mt);
    }
    items += sum_ch;
    totals += sum_mt;
  }
  if (t == 0) l_item[nwin] = (int)items;
  __syncthreads();

  // 8. Work items: the nwin windows, then the long labels' chunks.
  for (int u = w; u < nwin + (int)items; u += kSegWarps) {
    if (u < nwin) {
      // The labels inside window u, all at once.
      const int p = ((w_first + u) << 5) + lane;
      const bool row = p >= P0 && p < P1;
      const unsigned k = row ? skey(p) : 0u;
      const bool first = !row || p == P0 || skey(p - 1) != k;
      const bool last = !row || p == P1 - 1 || skey(p + 1) != k;
      const unsigned st = __ballot_sync(kFull, first);
      const unsigned en = __ballot_sync(kFull, last);
      const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
      const unsigned s_m = st & upto, e_m = en & ~((1u << lane) - 1u);
      const bool inside = row && s_m != 0 && e_m != 0;
      if (__ballot_sync(kFull, inside) == 0) continue;  // a long label's rows
      const int sl = inside ? 31 - __clz(s_m) : 0;
      const int el = inside ? __ffs(e_m) - 1 : 0;
      const int L = el - sl + 1, m = el - lane;
      float x[D];
      if (inside) {
        columns<FORM>(src, row0 + ord[p - P0], x);
      } else {
#pragma unroll
        for (int c = 0; c < D; ++c) x[c] = 0.0f;
      }
#pragma unroll
      for (int dd = 1; dd < 32; dd <<= 1)
        tree_level<D, true>(x, inside && (m & (2 * dd - 1)) == 0, dd,
                            m + dd <= L - 1, p >= dd);
      if (inside && m == 0) {  // p is the label's last row
        if (p >= 32) {
#pragma unroll
          for (int c = 0; c < D; ++c) x[c] = __fadd_rn(x[c], 0.0f);
        }
        put<FORM>(out, b, V, bucket_of(k) - 1, x, L);
      }
      continue;
    }
    // Chunk c of a long label: its rows m = kChunk c + 4 lane + i from
    // the end, a lane's four summed in registers by the same tree (steps
    // 1 and 2), then the lanes by shuffles (steps 4 to 64).
    const int q = u - nwin;
    int a = 0, c2 = nwin;  // the last window j with l_item[j] <= q
    while (a < c2) {
      const int mid = (a + c2) >> 1;
      if (l_item[mid] <= q) a = mid + 1; else c2 = mid;
    }
    const int j = a - 1;
    const int e = l_end[j], L = e - l_start[j] + 1;
    const int c = q - l_item[j];
    const int nch = (L + kChunk - 1) / kChunk;
    const int m = c * kChunk + 4 * lane, p = e - m;
    float y[4][D];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m + i < L) {
        columns<FORM>(src, row0 + ord[p - i - P0], y[i]);
      } else {
#pragma unroll
        for (int k = 0; k < D; ++k) y[i][k] = 0.0f;
      }
    }
    // Step 1 on nodes m and m + 2, step 2 on node m.
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      if (m + i >= L) continue;
      const bool partner = m + i + 1 <= L - 1;
      if (partner || p - i >= 1) {
#pragma unroll
        for (int k = 0; k < D; ++k)
          y[i][k] = __fadd_rn(y[i][k], partner ? y[i + 1][k] : 0.0f);
      }
    }
    if (m < L) {
      const bool partner = m + 2 <= L - 1;
      if (partner || p >= 2) {
#pragma unroll
        for (int k = 0; k < D; ++k)
          y[0][k] = __fadd_rn(y[0][k], partner ? y[2][k] : 0.0f);
      }
    }
    float* top = y[0];
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1)
      tree_level<D, false>(top, m < L && (lane & (2 * dd - 1)) == 0, dd,
                           m + 4 * dd <= L - 1, p >= 4 * dd);
    if (lane == 0) {
      if (nch == 1) {
        if (e >= kChunk) {
#pragma unroll
          for (int k = 0; k < D; ++k) top[k] = __fadd_rn(top[k], 0.0f);
        }
        put<FORM>(out, b, V, bucket_of(skey(e)) - 1, top, L);
      } else {
#pragma unroll
        for (int k = 0; k < D; ++k)
          tot[((long long)l_tot[j] + c) * D + k] = top[k];
      }
    }
  }
  __syncthreads();

  // 9. A long label of more than kChunk rows: its chunk totals, 32 at a
  // time by the same tree (node c is row m = c * stride), in place.
  for (int j = w; j < nwin; j += kSegWarps) {
    const int nch = l_item[j + 1] - l_item[j];
    if (nch <= 1) continue;
    const int e = l_end[j], L = e - l_start[j] + 1;
    float* T = tot + (long long)l_tot[j] * D;
    int cnt = nch;
    long long stride = kChunk;
    while (cnt > 1) {
      const int groups = (cnt + 31) >> 5;
      for (int g = 0; g < groups; ++g) {
        const int c = (g << 5) + lane;
        const bool on = c < cnt;
        float x[D];
#pragma unroll
        for (int k = 0; k < D; ++k)
          x[k] = on ? T[(long long)c * D + k] : 0.0f;
        const long long m = c * stride;
#pragma unroll
        for (int dd = 1; dd < 32; dd <<= 1) {
          const long long step = dd * stride;
          tree_level<D, false>(x, on && (lane & (2 * dd - 1)) == 0, dd,
                               m + step <= L - 1, e - m >= step);
        }
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < D; ++k) T[(long long)g * D + k] = x[k];
        }
        __syncwarp();
      }
      cnt = groups;
      stride <<= 5;
    }
    if (lane == 0) {
      float x[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        x[k] = T[k];
        if (e >= stride) x[k] = __fadd_rn(x[k], 0.0f);
      }
      put<FORM>(out, b, V, bucket_of(skey(e)) - 1, x, L);
    }
  }
}

// Blocks a cloud of n rows: one a kSplitRows rows, up to kMaxSplits.
int segment_splits(long long n) {
  const long long S = (n + kSplitRows - 1) / kSplitRows;
  return S < 1 ? 1 : (S > kMaxSplits ? kMaxSplits : (int)S);
}

int form_columns(int form) { return form == kFaceStats ? kStatSums : 1; }

template <int FORM>
int segment_sum(const Sources& src, const Outputs& out, void* scratch,
                long long B, long long n, long long V, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || V <= 0) return 0;
  if (B > 65535 || n >= (1LL << 24) || V >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int S = segment_splits(n);
  const int D = form_columns(FORM);
  const long long bytes = layout_bytes(n, V, D, 2);
  const dim3 grid(S, (unsigned)B);
  if (bytes <= kMaxSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        faces_segment_sum_kernel<FORM, unsigned short, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    faces_segment_sum_kernel<FORM, unsigned short, true>
        <<<grid, kSegThreads, (int)bytes, stream>>>(src, out, nullptr, (int)n,
                                                    (int)V, 0);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    faces_segment_sum_kernel<FORM, unsigned, false>
        <<<grid, kSegThreads, 0, stream>>>(src, out,
                                           (unsigned char*)scratch, (int)n,
                                           (int)V, layout_bytes(n, V, D, 4));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// F1 over B clouds of V voxels: cov (B, V, 3, 3), centroid (B, V, 3)
// float32, count (B, V) int32, valid (B, V) bool, gcent (B, 3) float32,
// all contiguous; out normal (B, V, 3), curvature (B, V) float32, vvalid
// and the residual gate (B, V) bool.
int fccf_faces_plane_fit(const void* cov, const void* centroid,
                         const void* count, const void* valid,
                         const void* gcent, void* normal, void* curvature,
                         void* vvalid, void* gate, long long B, long long V,
                         int point_threshold, float curvature_threshold,
                         void* stream) {
  if (B <= 0 || V <= 0) return 0;
  const long long total = B * V;
  const long long blocks = (total + kFitThreads - 1) / kFitThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  faces_plane_fit_kernel<<<(unsigned)blocks, kFitThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)cov, (const float*)centroid, (const int*)count,
      (const unsigned char*)valid, (const float*)gcent, (float*)normal,
      (float*)curvature, (unsigned char*)vvalid, (unsigned char*)gate, total,
      V, point_threshold, curvature_threshold);
  return (int)cudaGetLastError();
}

// Bytes of F2's scratch for B clouds of n rows and V slots: 0 where a
// block's words fit in shared memory. form 0: values, 1: face
// statistics, 2: the order.
long long fccf_faces_segment_scratch(long long B, long long n, long long V,
                                     int form) {
  const int S = segment_splits(n);
  const int D = form_columns(form);
  if (layout_bytes(n, V, D, 2) <= kMaxSmem) return 0;
  return B * S * layout_bytes(n, V, D, 4);
}

// F2, values: sums (B, V) of values (B, n) float32 by labels (B, n) int64
// and valid (B, n) bool, contiguous.
int fccf_faces_segment_sum(const void* labels, const void* valid,
                           const void* values, void* sums, void* scratch,
                           long long B, long long n, long long V,
                           void* stream) {
  Sources src{(const long long*)labels, (const unsigned char*)valid,
              (const float*)values, nullptr, nullptr, nullptr};
  Outputs out{(float*)sums, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr};
  return segment_sum<kValues>(src, out, scratch, B, n, V,
                              (cudaStream_t)stream);
}

// F2, face statistics of count (B, n) int32, valid (B, n) bool, centroid
// and normal (B, n, 3) float32 by labels (B, n) int64: c and nrm (B, V,
// 3), psize (B, V) float32 and vcount (B, V) int32.
int fccf_faces_face_stats(const void* labels, const void* valid,
                          const void* count, const void* centroid,
                          const void* normal, void* c, void* nrm,
                          void* psize, void* vcount, void* scratch,
                          long long B, long long n, long long V,
                          void* stream) {
  Sources src{(const long long*)labels, (const unsigned char*)valid, nullptr,
              (const int*)count, (const float*)centroid,
              (const float*)normal};
  Outputs out{nullptr, (float*)c, (float*)nrm, (float*)psize, (int*)vcount,
              nullptr, nullptr};
  return segment_sum<kFaceStats>(src, out, scratch, B, n, V,
                                 (cudaStream_t)stream);
}

// F2's stable order alone, as the sum forms' blocks form it: seg_s and
// order (B, n) int64 of labels (B, n) int64 and valid (B, n) bool, as
// torch.sort(seg, stable=True) gives them where no valid label is below
// -2^31.
int fccf_faces_label_order(const void* labels, const void* valid,
                           void* seg_s, void* order, void* scratch,
                           long long B, long long n, long long V,
                           void* stream) {
  Sources src{(const long long*)labels, (const unsigned char*)valid, nullptr,
              nullptr, nullptr, nullptr};
  Outputs out{nullptr, nullptr, nullptr, nullptr, nullptr, (long long*)seg_s,
              (long long*)order};
  return segment_sum<kOrder>(src, out, scratch, B, n, V,
                             (cudaStream_t)stream);
}

// cosf(x) and atan2f(y, x) of n float32 entries (faces_math_probe_kernel).
int fccf_faces_math_probe(const void* x, const void* y, void* cos_out,
                          void* atan2_out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  faces_math_probe_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)cos_out, (float*)atan2_out,
      n);
  return (int)cudaGetLastError();
}

}  // extern "C"
