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
//     roundings, not one fused multiply-add), as f64_fma / f64_sqrt do;
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
// a voxel (float64 ones counted twice) take less at the card's rate.
//
// F2, fccf_faces_segment_sum / fccf_faces_face_stats: the per-label sums
// of features/faces.py's face statistics and roughness over the rows
// sorted stably by label (the sort stays torch.sort), which replace the
// JAX package's one-hot contraction (fccf_pcr_tpu/features/faces.py
// :163-197) in the port. The sums are the plain version's doubling scan's
// own: at step d = 1, 2, 4, ... < n every row i >= d becomes
// x[i] + (same label as row i - d ? x[i - d] : +0.0), rows below d kept
// as they are (so a -0.0 turns +0.0 wherever the +0.0 is added, and a
// row's NaN keeps its bits where no add touches it); each label's last
// row holds its sum, which goes to the label's slot; slots no label runs
// to are +0.0 and rows labelled V or more are dropped. Only a label's
// last row is read, so only the adds it depends on are made: with m a
// row's distance to its label's last row and a its distance from the
// label's first row, step d adds on the rows with m = 0 mod 2d and
// i >= d, the partner's value where d <= a and +0.0 otherwise; the
// partner i - d has m = d mod 2d and takes no add at that step, so the
// steps run in place (2n adds, not n log2 n) and give the same tree of
// adds, +0.0 ones included. A block takes one (cloud, column): the
// labels, m and a and the column (the w column too for face statistics'
// centroid and normal columns) in shared memory (in a scratch slice of
// global memory where they do not fit: the same code instantiated for
// it). The sources are read in their own order, coalesced, and put in
// sorted place through the sort's inverse; m and a come from each
// thread's chunk of rows and the label ends and starts of the chunks
// around it; a thread keeps its rows' m, a and values in registers
// (up to kMaxRows rows), publishes a value when it changes, adds a row's
// +0.0 once (further ones change nothing) and skips the steps at which
// none of its rows adds; the steps are a barrier apart. The face
// statistics' eight columns (centroid * w, normal * w, w, 1 with w =
// float(count) of valid rows) are formed from their sources, so they are
// never written, and the tail is done in the block: a centroid or normal
// column divided by max(psize, 1e-12), psize as it is, and the voxel
// count rounded half to even to int32. Bound: the bytes (the sorted
// labels, the order and the sources read once, the outputs written
// once); the block is bound by its instructions and by its cloud's 8
// blocks reading their inputs through L2 (PERF.md section 6).
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

constexpr int kFitThreads = 256;
constexpr int kSegThreads = 1024;
// Rows an F2 thread keeps in registers (n <= 9216).
constexpr int kMaxRows = 9;
// Dynamic shared memory an F2 block may take on an H100: 227 KB less its
// static words.
constexpr long long kMaxSmem = 232448 - 8 * (kSegThreads / 32);

// ------------------------------------------------------------------ F1 --

// eigen3._fma: a * b + c in float64 (a * b is exact there), rounded to
// float32.
__device__ __forceinline__ float f64_fma(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

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

// eigen3._sum_sq: x^2 + y^2 + z^2 as _fma(z, z, _fma(y, y, x * x)).
__device__ __forceinline__ float sum_sq(float x, float y, float z) {
  return f64_fma(z, z, f64_fma(y, y, __fmul_rn(x, x)));
}

// eigen3._cross.
__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float c[3]) {
  c[0] = f64_fma(a[1], b[2], -__fmul_rn(a[2], b[1]));
  c[1] = f64_fma(a[2], b[0], -__fmul_rn(a[0], b[2]));
  c[2] = f64_fma(a[0], b[1], -__fmul_rn(a[1], b[0]));
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
  if (i >= total) return;
  const long long b = i / V;

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
  const float q = __fmul_rn(trace, kThird);
  const float b00 = f64_fma(-trace, kThird, a00);
  const float b11 = f64_fma(-trace, kThird, a11);
  const float b22 = f64_fma(-trace, kThird, a22);
  const float p2 = __fadd_rn(sum_sq(b11, b00, b22),
                             __fmul_rn(sum_sq(a02, a01, a12), 2.0f));
  const float p = f64_sqrt(clamp_min(__fmul_rn(p2, kSixth), 0.0f));
  const float p_safe = clamp_min(p, kEps);
  const float c00 = __fdiv_rn(b00, p_safe), c01 = __fdiv_rn(a01, p_safe);
  const float c02 = __fdiv_rn(a02, p_safe), c11 = __fdiv_rn(b11, p_safe);
  const float c12 = __fdiv_rn(a12, p_safe), c22 = __fdiv_rn(b22, p_safe);
  const float m0 = f64_fma(c11, c22, -__fmul_rn(c12, c12));
  const float m1 = f64_fma(c01, c22, -__fmul_rn(c12, c02));
  const float m2 = f64_fma(c01, c12, -__fmul_rn(c11, c02));
  const float det = f64_fma(c02, m2, f64_fma(c00, m0, -__fmul_rn(c01, m1)));
  const float r = clamp_to(__fmul_rn(det, 0.5f), -1.0f, 1.0f);
  const float acos_r = atan2f(
      f64_sqrt(__fmul_rn(__fsub_rn(1.0f, r), __fadd_rn(r, 1.0f))), r);
  const float two_p = __fmul_rn(p, 2.0f);

  // eigen3._eigvals and the curvature.
  const float phi = __fmul_rn(acos_r, kThird);
  const float l0 = f64_fma(two_p, cosf(__fadd_rn(phi, kTwoPi3)), q);
  const float l2 = f64_fma(two_p, cosf(phi), q);
  const float l1 = __fsub_rn(__fsub_rn(trace, l0), l2);
  const float lsum = __fadd_rn(__fadd_rn(l0, l1), l2);
  const float alsum = fabsf(lsum);
  const float curv = alsum > kEps
                         ? __fdiv_rn(fabsf(l0), clamp_min(alsum, kEps))
                         : 0.0f;

  // The eigenvector's copy of l0, then eigen3._eigvec_for.
  const float lam = f64_fma(
      trace, kThird,
      __fmul_rn(two_p, cosf(f64_fma(acos_r, kThird, kTwoPi3))));
  float B[3][3];
#pragma unroll
  for (int rr = 0; rr < 3; ++rr)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc)
      B[rr][cc] = __fsub_rn(A[rr * 3 + cc],
                            __fmul_rn(lam, rr == cc ? 1.0f : 0.0f));
  float cand[3][3];
  cross(B[0], B[1], cand[0]);
  cross(B[0], B[2], cand[1]);
  cross(B[1], B[2], cand[2]);
  int best = 0;
  float best_norm = sum_sq(cand[0][0], cand[0][1], cand[0][2]);
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    const float nk = sum_sq(cand[k][0], cand[k][1], cand[k][2]);
    if (!isnan(best_norm) && (isnan(nk) || nk > best_norm)) {
      best = k;
      best_norm = nk;
    }
  }
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[c] = best == 0 ? cand[0][c] : (best == 1 ? cand[1][c] : cand[2][c]);
  const float nrm = f64_sqrt(sum_sq(v[0], v[1], v[2]));
  float nv[3];
  if (nrm > kNormalFloor) {
    const float d = clamp_min(nrm, kEps);
#pragma unroll
    for (int c = 0; c < 3; ++c) nv[c] = __fdiv_rn(v[c], d);
  } else {
    nv[0] = 0.0f;
    nv[1] = 0.0f;
    nv[2] = 1.0f;
  }

  // The gates and the orientation toward the cloud's centroid.
  const bool enough = count[i] > point_threshold;
  const bool planar = curv < curvature_threshold;
  const bool ok = valid[i] != 0;
  float to_c[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    to_c[c] = __fsub_rn(centroid[i * 3 + c], gcent[b * 3 + c]);
  const bool flip = tsum3(__fmul_rn(to_c[0], nv[0]), __fmul_rn(to_c[1], nv[1]),
                          __fmul_rn(to_c[2], nv[2])) < 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) normal_out[i * 3 + c] = flip ? nv[c] : -nv[c];
  curv_out[i] = curv;
  vvalid_out[i] = ok && enough && planar;
  gate_out[i] = ok && enough && !planar;
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

enum Form { kValues = 0, kFaceStats = 1 };
constexpr int kStatColumns = 8;
constexpr int kW = 6;  // the w column (psize)

struct Sources {
  const float* values;          // kValues: (B, n)
  const int* count;             // kFaceStats: (B, n)
  const unsigned char* valid;   // (B, n)
  const float* centroid;        // (B, n, 3)
  const float* normal;          // (B, n, 3)
};

struct Outputs {
  float* sums;    // kValues: (B, V)
  float* c;       // kFaceStats: (B, V, 3)
  float* nrm;     // (B, V, 3)
  float* psize;   // (B, V)
  int* vcount;    // (B, V)
};

// Column k of face statistics' source row r: [centroid * w, normal * w, w,
// 1], w = float(count) where valid, else 0 (torch.where, then products).
__device__ __forceinline__ float stat_column(const Sources& s, int k,
                                             long long r) {
  const float w = s.valid[r] ? __int2float_rn(s.count[r]) : 0.0f;
  if (k < 3) return __fmul_rn(s.centroid[r * 3 + k], w);
  if (k < 6) return __fmul_rn(s.normal[r * 3 + k - 3], w);
  return k == kW ? w : 1.0f;
}

// 4-byte words a block stages: its column and (face statistics' centroid
// and normal columns) the w column, the labels, and m and a (the sort's
// inverse before m).
__host__ __device__ __forceinline__ long long seg_words(int form,
                                                        long long n) {
  return (form == kFaceStats ? 5 : 4) * n;
}

// Across the block's threads, a thread's chunk of rows after another's:
// the least ``end`` of the threads after this one (INT_MAX for the last)
// and the largest ``start`` of those before it (-1 for the first), by
// shuffles within the warps and across their totals, one barrier.
__device__ __forceinline__ void chunk_carries(int end, int start,
                                              int* s_end, int* s_start,
                                              int* end_after,
                                              int* start_before) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int e = end, st = start;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int te = __shfl_down_sync(0xffffffffu, e, o);
    const int ts = __shfl_up_sync(0xffffffffu, st, o);
    if (lane + o < 32) e = min(e, te);
    if (lane >= o) st = max(st, ts);
  }
  if (lane == 0) s_end[warp] = e;
  if (lane == 31) s_start[warp] = st;
  __syncthreads();
  // The warps' totals, scanned the same way by every warp.
  int we = lane > warp && lane < warps ? s_end[lane] : INT_MAX;
  int ws = lane < warp ? s_start[lane] : -1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    we = min(we, __shfl_xor_sync(0xffffffffu, we, o));
    ws = max(ws, __shfl_xor_sync(0xffffffffu, ws, o));
  }
  int ea = __shfl_down_sync(0xffffffffu, e, 1);
  int sb = __shfl_up_sync(0xffffffffu, st, 1);
  if (lane == 31) ea = INT_MAX;
  if (lane == 0) sb = -1;
  *end_after = min(ea, we);
  *start_before = max(sb, ws);
}

// Writes the result of slot s of the block's column: ``x`` its sum and
// ``w`` the w column's (face statistics' centroid and normal columns).
template <int FORM>
__device__ __forceinline__ void put(const Outputs& o, int k, long long b,
                                    long long V, long long s, float x,
                                    float w) {
  const long long slot = b * V + s;
  if (FORM == kValues) {
    o.sums[slot] = x;
  } else if (k < 6) {
    const float d = __fdiv_rn(x, clamp_min(w, kPsizeFloor));
    if (k < 3)
      o.c[slot * 3 + k] = d;
    else
      o.nrm[slot * 3 + k - 3] = d;
  } else if (k == kW) {
    o.psize[slot] = x;
  } else {
    o.vcount[slot] = (int)rintf(x);  // torch.round, then .to(int32)
  }
}

// Block (k, b): column k of cloud b, its words in shared memory (SHARED)
// or in its slice of ``scratch``. The rows are read from the sources in
// their own order (coalesced) and put in sorted place through the
// sort's inverse. m is a row's distance to its label's last row and a its
// distance from the label's first row: step d adds on row i when m = 0
// mod 2d and i >= d, its partner's value if d <= a, else +0.0. Where a
// thread has at most kMaxRows rows (i = t + q * blockDim.x) it keeps their
// m, a and values in registers, publishes a value when it changes, and
// adds the +0.0 once (further ones change nothing); otherwise it walks its
// rows in memory at every step.
template <int FORM, bool SHARED>
__global__ void __launch_bounds__(kSegThreads)
faces_segment_sum_kernel(const long long* __restrict__ seg_s,
                         const long long* __restrict__ order, Sources src,
                         Outputs out, float* scratch, int n, int V) {
  extern __shared__ float smem[];
  __shared__ int s_end[kSegThreads / 32], s_start[kSegThreads / 32];
  const int k = blockIdx.x;
  const long long b = blockIdx.y;
  const bool with_w = FORM == kFaceStats && k < 6;
  float* buf = SHARED ? smem
                      : scratch + (b * gridDim.x + k) * seg_words(FORM, n);
  float* x = buf;
  float* w = buf + n;  // with_w
  int* seg = reinterpret_cast<int*>(buf + (FORM == kFaceStats ? 2 : 1) * n);
  int* m = seg + n;  // the sort's inverse first
  int* a = m + n;
  const long long* sr = seg_s + b * n;
  const long long* orow = order + b * n;
  const long long row0 = b * n;  // the cloud's first source row
  const int T = blockDim.x, t = threadIdx.x;

#pragma unroll 4
  for (int i = t; i < n; i += T) {
    seg[i] = (int)sr[i];
    m[orow[i]] = i;
  }
  // Slots that no label runs to stay +0.0 (0 counts): every slot first.
#pragma unroll 4
  for (int s = t; s < V; s += T) put<FORM>(out, k, b, V, s, 0.0f, 0.0f);
  __syncthreads();
#pragma unroll 4
  for (int r = t; r < n; r += T) {
    const int i = m[r];
    if (FORM == kValues) {
      x[i] = src.values[row0 + r];
    } else {
      x[i] = stat_column(src, k, row0 + r);
      if (with_w) w[i] = stat_column(src, kW, row0 + r);
    }
  }
  __syncthreads();

  // m and a: a thread's chunk of rows walked from its end and from its
  // start, from the label ends and starts of the chunks around it.
  const int chunk = (n + T - 1) / T;
  const int lo = min(t * chunk, n), hi = min(lo + chunk, n);
  int first_end = INT_MAX, last_start = -1;
  for (int j = lo; j < hi; ++j)
    if (j + 1 == n || seg[j + 1] != seg[j]) {
      first_end = j;
      break;
    }
  for (int j = hi - 1; j >= lo; --j)
    if (j == 0 || seg[j - 1] != seg[j]) {
      last_start = j;
      break;
    }
  int end, start;
  chunk_carries(first_end, last_start, s_end, s_start, &end, &start);
  for (int j = hi - 1; j >= lo; --j) {
    if (j + 1 == n || seg[j + 1] != seg[j]) end = j;
    m[j] = end - j;
  }
  for (int j = lo; j < hi; ++j) {
    if (j == 0 || seg[j - 1] != seg[j]) start = j;
    a[j] = j - start;
  }
  __syncthreads();

  // The scan's steps on the rows whose value a label's last row reads.
  if (n <= kMaxRows * T) {
    int mq[kMaxRows], aq[kMaxRows];
    float xq[kMaxRows], wq[kMaxRows];
    unsigned zeroed = 0;
    int busy = -1;  // the last step at which one of the thread's rows adds
#pragma unroll
    for (int q = 0; q < kMaxRows; ++q) {
      const int i = t + q * T;
      mq[q] = i < n ? m[i] : 1;  // odd: a row past n takes no add
      aq[q] = i < n ? a[i] : 0;
      xq[q] = i < n ? x[i] : 0.0f;
      wq[q] = i < n && with_w ? w[i] : 0.0f;
      // Steps j with m = 0 mod 2^(j + 1) and 2^j <= a, and the first step
      // past those (its +0.0).
      const int node = mq[q] == 0 ? 31 : __ffs(mq[q]) - 2;
      busy = max(busy, min(node, aq[q] == 0 ? 0 : 32 - __clz(aq[q])));
    }
    int step = 0;
    for (int d = 1; d < n; d <<= 1, ++step) {
      if (step <= busy) {
#pragma unroll
        for (int q = 0; q < kMaxRows; ++q) {
          const int i = t + q * T;
          if ((mq[q] & (2 * d - 1)) != 0 || i < d) continue;
          if (d <= aq[q]) {
            xq[q] = __fadd_rn(xq[q], x[i - d]);
            if (with_w) wq[q] = __fadd_rn(wq[q], w[i - d]);
          } else if (!(zeroed >> q & 1u)) {
            zeroed |= 1u << q;
            xq[q] = __fadd_rn(xq[q], 0.0f);
            if (with_w) wq[q] = __fadd_rn(wq[q], 0.0f);
          } else {
            continue;
          }
          x[i] = xq[q];
          if (with_w) w[i] = wq[q];
        }
      }
      __syncthreads();
    }
    // Each label's last row: its sum to the label's slot.
#pragma unroll
    for (int q = 0; q < kMaxRows; ++q) {
      const int i = t + q * T;
      if (mq[q] != 0) continue;
      const int s = seg[i];
      if (s >= 0 && s < V) put<FORM>(out, k, b, V, s, xq[q], wq[q]);
    }
    return;
  }
  for (int d = 1; d < n; d <<= 1) {
    for (int i = t; i < n; i += T) {
      if ((m[i] & (2 * d - 1)) != 0 || i < d) continue;
      const bool partner = d <= a[i];
      x[i] = __fadd_rn(x[i], partner ? x[i - d] : 0.0f);
      if (with_w) w[i] = __fadd_rn(w[i], partner ? w[i - d] : 0.0f);
    }
    __syncthreads();
  }
  for (int i = t; i < n; i += T) {
    const int s = seg[i];
    if (m[i] != 0 || s < 0 || s >= V) continue;
    put<FORM>(out, k, b, V, s, x[i], with_w ? w[i] : 0.0f);
  }
}

template <int FORM>
int segment_sum(const long long* seg_s, const long long* order,
                const Sources& src, const Outputs& out, float* scratch,
                long long B, long long n, long long V, int D,
                cudaStream_t stream) {
  if (B <= 0 || n <= 0 || V <= 0) return 0;
  if (B > 65535 || n >= (1LL << 30) || V >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long bytes = 4 * seg_words(FORM, n);
  const dim3 grid(D, (unsigned)B);
  if (bytes <= kMaxSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        faces_segment_sum_kernel<FORM, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    faces_segment_sum_kernel<FORM, true><<<grid, kSegThreads, (int)bytes,
                                           stream>>>(seg_s, order, src, out,
                                                     nullptr, (int)n, (int)V);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    faces_segment_sum_kernel<FORM, false><<<grid, kSegThreads, 0, stream>>>(
        seg_s, order, src, out, scratch, (int)n, (int)V);
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

// Floats of F2's scratch for B clouds of n rows and D columns: 0 where a
// block's rows fit in shared memory. form 0: values, 1: face statistics.
long long fccf_faces_segment_scratch(long long B, long long n, int D,
                                     int form) {
  const long long words = seg_words(form, n);
  return 4 * words <= kMaxSmem ? 0 : B * D * words;
}

// F2, values: sums (B, V) of values (B, n) float32 by the sorted labels
// seg_s (B, n) int64 and the sort's order (B, n) int64, contiguous.
int fccf_faces_segment_sum(const void* seg_s, const void* order,
                           const void* values, void* sums, void* scratch,
                           long long B, long long n, long long V,
                           void* stream) {
  Sources src{(const float*)values, nullptr, nullptr, nullptr, nullptr};
  Outputs out{(float*)sums, nullptr, nullptr, nullptr, nullptr};
  return segment_sum<kValues>((const long long*)seg_s,
                              (const long long*)order, src, out,
                              (float*)scratch, B, n, V, 1,
                              (cudaStream_t)stream);
}

// F2, face statistics of count (B, n) int32, valid (B, n) bool, centroid
// and normal (B, n, 3) float32: c and nrm (B, V, 3), psize (B, V) float32
// and vcount (B, V) int32.
int fccf_faces_face_stats(const void* seg_s, const void* order,
                          const void* count, const void* valid,
                          const void* centroid, const void* normal, void* c,
                          void* nrm, void* psize, void* vcount,
                          void* scratch, long long B, long long n,
                          long long V, void* stream) {
  Sources src{nullptr, (const int*)count, (const unsigned char*)valid,
              (const float*)centroid, (const float*)normal};
  Outputs out{nullptr, (float*)c, (float*)nrm, (float*)psize, (int*)vcount};
  return segment_sum<kFaceStats>((const long long*)seg_s,
                                 (const long long*)order, src, out,
                                 (float*)scratch, B, n, V, kStatColumns,
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
