// The LM solve of refine_pairs (L1), for Hopper (sm_90a).
//
// It replaces no Pallas kernel: it is the device loop that the JAX
// package's compiled program runs for the LM refine, the lax.while_loop
// at fccf_pcr_tpu/refine/gauss_newton.py:100 (vmapped over the candidate
// lanes), which the port's plain version, refine/gauss_newton.py::lm_loop,
// runs as ~430 small PyTorch kernels an iteration.
//
// Each lane minimizes sum_i w_i^2 (|n1 x (Q n2)|^2 + (n1.p1 - (Q n2).(Q
// p2 + t))^2) over (q, t) from the identity, with the left-multiplied
// so(3) step, Levenberg-Marquardt damping and the relative 1e-6 cost
// tolerance, for at most `iters` iterations.
//
// Bit-equal to lm_loop on the card. The kernel does lm_loop's float32
// operations in its order, each rounded once (built with --fmad=false, so
// no multiply-add is contracted; sinf / cosf / sqrtf and IEEE division as
// torch's own CUDA kernels call them):
//
// - a sum of 3 or 4 entries over the last axis (torch.sum: n1.p1, the
//   offsets, the step's squared norm, the quaternion norm) adds as
//   torch's CUDA reduce kernel (ATen/native/cuda/Reduce.cuh) does for
//   rows that short, whatever their number (tsum3, tsum4;
//   tools/torch_sum_order.py probes it on the card);
// - the costs, J^T J and J^T r over the 4F residual rows add as
//   ops/batch.py's fold_sum: the first half plus the second, repeated, an
//   odd last entry carried (fold_arrays, fold_entries), so a lane rounds
//   alike in any batch and at any F;
// - a division by a Python scalar (lam / 3.0, t2 / 48.0) is torch's
//   multiply by the float32 reciprocal; the scalars are float32 values
//   of the Python doubles (e.g. (float)1e-12).
//
// Layout: n1, p1, n2, p2 (Bt, F, 3) float32, w (Bt, F) float32, all
// contiguous; q_out (Bt, 4), t_out (Bt, 3) float32; steps_out (Bt,)
// int32, the LM steps (solves) each lane ran, and accepted_out (Bt,)
// int32, how many of them it accepted.
//
// Design: a warp a lane (a block of 32 threads). lm_loop's iteration is a
// solve, a trial pose and its cost, and the test c_new < c_old; a
// rejected step changes only lam (doubled, at most 1e8), so until a step
// is accepted every solve has the same J^T J, J^T r and pose, and the
// lams of the next steps are known in advance: lam 2^j, or 1e8 from where
// that passes it (lam_at; a product by a power of two is exact). So the
// kernel runs a lane as rounds:
//
// - a solve round: thread j runs the damped 6 x 6 Cholesky solve, the
//   exponential map and the normalization (linalg6.solve_spd6's and
//   lm_loop's operations, in their order) for the step after j
//   rejections, 32 candidate steps for the latency of one;
// - trial rounds: the candidates' costs in order, G at a time (a plane a
//   thread, G = 32 / F candidates side by side where F <= 32), each a
//   fold_sum of its squared trial residuals, until one is below c_old
//   (accepted) or the iterations run out. A candidate rejected at lam =
//   1e8 is followed by the same step forever: the lane's pose is final;
// - on an accepted step, one pass over the planes at the new pose
//   computes the residual rows and the Jacobian (the trial's cost is the
//   next c_old: the same residuals of the same pose), and J^T J and J^T r
//   fold from them (27 sums).
//
// The kernel has two instantiations, picked from F at launch:
// - registers (F <= 32; every shipped preset has 16): a thread holds its
//   plane in registers, the rows and the squared residuals sit in shared
//   memory; where F is a power of two a trial cost folds by shuffles in
//   its group of F threads, and where F = 8, 16 or 32 J^T J folds a sum
//   a thread, else a row a thread and shuffles (both special cases give
//   the general folds' bits and were faster than them at F = 16 in
//   turns on an H100, tools/torch_kernel_ab.py);
// - scratch (any F): the planes are read from global memory at each use,
//   and the rows, the squared residuals and the fold's levels go through
//   a scratch buffer in global memory (L1 and L2 serve it: no other block
//   reads it), one candidate a trial round; J^T J folds level by level in
//   that buffer down to 32 entries, then by shuffles.
// The order of additions is the same in both, so the scratch one is also
// bit-equal at F <= 32. A lane stops once it is done (its tolerance met),
// its cost is not > 0 (zero or NaN: no step can be accepted, so q and t
// are final) or its pose is final; lm_loop runs such a lane on with only
// lam changing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRegPlanes = 32;             // a plane a thread, in registers
constexpr int kRegRows = 4 * kRegPlanes;   // residual rows in shared memory
constexpr int kRowStride = 8;              // J (6), r, pad
constexpr int kSums = 27;                  // J^T J (a <= b: 21), J^T r (6)
constexpr int kCands = 32;                 // candidate steps a solve round
constexpr unsigned kFull = 0xffffffffu;

// The float32 values of lm_loop's Python scalars.
__device__ __forceinline__ float f32(double x) { return (float)x; }

// torch.clamp(x, min=lo) / (x, max=hi): NaN propagates.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

// lam after j rejected steps: j times clamp(lam * 2, max=1e8), which is
// min(lam 2^j, 1e8) (lam >= 1e-10: the doubling is exact), j <= 32.
__device__ __forceinline__ float lam_at(float lam, int j) {
  return clamp_max(lam * __int_as_float((127 + j) << 23), f32(1e8));
}

// torch.sum of 3 entries on the card: block_width 2, thread 0 holds
// entries 0 and 2, thread 1 entry 1.
__device__ __forceinline__ float tsum3(float a0, float a1, float a2) {
  const float s0 = (((0.0f + a0) + (0.0f + a2)) + 0.0f) + 0.0f;
  const float s1 = (((0.0f + a1) + 0.0f) + 0.0f) + 0.0f;
  return s0 + s1;
}

// torch.sum of 4 entries on the card: block_width 4, one entry a thread,
// then the shuffle tree (0 + 2) + (1 + 3).
__device__ __forceinline__ float tsum4(float a0, float a1, float a2,
                                       float a3) {
  const float s0 = (((0.0f + a0) + 0.0f) + 0.0f) + 0.0f;
  const float s1 = (((0.0f + a1) + 0.0f) + 0.0f) + 0.0f;
  const float s2 = (((0.0f + a2) + 0.0f) + 0.0f) + 0.0f;
  const float s3 = (((0.0f + a3) + 0.0f) + 0.0f) + 0.0f;
  return (s0 + s2) + (s1 + s3);
}

// fold_sum of G arrays of n floats each (array g at buf + g * n), in place
// by the warp: each level adds the second half of an array to its first,
// then moves an odd last entry to the middle; the sums end in buf[g * n].
// Thread (g, e) takes entries e, e + tg, ... of array g, tg = 32 / G.
__device__ void fold_arrays(float* buf, long long n, int G, int lane) {
  const int tg = 32 / G;
  const int g = lane / tg, e0 = lane - g * tg;
  float* a = buf + g * n;
  for (long long m = n; m > 1; m = (m >> 1) + (m & 1)) {
    const long long h = m >> 1;
    if (g < G)
      for (long long e = e0; e < h; e += tg) a[e] = a[e] + a[e + h];
    __syncwarp();
    if (m & 1) {
      if (g < G && e0 == 0) a[h] = a[2 * h];
      __syncwarp();
    }
  }
}

// geometry.cross
__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// quat_rotate's terms: uv = u x x, rot = x + 2 (w uv + u x uv).
__device__ __forceinline__ void rotate(const float q[4], const float x[3],
                                       float uv[3], float rot[3]) {
  const float u[3] = {q[1], q[2], q[3]};
  float cuv[3];
  cross(u, x, uv);
  cross(u, uv, cuv);
#pragma unroll
  for (int c = 0; c < 3; ++c) rot[c] = x[c] + 2.0f * (q[0] * uv[c] + cuv[c]);
}

// One plane's data, in the registers of its thread.
struct Plane {
  float n1[3], n1p1, n2[3], p2[3], w;
};

// _residual_terms of one plane at (q, t): the weighted residuals r and
// what the Jacobian reuses (u x n2, u x p2, n2r, p2r).
__device__ __forceinline__ void residuals(const Plane& pl, const float q[4],
                                          const float t[3], float r[4],
                                          float uvn[3], float uvp[3],
                                          float n2r[3], float p2r[3]) {
  rotate(q, pl.n2, uvn, n2r);
  rotate(q, pl.p2, uvp, p2r);
#pragma unroll
  for (int c = 0; c < 3; ++c) p2r[c] = p2r[c] + t[c];
  float crs[3];
  cross(pl.n1, n2r, crs);
  const float off =
      pl.n1p1 - tsum3(n2r[0] * p2r[0], n2r[1] * p2r[1], n2r[2] * p2r[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) r[c] = crs[c] * pl.w;
  r[3] = off * pl.w;
}

// The tangent of one rotated vector x along direction (dw, du):
// 2 ((dw uv + w duv) + tangent of u x uv), duv = du x x, the cross
// tangent's products as _cross_tangent forms them.
__device__ __forceinline__ void rot_tangent(const float q[4], float dw,
                                            const float du[3],
                                            const float x[3],
                                            const float uv[3], float d[3]) {
  const float u[3] = {q[1], q[2], q[3]};
  float duv[3];
  cross(du, x, duv);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int r1 = (c + 1) % 3, r2 = (c + 2) % 3;
    const float ct = (du[r1] * uv[r2] + u[r1] * duv[r2]) -
                     (du[r2] * uv[r1] + u[r2] * duv[r1]);
    d[c] = 2.0f * ((dw * uv[c] + q[0] * duv[c]) + ct);
  }
}

// _residuals_and_jacobian of one plane: rows 4i + c of r and J (Bt, 4P,
// 6) into rows[], and the squared residuals into sq[].
__device__ __forceinline__ void plane_rows(const Plane& pl, const float q[4],
                                           const float t[3], long long i,
                                           float* rows, float* sq) {
  float r[4], uvn[3], uvp[3], n2r[3], p2r[3];
  residuals(pl, q, t, r, uvn, uvp, n2r, p2r);
  // _DQ_INDEX and _DQ_SIGN: the tangent of exp(v) q along v = e_k.
  const int dq_index[3][4] = {{1, 0, 3, 2}, {2, 3, 0, 1}, {3, 2, 1, 0}};
  const float dq_sign[3][4] = {{-0.5f, 0.5f, -0.5f, 0.5f},
                               {-0.5f, 0.5f, 0.5f, -0.5f},
                               {-0.5f, -0.5f, 0.5f, 0.5f}};
  float* row = rows + 4 * i * kRowStride;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float dq[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[j] = q[dq_index[k][j]] * dq_sign[k][j];
    const float du[3] = {dq[1], dq[2], dq[3]};
    float dn2r[3], dp2r[3], dcrs[3];
    rot_tangent(q, dq[0], du, pl.n2, uvn, dn2r);
    rot_tangent(q, dq[0], du, pl.p2, uvp, dp2r);
    cross(pl.n1, dn2r, dcrs);
    const float doff = -tsum3(dn2r[0] * p2r[0] + n2r[0] * dp2r[0],
                              dn2r[1] * p2r[1] + n2r[1] * dp2r[1],
                              dn2r[2] * p2r[2] + n2r[2] * dp2r[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) row[c * kRowStride + k] = dcrs[c] * pl.w;
    row[3 * kRowStride + k] = doff * pl.w;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int k = 0; k < 3; ++k) row[c * kRowStride + 3 + k] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) row[3 * kRowStride + 3 + k] = -n2r[k] * pl.w;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    row[c * kRowStride + 6] = r[c];
    sq[4 * i + c] = r[c] * r[c];
  }
}

// The 27 products of one residual row: J_a J_b (a <= b), then J_a r.
__device__ __forceinline__ void row_products(const float* rows, long long row,
                                             float p[kSums]) {
  const float* j = rows + row * kRowStride;
  int s = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) p[s++] = j[a] * j[b];
#pragma unroll
  for (int a = 0; a < 6; ++a) p[s++] = j[a] * j[6];
}

// An entry of the rows' products after one fold step with half h: rows
// i and i + h for i < h; for i >= h, row i alone (the caller passes the
// carried row 2h).
__device__ __forceinline__ void folded_once(const float* rows, long long i,
                                            long long h, float p[kSums]) {
  row_products(rows, i, p);
  if (i < h) {
    float o[kSums];
    row_products(rows, i + h, o);
#pragma unroll
    for (int s = 0; s < kSums; ++s) p[s] = p[s] + o[s];
  }
}

// fold_sum over the n residual rows of the 27 products, down to m <= 32
// entries: entry `lane` in x (0 from m on); returns m. With kLevels (any
// n) the first step's entries go to `levels` (27 floats an entry,
// ceil(n / 2) entries), which is folded in place, a step at a time, down
// to 32 entries; without (n <= 128) the first two steps are taken in
// registers.
template <bool kLevels>
__device__ int fold_entries(const float* rows, long long n, int lane,
                            float x[kSums], float* levels) {
#pragma unroll
  for (int s = 0; s < kSums; ++s) x[s] = 0.0f;
  if constexpr (kLevels) {
    long long h = n >> 1;
    long long m = h + (n & 1);
    for (long long e = lane; e < m; e += 32) {
      float p[kSums];
      folded_once(rows, e < h ? e : 2 * h, h, p);
#pragma unroll
      for (int s = 0; s < kSums; ++s) levels[e * kSums + s] = p[s];
    }
    __syncwarp();
    while (m > 32) {
      h = m >> 1;
      for (long long e = lane; e < h; e += 32)
#pragma unroll
        for (int s = 0; s < kSums; ++s)
          levels[e * kSums + s] =
              levels[e * kSums + s] + levels[(e + h) * kSums + s];
      __syncwarp();
      if (m & 1) {  // the carried entry moves to slot h
        if (lane < kSums) levels[h * kSums + lane] = levels[2 * h * kSums + lane];
        __syncwarp();
      }
      m = h + (m & 1);
    }
    if (lane < m)
#pragma unroll
      for (int s = 0; s < kSums; ++s) x[s] = levels[lane * kSums + s];
    __syncwarp();  // levels is rewritten by the next iteration
    n = m;
  } else if (n <= 32) {
    if (lane < n) row_products(rows, lane, x);
  } else if (n <= 64) {
    const int h = (int)(n >> 1);
    if (lane < h) folded_once(rows, lane, h, x);
    else if ((n & 1) && lane == h) row_products(rows, 2 * h, x);
    n = h + (n & 1);
  } else {
    const int h = (int)(n >> 1);
    const int n1 = h + (int)(n & 1), h1 = n1 >> 1;
    // entry e of the first step: rows e and e + h, or the carried row 2h
    if (lane < h1) {
      float o[kSums];
      folded_once(rows, lane, h, x);
      const int e = lane + h1;
      folded_once(rows, e < h ? e : 2 * h, h, o);
#pragma unroll
      for (int s = 0; s < kSums; ++s) x[s] = x[s] + o[s];
    } else if ((n1 & 1) && lane == h1) {
      const int e = 2 * h1;
      folded_once(rows, e < h ? e : 2 * h, h, x);
    }
    n = h1 + (n1 & 1);
  }
  return (int)n;
}

// fold_sum's last steps over m <= 32 entries, one a lane, by shuffles:
// the sums end in lane 0.
__device__ void fold_lanes(float x[kSums], int m, int lane) {
  while (m > 1) {
    const int h = m >> 1;
    const bool carry = (m & 1) && lane == h;
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      const float o = __shfl_down_sync(kFull, x[s], h);
      x[s] = lane < h ? x[s] + o : (carry ? o : x[s]);
    }
    m = h + (m & 1);
  }
}

// J^T J and J^T r over n = 32, 64 or 128 rows, sum s by thread s, into
// out[s]: each of the 32 entries fold_entries leaves (row e, or rows e
// and e + 32, or (e, e + 64) and (e + 32, e + 96) added as it adds them)
// from the products of sum s's two columns, then fold_sum's last five
// steps in registers.
__device__ __forceinline__ void fold_by_sum(const float* rows, int n,
                                            int lane, float* out) {
  if (lane >= kSums) return;
  // J_a r, or J_a J_b (a <= b) in row_products' order
  int a = lane - 21, b = 6;
  if (lane < 21) {
    int k = lane;
    for (a = 0; k >= 6 - a; ++a) k -= 6 - a;
    b = a + k;
  }
  auto p = [&](int r) {
    return rows[r * kRowStride + a] * rows[r * kRowStride + b];
  };
  float v[32];
#pragma unroll
  for (int e = 0; e < 32; ++e)
    v[e] = n == 32   ? p(e)
           : n == 64 ? p(e) + p(e + 32)
                     : (p(e) + p(e + 64)) + (p(e + 32) + p(e + 96));
#pragma unroll
  for (int h = 16; h > 0; h >>= 1)
#pragma unroll
    for (int e = 0; e < h; ++e) v[e] = v[e] + v[e + h];
  out[lane] = v[0];
}

// The step delta = -solve_spd6(damped, g) (linalg6.solve_spd6's unrolled
// Cholesky, in its order), with damped = (JtJ + lam diag(JtJ)) + 1e-12 I.
__device__ void lm_step(const float x[kSums], float lam, float delta[6]) {
  const float eps = f32(1e-20), tiny = f32(1e-12);
  float A[6][6];
  int s = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) {
      const float jtj = x[s++];
      const float d = a == b ? (jtj + lam * jtj) + tiny * 1.0f
                             : (jtj + lam * 0.0f) + tiny * 0.0f;
      A[a][b] = d;
      A[b][a] = d;
    }
  const float* g = x + 21;
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float v = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) v = v - L[j][k] * L[j][k];
    const float Ljj = sqrtf(clamp_min(v, eps));
    L[j][j] = Ljj;
    const float inv = (1.0f / Ljj) * 1.0f;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float u = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) u = u - L[i][k] * L[j][k];
      L[i][j] = u * inv;
    }
  }
  float y[6], sol[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v = v - L[i][k] * y[k];
    y[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v = v - L[k][i] * sol[k];
    sol[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = -sol[i];
}

// q_new = normalize(quat_multiply(_exp_quat(v), q)).
__device__ void rotate_pose(const float v[3], const float q[4],
                            float out[4]) {
  const float t2 = tsum3(v[0] * v[0], v[1] * v[1], v[2] * v[2]);
  const bool small = t2 < f32(1e-12);
  const float theta = sqrtf(small ? 1.0f : t2);
  const float k = small ? 0.5f - t2 * (1.0f / 48.0f)
                        : sinf(0.5f * theta) / theta;
  const float w = small ? 1.0f - t2 * (1.0f / 8.0f) : cosf(0.5f * theta);
  const float a[4] = {w, k * v[0], k * v[1], k * v[2]};
  float m[4];
  m[0] = ((a[0] * q[0] - a[1] * q[1]) - a[2] * q[2]) - a[3] * q[3];
  m[1] = ((a[0] * q[1] + a[1] * q[0]) + a[2] * q[3]) - a[3] * q[2];
  m[2] = ((a[0] * q[2] - a[1] * q[3]) + a[2] * q[0]) + a[3] * q[1];
  m[3] = ((a[0] * q[3] + a[1] * q[2]) - a[2] * q[1]) + a[3] * q[0];
  const float norm = sqrtf(tsum4(m[0] * m[0], m[1] * m[1], m[2] * m[2],
                                 m[3] * m[3]));
  const float den = clamp_min(norm, f32(1e-12));
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = m[c] / den;
}

// Plane i of lane b, and n1 . p1, from global memory.
__device__ __forceinline__ Plane load_plane(
    const float* __restrict__ n1, const float* __restrict__ p1,
    const float* __restrict__ n2, const float* __restrict__ p2,
    const float* __restrict__ w, long long b, int F, long long i) {
  Plane pl;
  const long long o = (b * F + i) * 3;
  float a[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pl.n1[c] = n1[o + c];
    a[c] = p1[o + c];
    pl.n2[c] = n2[o + c];
    pl.p2[c] = p2[o + c];
  }
  pl.n1p1 = tsum3(pl.n1[0] * a[0], pl.n1[1] * a[1], pl.n1[2] * a[2]);
  pl.w = w[b * F + i];
  return pl;
}

// The floats of scratch a lane of F planes needs on the scratch
// instantiation: rows, squared residuals, fold levels.
__host__ __device__ __forceinline__ long long scratch_floats(long long F) {
  const long long n = 4 * F;
  return kRowStride * n + n + kSums * ((n + 1) / 2);
}

// kInRegs: the registers instantiation (F <= kRegPlanes, scratch unused);
// otherwise the scratch one.
template <bool kInRegs>
__global__ void __launch_bounds__(32)
lm_refine_kernel(const float* __restrict__ n1, const float* __restrict__ p1,
                 const float* __restrict__ n2, const float* __restrict__ p2,
                 const float* __restrict__ w, float* __restrict__ q_out,
                 float* __restrict__ t_out, int* __restrict__ steps_out,
                 int* __restrict__ accepted_out, float* __restrict__ scratch,
                 int F, int iters) {
  __shared__ float rows_s[kInRegs ? kRegRows * kRowStride : 1];
  __shared__ float sq_s[kInRegs ? kRegRows : 1];
  __shared__ float pose_s[kCands][8];  // q, t of each candidate step
  __shared__ float sums_s[kSums];      // J^T J, J^T r at the pose
  const long long b = blockIdx.x;
  const int lane = threadIdx.x;
  const long long n = 4LL * F;
  float* rows = rows_s;
  float* sq = sq_s;
  float* levels = nullptr;
  if constexpr (!kInRegs) {
    rows = scratch + b * scratch_floats(F);
    sq = rows + kRowStride * n;
    levels = sq + n;
  }
  // A trial round's candidates: G groups of F threads, thread (cg, i)
  // with candidate cg's plane i (registers), or one over the warp.
  const int G = kInRegs ? kCands / F : 1;
  const int cg = kInRegs ? lane / F : 0;
  const bool pow2 = kInRegs && (F & (F - 1)) == 0;  // G F = 32
  Plane mine = {};
  if (kInRegs && cg < G) mine = load_plane(n1, p1, n2, p2, w, b, F, lane - cg * F);

  // The rows (and squared residuals) of every plane at (pq, pt).
  auto rows_at = [&](const float* pq, const float* pt) {
    for (long long i = lane; i < F; i += 32) {
      const Plane pl = kInRegs ? mine : load_plane(n1, p1, n2, p2, w, b, F, i);
      plane_rows(pl, pq, pt, i, rows, sq);
    }
    __syncwarp();
  };
  // J^T J and J^T r of the rows, into sums_s: a sum a thread where F =
  // 8, 16 or 32, else a row a thread and shuffles.
  auto fold_jtj = [&]() {
    if (kInRegs && (n == 32 || n == 64 || n == 128)) {
      fold_by_sum(rows, (int)n, lane, sums_s);
    } else {
      float x[kSums];
      const int m = fold_entries<!kInRegs>(rows, n, lane, x, levels);
      fold_lanes(x, m, lane);
      if (lane == 0)
#pragma unroll
        for (int s = 0; s < kSums; ++s) sums_s[s] = x[s];
    }
    __syncwarp();
  };

  float q[4] = {1.0f, 0.0f, 0.0f, 0.0f};
  float t[3] = {0.0f, 0.0f, 0.0f};
  float lam = f32(1e-4);
  int steps = 0, accepted = 0;
  float c_old = 0.0f;
  bool more = iters > 0;
  if (more) {
    rows_at(q, t);
    fold_arrays(sq, n, 1, lane);
    c_old = sq[0];
    more = c_old > 0.0f;  // else q and t are final
    if (more) fold_jtj();
  }
  while (more) {
    {  // the solve round: thread j's step after j rejections
      float x[kSums], delta[6], pose[7];
#pragma unroll
      for (int s = 0; s < kSums; ++s) x[s] = sums_s[s];
      lm_step(x, lam_at(lam, lane), delta);
      rotate_pose(delta, q, pose);
#pragma unroll
      for (int c = 0; c < 3; ++c) pose[4 + c] = t[c] + delta[3 + c];
#pragma unroll
      for (int c = 0; c < 7; ++c) pose_s[lane][c] = pose[c];
    }
    __syncwarp();
    const int ncand = min(kCands, iters - steps);
    int acc = -1;  // the accepted candidate
    bool final_pose = false;
    float c_new = 0.0f;
    for (int base = 0; base < ncand && acc < 0 && !final_pose; base += G) {
      // the trial costs of candidates base .. base + G - 1
      if constexpr (kInRegs) {
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (cg < G && base + cg < ncand) {
          const float* pose = pose_s[base + cg];
          float r[4], uvn[3], uvp[3], n2r[3], p2r[3];
          residuals(mine, pose, pose + 4, r, uvn, uvp, n2r, p2r);
#pragma unroll
          for (int c = 0; c < 4; ++c) s[c] = r[c] * r[c];
        }
        if (pow2) {
          // fold_sum over 4F rows, row 4i + c from plane i: its first
          // log2(F) steps add plane i + F / 2^k to plane i, c by c
          for (int off = F >> 1; off > 0; off >>= 1)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              s[c] = s[c] + __shfl_down_sync(kFull, s[c], off, F);
          if (lane == cg * F) sq[cg * n] = (s[0] + s[2]) + (s[1] + s[3]);
        } else if (cg < G) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sq[cg * n + 4 * (lane - cg * F) + c] = s[c];
        }
      } else {
        const float* pose = pose_s[base];
        for (long long i = lane; i < F; i += 32) {
          const Plane pl = load_plane(n1, p1, n2, p2, w, b, F, i);
          float r[4], uvn[3], uvp[3], n2r[3], p2r[3];
          residuals(pl, pose, pose + 4, r, uvn, uvp, n2r, p2r);
#pragma unroll
          for (int c = 0; c < 4; ++c) sq[4 * i + c] = r[c] * r[c];
        }
      }
      __syncwarp();
      if (!pow2) fold_arrays(sq, n, G, lane);
      for (int g = 0; g < G && base + g < ncand; ++g) {
        const float c = sq[g * n];
        if (c < c_old) {
          acc = base + g;
          c_new = c;
          break;
        }
        // rejected at lam = 1e8: every later step is this one
        if (lam_at(lam, base + g) == f32(1e8)) {
          final_pose = true;
          break;
        }
      }
      __syncwarp();  // every thread has read the costs
    }
    if (acc >= 0) {
      steps += acc + 1;
      ++accepted;
      const bool stop =
          c_old - c_new <= f32(1e-6) * clamp_min(c_old, f32(1e-30));
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] = pose_s[acc][c];
#pragma unroll
      for (int c = 0; c < 3; ++c) t[c] = pose_s[acc][4 + c];
      lam = clamp_min(lam_at(lam, acc) * (1.0f / 3.0f), f32(1e-10));
      c_old = c_new;
      more = !stop && steps < iters && c_old > 0.0f;
      __syncwarp();  // pose_s read before the next solve round writes it
      if (more) {
        rows_at(q, t);
        fold_jtj();
      }
    } else if (final_pose) {
      steps = iters;
      more = false;
    } else {
      steps += ncand;
      lam = lam_at(lam, ncand);
      more = steps < iters;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) q_out[b * 4 + c] = q[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) t_out[b * 3 + c] = t[c];
    steps_out[b] = steps;
    accepted_out[b] = accepted;
  }
}

}  // namespace

// The floats of scratch a lane of F planes needs on the scratch
// instantiation.
extern "C" long long fccf_lm_scratch_floats(int F) {
  return scratch_floats(F);
}

// The LM solve of Bt lanes of F (>= 1) plane pairs, `iters` iterations at
// most, on `stream`: the registers instantiation where in_regs (F <=
// kRegPlanes), else the scratch one, whose scratch holds Bt *
// fccf_lm_scratch_floats(F) floats. Returns cudaGetLastError() of the
// launch (0 = launched).
extern "C" int fccf_lm_refine(const void* n1, const void* p1, const void* n2,
                              const void* p2, const void* w, void* q_out,
                              void* t_out, void* steps_out,
                              void* accepted_out, void* scratch, int Bt,
                              int F, int iters, int in_regs, void* stream) {
  if (Bt <= 0 || F <= 0 || iters < 0 || (in_regs && F > kRegPlanes) ||
      (!in_regs && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = in_regs ? lm_refine_kernel<true> : lm_refine_kernel<false>;
  kernel<<<Bt, 32, 0, (cudaStream_t)stream>>>(
      (const float*)n1, (const float*)p1, (const float*)n2, (const float*)p2,
      (const float*)w, (float*)q_out, (float*)t_out, (int*)steps_out,
      (int*)accepted_out, (float*)scratch, F, iters);
  return (int)cudaGetLastError();
}
