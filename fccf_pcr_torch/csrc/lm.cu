// The LM solve of refine_pairs (L1), for Hopper (sm_90a).
//
// It replaces no Pallas kernel: it is the device loop that the JAX
// package's compiled program runs for the LM refine, the lax.while_loop
// at fccf_pcr_tpu/refine/gauss_newton.py:100 (vmapped over the candidate
// lanes), which the port's plain version, refine/gauss_newton.py::lm_loop,
// runs as ~420 small PyTorch kernels an iteration.
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
// - a sum over the last axis (torch.sum: n1.p1, the offsets, the step's
//   squared norm, the quaternion norm and the costs) adds as torch's CUDA
//   reduce kernel does for a row of n <= 128 entries: block_width =
//   min(the largest power of two <= n, 32) threads, thread x keeping
//   entries x, x + bw, x + 2 bw, x + 3 bw (at n = 128, its float4 vector
//   4x .. 4x + 3) in four accumulators that start at 0 and are then added
//   in order, then a shuffle tree at offsets bw / 2, ..., 2, 1
//   (torch_sum_rows, tsum3, tsum4; tools/torch_sum_order.py probes it);
// - J^T J and J^T r over the 4F residual rows add as ops/batch.py's
//   fold_sum: the first half plus the second, repeated, an odd last entry
//   carried (fold_rows);
// - a division by a Python scalar (lam / 3.0, t2 / 48.0) is torch's
//   multiply by the float32 reciprocal; the scalars are float32 values
//   of the Python doubles (e.g. (float)1e-12).
//
// Layout: n1, p1, n2, p2 (Bt, F, 3) float32, w (Bt, F) float32, all
// contiguous; q_out (Bt, 4), t_out (Bt, 3) float32; steps_out (Bt,)
// int32, the LM steps (solves) each lane ran.
//
// Design: a warp a lane (a block of 32 threads), its state (q, t, lam)
// in registers, the same in every thread. Thread i holds plane i (F <= 32)
// and computes its 4 residual rows and their Jacobian into shared memory;
// the costs and the 27 sums of J^T J (21 distinct entries) and J^T r are
// warp shuffles; thread 0 runs the 6x6 Cholesky solve, the exponential
// map and the normalization, and the new pose goes to every thread by
// shuffle. A lane stops once it is done (its tolerance met) or its cost
// is not > 0 (zero or NaN: no step can be accepted, so q and t are
// final); lm_loop runs such a lane on with only lam changing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 32;             // F: a plane a thread
constexpr int kMaxRows = 4 * kMaxPlanes;   // residual rows
constexpr int kRowStride = 8;              // J (6), r, pad
constexpr int kSums = 27;                  // J^T J (a <= b: 21), J^T r (6)
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

// torch.sum of x[0..n) (0 < n <= 128) on the card, in every thread.
__device__ float torch_sum_rows(const float* x, int n, int lane) {
  int bw = 1;
  while (2 * bw <= n && 2 * bw <= 32) bw *= 2;
  float v = 0.0f;
  if (n == 128) {  // read as float4 vectors: thread x holds 4x .. 4x + 3
    const float* e = x + 4 * lane;
    v = (((0.0f + e[0]) + (0.0f + e[1])) + (0.0f + e[2])) + (0.0f + e[3]);
  } else if (lane < bw) {
    float acc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane + k * bw;
      acc[k] = i < n ? 0.0f + x[i] : 0.0f;
    }
    v = ((acc[0] + acc[1]) + acc[2]) + acc[3];
  }
  for (int off = bw >> 1; off > 0; off >>= 1)
    v = v + __shfl_down_sync(kFull, v, off);
  return __shfl_sync(kFull, v, 0);
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
                                           const float t[3], int i,
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
__device__ __forceinline__ void row_products(const float* rows, int row,
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
__device__ __forceinline__ void folded_once(const float* rows, int i, int h,
                                            float p[kSums]) {
  row_products(rows, i, p);
  if (i < h) {
    float o[kSums];
    row_products(rows, i + h, o);
#pragma unroll
    for (int s = 0; s < kSums; ++s) p[s] = p[s] + o[s];
  }
}

// fold_sum over the n (<= 128) residual rows of the 27 products; the sums
// end in thread 0.
__device__ void fold_rows(const float* rows, int n, int lane,
                          float x[kSums]) {
#pragma unroll
  for (int s = 0; s < kSums; ++s) x[s] = 0.0f;
  if (n <= 32) {
    if (lane < n) row_products(rows, lane, x);
  } else if (n <= 64) {
    const int h = n >> 1;
    if (lane < h) folded_once(rows, lane, h, x);
    else if ((n & 1) && lane == h) row_products(rows, 2 * h, x);
    n = h + (n & 1);
  } else {
    const int h = n >> 1;
    const int n1 = h + (n & 1), h1 = n1 >> 1;
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
  while (n > 1) {
    const int h = n >> 1;
    const bool carry = (n & 1) && lane == h;
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      const float o = __shfl_down_sync(kFull, x[s], h);
      x[s] = lane < h ? x[s] + o : (carry ? o : x[s]);
    }
    n = h + (n & 1);
  }
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

__global__ void __launch_bounds__(32)
lm_refine_kernel(const float* __restrict__ n1, const float* __restrict__ p1,
                 const float* __restrict__ n2, const float* __restrict__ p2,
                 const float* __restrict__ w, float* __restrict__ q_out,
                 float* __restrict__ t_out, int* __restrict__ steps_out,
                 int F, int iters) {
  __shared__ float rows[kMaxRows * kRowStride];
  __shared__ float sq[kMaxRows];
  const long long b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = 4 * F;

  Plane pl = {};
  if (lane < F) {
    const long long o = (b * F + lane) * 3;
    float a[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pl.n1[c] = n1[o + c];
      a[c] = p1[o + c];
      pl.n2[c] = n2[o + c];
      pl.p2[c] = p2[o + c];
    }
    pl.n1p1 = tsum3(pl.n1[0] * a[0], pl.n1[1] * a[1], pl.n1[2] * a[2]);
    pl.w = w[b * F + lane];
  }

  float q[4] = {1.0f, 0.0f, 0.0f, 0.0f};
  float t[3] = {0.0f, 0.0f, 0.0f};
  float lam = f32(1e-4);
  int steps = 0;
  for (int it = 0; it < iters; ++it) {
    if (lane < F) plane_rows(pl, q, t, lane, rows, sq);
    __syncwarp();
    const float c_old = torch_sum_rows(sq, n, lane);
    if (!(c_old > 0.0f)) break;  // q and t are final
    float x[kSums];
    fold_rows(rows, n, lane, x);
    float pose[7];  // q_new, t_new, from thread 0
    if (lane == 0) {
      float delta[6];
      lm_step(x, lam, delta);
      rotate_pose(delta, q, pose);
#pragma unroll
      for (int c = 0; c < 3; ++c) pose[4 + c] = t[c] + delta[3 + c];
    }
#pragma unroll
    for (int c = 0; c < 7; ++c) pose[c] = __shfl_sync(kFull, pose[c], 0);
    __syncwarp();  // every thread has read this iteration's rows
    if (lane < F) {
      float r[4], uvn[3], uvp[3], n2r[3], p2r[3];
      residuals(pl, pose, pose + 4, r, uvn, uvp, n2r, p2r);
#pragma unroll
      for (int c = 0; c < 4; ++c) sq[4 * lane + c] = r[c] * r[c];
    }
    __syncwarp();
    const float c_new = torch_sum_rows(sq, n, lane);
    ++steps;
    const bool accept = c_new < c_old;
    const bool stop =
        accept && (c_old - c_new <= f32(1e-6) * clamp_min(c_old, f32(1e-30)));
    if (accept) {
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] = pose[c];
#pragma unroll
      for (int c = 0; c < 3; ++c) t[c] = pose[4 + c];
      lam = clamp_min(lam * (1.0f / 3.0f), f32(1e-10));
    } else {
      lam = clamp_max(lam * 2.0f, f32(1e8));
    }
    if (stop) break;  // done: lm_loop freezes the lane
    __syncwarp();     // before the next iteration's rows
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) q_out[b * 4 + c] = q[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) t_out[b * 3 + c] = t[c];
    steps_out[b] = steps;
  }
}

}  // namespace

// The LM solve of Bt lanes of F (1..32) plane pairs, `iters` iterations at
// most, on `stream`. Returns cudaGetLastError() of the launch (0 =
// launched).
extern "C" int fccf_lm_refine(const void* n1, const void* p1, const void* n2,
                              const void* p2, const void* w, void* q_out,
                              void* t_out, void* steps_out, int Bt, int F,
                              int iters, void* stream) {
  if (Bt <= 0 || F <= 0 || F > kMaxPlanes || iters < 0)
    return (int)cudaErrorInvalidValue;
  lm_refine_kernel<<<Bt, 32, 0, (cudaStream_t)stream>>>(
      (const float*)n1, (const float*)p1, (const float*)n2, (const float*)p2,
      (const float*)w, (float*)q_out, (float*)t_out, (int*)steps_out, F,
      iters);
  return (int)cudaGetLastError();
}
