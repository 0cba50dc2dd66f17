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
//   reduce kernel (ATen/native/cuda/Reduce.cuh) does for R rows of n
//   entries: setReduceConfig's block of bw x bh threads (from the largest
//   powers of two <= n, or <= n / 4 where n >= 128 is read as float4
//   vectors, and <= R), thread x keeping its entries (x, x + bw, ..., or
//   its vectors) in four accumulators that start at 0 and are then added
//   in order, a tree over the block's width at offsets bw / 2, ..., 1 and,
//   where a row is split over the block's height (n >= 8192), a tree over
//   it (SumConfig, torch_sum_rows, tsum3, tsum4;
//   tools/torch_sum_order.py probes it on the card);
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
// in registers, the same in every thread. Thread l takes planes l, l + 32,
// l + 64, ... and computes their 4 residual rows and their Jacobian; the
// costs and the 27 sums of J^T J (21 distinct entries) and J^T r are warp
// shuffles; thread 0 runs the 6x6 Cholesky solve, the exponential map and
// the normalization, and the new pose goes to every thread by shuffle.
// The kernel has two instantiations, picked from F at launch:
// - registers (F <= 32; every shipped preset has 16): a thread holds its
//   plane in registers, the rows sit in shared memory, the costs' blocks
//   are at most 64 threads wide (torch_sum_small) and J^T J folds in
//   registers and shuffles;
// - scratch (any F): the planes are read from global memory at each use,
//   and the rows, the squared residuals and the fold's levels go through
//   a scratch buffer in global memory (L1 and L2 serve it: no other block
//   reads it); J^T J folds level by level in that buffer down to 32
//   entries, then by shuffles.
// The order of additions is the same in both, so the scratch one is also
// bit-equal at F <= 32; the registers one is kept for its speed there
// (PERF.md section 6 times both at F = 16). A lane stops once it is done
// (its tolerance met) or its cost is not > 0 (zero or NaN: no step can be
// accepted, so q and t are final); lm_loop runs such a lane on with only
// lam changing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The most planes a lane: 4F = 16384 residual rows, the longest row
// whose order of additions tools/torch_sum_order.py has probed on the
// card. Above 4F = 130560 torch's reduce splits a row over several blocks
// with a reduction in global memory (setReduceConfig's ctas_per_output),
// an order this kernel does not model; 16388-130560 is not probed.
constexpr int kMaxPlanes = 4096;
constexpr int kRegPlanes = 32;             // a plane a thread, in registers
constexpr int kRegRows = 4 * kRegPlanes;   // residual rows in shared memory
constexpr int kRowStride = 8;              // J (6), r, pad
constexpr int kSums = 27;                  // J^T J (a <= b: 21), J^T r (6)
constexpr int kReduceThreads = 512;        // Reduce.cuh's MAX_NUM_THREADS
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

__device__ __forceinline__ int last_pow2(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// The block torch's reduce kernel takes to sum R rows of n (> 0)
// contiguous float32 entries (setReduceConfig, Reduce.cuh): bw threads
// across a row; ny > 1 where a row is split over the block's height; vec
// where the row is read as float4 vectors (n >= 128; the port's rows are
// 4F entries, so their starts are 16-byte aligned and there is no tail).
struct SumConfig {
  int n, bw, ny;
  bool vec;
};

__device__ SumConfig sum_config(int n, int R) {
  const bool vec = n >= 128;
  const int dim0 = vec ? n / 4 : n;
  const int d = dim0 < kReduceThreads ? last_pow2(dim0) : kReduceThreads;
  const int r = R < kReduceThreads ? last_pow2(R) : kReduceThreads;
  int bw = min(d, 32);
  const int bh = min(r, kReduceThreads / bw);
  bw = min(d, kReduceThreads / bh);
  const int per_thread = (n + bw - 1) / bw;
  const bool split = per_thread >= min(bh * 16, 256);
  return {n, bw, split ? bh : 1, vec};
}

// One thread (x, y) of that block: its accumulators over its entries,
// then added in order.
__device__ float reduce_thread(const float* e, const SumConfig& c, int x,
                               int y) {
  const int step = c.bw * c.ny;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (c.vec) {
    for (int v = x + y * c.bw; 4 * v + 3 < c.n; v += step)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a[i] + e[4 * v + i];
  } else {
    int idx = x + y * c.bw;
    for (; idx + 3 * step < c.n; idx += 4 * step)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a[i] + e[idx + i * step];
    for (int i = 0; i < 4 && idx < c.n; ++i, idx += step)
      a[i] = a[i] + e[idx];
  }
  return ((a[0] + a[1]) + a[2]) + a[3];
}

// torch.sum of x[0..c.n) on the card, in every thread of the warp. vbuf
// holds kReduceThreads floats where the block is wider than a warp.
__device__ float torch_sum_rows(const float* x, const SumConfig& c, int lane,
                                float* vbuf) {
  if (c.ny == 1 && c.bw <= 32) {
    float v = lane < c.bw ? reduce_thread(x, c, lane, 0) : 0.0f;
    for (int off = c.bw >> 1; off > 0; off >>= 1)
      v = v + __shfl_down_sync(kFull, v, off);
    return __shfl_sync(kFull, v, 0);
  }
  const int nt = c.bw * c.ny;
  for (int u = lane; u < nt; u += 32)
    vbuf[u] = reduce_thread(x, c, u % c.bw, u / c.bw);
  __syncwarp();
  // block_x_reduce: a tree over each row of the block, then
  // block_y_reduce: a tree over its rows' sums.
  for (int off = c.bw >> 1; off > 0; off >>= 1) {
    for (int u = lane; u < c.ny * off; u += 32) {
      const int y = u / off, xx = u % off;
      vbuf[y * c.bw + xx] = vbuf[y * c.bw + xx] + vbuf[y * c.bw + xx + off];
    }
    __syncwarp();
  }
  for (int off = c.ny >> 1; off > 0; off >>= 1) {
    for (int y = lane; y < off; y += 32)
      vbuf[y * c.bw] = vbuf[y * c.bw] + vbuf[(y + off) * c.bw];
    __syncwarp();
  }
  const float v = vbuf[0];
  __syncwarp();  // vbuf is reused by the next sum
  return v;
}

// torch_sum_rows for a row of n <= 128 entries (the registers
// instantiation's): there the block is one row of bw <= 64 threads
// (ny = 1) and a thread holds at most 4 entries, one an accumulator
// (x + i bw, or the float4 4x .. 4x + 3), so no shared memory is needed.
__device__ __forceinline__ float torch_sum_small(const float* x,
                                                 const SumConfig& c,
                                                 int lane) {
  auto part = [&](int u) {  // thread u's accumulators, added in order
    const int base = c.vec ? 4 * u : u, step = c.vec ? 1 : c.bw;
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = base + i * step;
      a[i] = u < c.bw && k < c.n ? 0.0f + x[k] : 0.0f;
    }
    return ((a[0] + a[1]) + a[2]) + a[3];
  };
  float v = part(lane);
  if (c.bw > 32) v = v + part(lane + 32);  // the tree's step at offset 32
  for (int off = min(c.bw, 32) >> 1; off > 0; off >>= 1)
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

// fold_sum over the n residual rows of the 27 products; the sums end in
// thread 0. With kLevels (any n) the first step's entries go to `levels`
// (27 floats an entry, ceil(n / 2) entries), which is folded in place,
// a step at a time, down to 32 entries; without (n <= 128) the first two
// steps are taken in registers.
template <bool kLevels>
__device__ void fold_rows(const float* rows, int n, int lane,
                          float x[kSums], float* levels) {
#pragma unroll
  for (int s = 0; s < kSums; ++s) x[s] = 0.0f;
  if constexpr (kLevels) {
    int h = n >> 1;
    int m = h + (n & 1);
    for (int e = lane; e < m; e += 32) {
      float p[kSums];
      folded_once(rows, e < h ? e : 2 * h, h, p);
#pragma unroll
      for (int s = 0; s < kSums; ++s) levels[e * kSums + s] = p[s];
    }
    __syncwarp();
    while (m > 32) {
      h = m >> 1;
      for (int e = lane; e < h; e += 32)
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

// Plane i of lane b, and n1 . p1, from global memory.
__device__ __forceinline__ Plane load_plane(
    const float* __restrict__ n1, const float* __restrict__ p1,
    const float* __restrict__ n2, const float* __restrict__ p2,
    const float* __restrict__ w, long long b, int F, int i) {
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

// kInRegs: the registers instantiation (F <= kRegPlanes, scratch unused);
// otherwise the scratch one.
template <bool kInRegs>
__global__ void __launch_bounds__(32)
lm_refine_kernel(const float* __restrict__ n1, const float* __restrict__ p1,
                 const float* __restrict__ n2, const float* __restrict__ p2,
                 const float* __restrict__ w, float* __restrict__ q_out,
                 float* __restrict__ t_out, int* __restrict__ steps_out,
                 float* __restrict__ scratch, int F, int iters) {
  __shared__ float rows_s[kInRegs ? kRegRows * kRowStride : 1];
  __shared__ float sq_s[kInRegs ? kRegRows : 1];
  __shared__ float vbuf[kInRegs ? 1 : kReduceThreads];
  const long long b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = 4 * F;
  // The scratch of this lane: rows, squares, fold levels.
  float* rows = rows_s;
  float* sq = sq_s;
  float* levels = nullptr;
  if constexpr (!kInRegs) {
    rows = scratch + b * (long long)(kRowStride * n + n + kSums * ((n + 1) / 2));
    sq = rows + kRowStride * n;
    levels = sq + n;
  }
  const SumConfig cost = sum_config(n, gridDim.x);  // torch.sum(r * r, -1)

  Plane mine = {};
  if (kInRegs && lane < F) mine = load_plane(n1, p1, n2, p2, w, b, F, lane);

  float q[4] = {1.0f, 0.0f, 0.0f, 0.0f};
  float t[3] = {0.0f, 0.0f, 0.0f};
  float lam = f32(1e-4);
  int steps = 0;
  for (int it = 0; it < iters; ++it) {
    for (int i = lane; i < F; i += 32) {
      const Plane pl = kInRegs ? mine : load_plane(n1, p1, n2, p2, w, b, F, i);
      plane_rows(pl, q, t, i, rows, sq);
    }
    __syncwarp();
    const float c_old = (kInRegs ? torch_sum_small(sq, cost, lane)
                               : torch_sum_rows(sq, cost, lane, vbuf));
    if (!(c_old > 0.0f)) break;  // q and t are final
    float x[kSums];
    fold_rows<!kInRegs>(rows, n, lane, x, levels);
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
    for (int i = lane; i < F; i += 32) {
      const Plane pl = kInRegs ? mine : load_plane(n1, p1, n2, p2, w, b, F, i);
      float r[4], uvn[3], uvp[3], n2r[3], p2r[3];
      residuals(pl, pose, pose + 4, r, uvn, uvp, n2r, p2r);
#pragma unroll
      for (int c = 0; c < 4; ++c) sq[4 * i + c] = r[c] * r[c];
    }
    __syncwarp();
    const float c_new = (kInRegs ? torch_sum_small(sq, cost, lane)
                               : torch_sum_rows(sq, cost, lane, vbuf));
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

// The floats of scratch a lane of F planes needs on the scratch
// instantiation.
extern "C" long long fccf_lm_scratch_floats(int F) {
  const long long n = 4LL * F;
  return kRowStride * n + n + kSums * ((n + 1) / 2);
}

// The LM solve of Bt lanes of F (1..kMaxPlanes) plane pairs, `iters`
// iterations at most, on `stream`: the registers instantiation where
// in_regs (F <= kRegPlanes), else the scratch one, whose scratch holds
// Bt * fccf_lm_scratch_floats(F) floats. Returns cudaGetLastError() of
// the launch (0 = launched).
extern "C" int fccf_lm_refine(const void* n1, const void* p1, const void* n2,
                              const void* p2, const void* w, void* q_out,
                              void* t_out, void* steps_out, void* scratch,
                              int Bt, int F, int iters, int in_regs,
                              void* stream) {
  if (Bt <= 0 || F <= 0 || F > kMaxPlanes || iters < 0 ||
      (in_regs && F > kRegPlanes) || (!in_regs && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = in_regs ? lm_refine_kernel<true> : lm_refine_kernel<false>;
  kernel<<<Bt, 32, 0, (cudaStream_t)stream>>>(
      (const float*)n1, (const float*)p1, (const float*)n2, (const float*)p2,
      (const float*)w, (float*)q_out, (float*)t_out, (int*)steps_out,
      (float*)scratch, F, iters);
  return (int)cudaGetLastError();
}
