// Per-row gather for Hopper (sm_90a):
//
//   out[p, i] = tbl[p, clamp(idx[p, i], 0, V - 1)]     int32 (P, V)
//
// Replaces tools/probe_gather.py::kernel, the per-lane gather
// out[i] = tbl[idx[i]] on int32 (1, 1024) that probed whether
// label-prop's pointer jump label[label] could run inside the TPU sweep
// kernel. Here it is that pointer jump as a launch of its own: the
// path-halving step between the sweeps of the per-sweep host loop
// (ops/label_prop.py::pointer_jump), one row per pair. The main path
// halves inside csrc/label_prop.cu's propagation kernel instead, where
// the gather is an ordinary load. The clamp keeps every read inside its
// row (invalid slots hold 2^30).
//
// Design. One thread per output element over the flattened (P, V) array:
// reads of idx and writes of out are coalesced; the table reads are
// random within a row of V * 4 bytes (36 KB at V = 9216, so L1/L2
// resident) and go through the read-only path (__ldg). At the main
// path's sizes (P <= 8, V <= 9216) a launch moves under 1 MB and is
// bound by launch latency, not bytes, which is why the main path's
// halving moved into the propagation kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int* __restrict__ tbl, const int* __restrict__ idx,
                   int* __restrict__ out, int V, long long n) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const long long row = t / V;
  int j = idx[t];
  j = j < 0 ? 0 : (j >= V ? V - 1 : j);
  out[t] = __ldg(tbl + row * V + j);
}

}  // namespace

// out = gather of P rows of V int32 on `stream`. Returns
// cudaGetLastError() of the launch (0 = launched).
extern "C" int fccf_gather_rows(const void* tbl, const void* idx, void* out,
                                int P, int V, void* stream) {
  if (P <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)P * V;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  gather_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)tbl, (const int*)idx, (int*)out, V, n);
  return (int)cudaGetLastError();
}
