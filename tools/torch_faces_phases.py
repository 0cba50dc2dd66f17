#!/usr/bin/env python3
"""Where F2's time goes on a CUDA card. The segment-sum kernel of
``fccf_pcr_torch/csrc/faces.cu`` is built whole and cut short after each
of its phases (the labels, the sort's inverse and the zero fill; the
sources; m and a; the scan's steps), each timed in both forms (face
statistics and values) by CUDA events over a CUDA graph of 10 calls on
inputs of the heritage step's shape (16 clouds of 9216 voxels, random
component labels, 80% valid); then a diagnostic build stamps
``clock64()`` at each barrier of block (0, 0) and the cycles between the
stamps are printed (the first interval is the labels and the zero fill,
then the sources, the chunks' carries, m and a, and one a step).

    python3 tools/torch_faces_phases.py [--clouds 16] [--voxels 9216]

The variant sources and libraries are built with the package's nvcc
flags into a temporary directory. Prints one line per form and cut, the
card's name and power limit, and the whole as JSON last. Exits non-zero
without a card, or where a phase mark is missing from the source.
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fccf_pcr_torch.ops import cuda_build  # noqa: E402
from fccf_pcr_torch.ops import faces_kernels as fk  # noqa: E402

# The text each cut returns before, in the kernel's order.
CUTS = {"labels and zero fill":
        "#pragma unroll 4\n  for (int r = t; r < n; r += T) {",
        "sources": "  // m and a: a thread's chunk",
        "m and a": "  // The scan's steps on the rows",
        "steps": "    // Each label's last row: its sum"}
STAMP = ("if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) "
         "g_clk[g_n++] = clock64();")


def kernel_body(src):
    """(start, end) of the segment-sum kernel's text in ``src``."""
    a = src.index("faces_segment_sum_kernel(const long long*")
    return a, src.index("template <int FORM>\nint segment_sum(", a)


def variant(src, cut):
    """The source returning before ``cut`` (a key of CUTS), whole for
    None, or with clock stamps for "clock"."""
    a, b = kernel_body(src)
    body = src[a:b]
    if cut == "clock":
        body = body.replace("__syncthreads();", "__syncthreads(); " + STAMP)
        body = body.replace("  extern __shared__ float smem[];",
                            "  extern __shared__ float smem[];\n  " + STAMP,
                            1)
        text = src[:a] + body + src[b:]
        text = text.replace("namespace {", "__device__ long long g_clk[256];"
                            "\n__device__ int g_n;\nnamespace {", 1)
        return text + (
            '\nextern "C" int fccf_clock_read(void* host) { return (int)'
            "cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk)); }\n"
            'extern "C" int fccf_clock_reset() { int z = 0; return (int)'
            "cudaMemcpyToSymbol(g_n, &z, sizeof(int)); }\n")
    if cut is None:
        return src
    mark = CUTS[cut]
    if mark not in body:
        raise SystemExit(f"phase mark {mark!r} not in csrc/faces.cu")
    return src[:a] + body.replace(mark, "  return;\n" + mark, 1) + src[b:]


def build(text, name, tmp):
    cu = tmp / f"{name}.cu"
    cu.write_text(text)
    so = tmp / f"lib{name}.so"
    return subprocess.Popen([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                             str(so), str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def inputs(B, V, dev, seed=0):
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(B, V)) < 0.8
    labels = np.minimum(rng.integers(0, max(V // 30, 1), (B, V)),
                        np.arange(V))
    labels = np.where(valid, labels, 2**30).astype(np.int64)
    count = rng.integers(1, 40, (B, V)).astype(np.int32)
    centroid = rng.normal(size=(B, V, 3)).astype(np.float32)
    normal = rng.normal(size=(B, V, 3)).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (labels, valid, count, centroid,
                                               normal)]
    seg_s, order = fk.sorted_labels(t[0], t[1], V)
    return seg_s, order, t[2], t[3], t[4], t[1]


def calls(lib, B, V, dev, a):
    """The face-statistics and values calls of ``lib`` on inputs ``a``."""
    seg_s, order, count, centroid, normal, valid = a
    outs = [torch.empty((B, V, 3), device=dev),
            torch.empty((B, V, 3), device=dev), torch.empty((B, V), device=dev),
            torch.empty((B, V), dtype=torch.int32, device=dev)]
    values = centroid[..., 0].contiguous()
    sums = torch.empty((B, V), device=dev)
    floats = max(int(lib.fccf_faces_segment_scratch(B, V, 8, 1)),
                 int(lib.fccf_faces_segment_scratch(B, V, 1, 0)))
    scratch = torch.empty((max(floats, 1),), device=dev)

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def face_stats():
        rc = lib.fccf_faces_face_stats(
            seg_s.data_ptr(), order.data_ptr(), count.data_ptr(),
            valid.data_ptr(), centroid.data_ptr(), normal.data_ptr(),
            *(o.data_ptr() for o in outs), scratch.data_ptr(), B, V, V,
            stream())
        if rc:
            raise RuntimeError(f"face statistics launch: CUDA error {rc}")

    def values_sum():
        rc = lib.fccf_faces_segment_sum(
            seg_s.data_ptr(), order.data_ptr(), values.data_ptr(),
            sums.data_ptr(), scratch.data_ptr(), B, V, V, stream())
        if rc:
            raise RuntimeError(f"values launch: CUDA error {rc}")

    return {"face_stats": face_stats, "values": values_sum}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clouds", type=int, default=16)
    ap.add_argument("--voxels", type=int, default=9216)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    dev = torch.device("cuda:0")
    B, V = args.clouds, args.voxels
    src = (ROOT / "fccf_pcr_torch" / "csrc" / "faces.cu").read_text()
    out = {"shape": [B, V], "device": smi, "ms": {}, "cycles": {}}
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        names = [*CUTS, "whole", "clock"]
        procs = {n: build(variant(src, None if n == "whole" else n),
                          f"faces_{i}", tmp) for i, n in enumerate(names)}
        libs = {}
        for name, (proc, so) in procs.items():
            if proc.wait() != 0:
                raise SystemExit(f"nvcc failed for {name}:\n"
                                 f"{proc.stdout.read()[-3000:]}")
            libs[name] = ctypes.CDLL(str(so))
            fk._bind(libs[name])
        a = inputs(B, V, dev)
        for name in [*CUTS, "whole"]:
            for form, fn in calls(libs[name], B, V, dev, a).items():
                ms = cs.graph_ms(fn)
                out["ms"].setdefault(form, {})[name] = ms
                print(f"[phases] {form} ({B}, {V}) cut after {name}: "
                      f"{ms * 1e3:.2f} us | {smi}", flush=True)
        lib = libs["clock"]
        lib.fccf_clock_read.argtypes = [ctypes.c_void_p]
        for form, fn in calls(lib, B, V, dev, a).items():
            for _ in range(3):
                lib.fccf_clock_reset()
                fn()
                torch.cuda.synchronize()
            host = (ctypes.c_longlong * 256)()
            lib.fccf_clock_read(host)
            stamps = [c for c in host if c]
            cycles = [b - a for a, b in zip(stamps, stamps[1:])]
            out["cycles"][form] = cycles
            print(f"[phases] {form} ({B}, {V}) block (0, 0): "
                  f"{stamps[-1] - stamps[0]} cycles; between barriers "
                  f"{cycles} | {smi}", flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
