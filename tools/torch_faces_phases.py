#!/usr/bin/env python3
"""Where F2's time goes on a CUDA card. The segment-sum kernel of
``fccf_pcr_torch/csrc/faces.cu`` is built whole and cut short after each
of its phases (the keys and their buckets' counts, scanned; the block's
rows compacted; their stable order; the zero fill of the slots no label
runs to; the long labels' table; the windows' and the chunks' trees,
with the sources gathered; the whole, with the long labels' chunk
totals), each timed in both forms (face statistics and
values) by CUDA events over a CUDA graph of 10 calls on inputs of the
heritage step's shape (16 clouds of 9216 voxels, random component
labels, 80% valid; with ``--step heritage`` or ``office`` the first face
statistics call and the roughness call of that batch-8 eager step
instead); then a diagnostic build stamps ``clock64()``
in block (0, 0) at each barrier, after each radix pass and, after a
barrier of its own, at the start of each numbered phase, and the cycles
between the stamps are printed with the phase each ends in.

    python3 tools/torch_faces_phases.py [--clouds 16] [--voxels 9216]
        [--step heritage] [--f1]

With ``--f1`` it times F1 instead, on random covariances of the same
shape, in turns: whole; with its float64 steps (eigen3's _fma and
_sqrt) done in float32; with its float32 divisions made products and
``cosf`` / ``atan2f`` a move and an add; and with both (other bits: for
timing only). What each class of instructions costs, and what is left
without them.

The variant sources and libraries are built with the package's nvcc
flags into a temporary directory. Prints one line per form and cut, the
card's name and power limit, and the whole as JSON last. Exits non-zero
without a card, or where a phase mark is missing from the source.
"""

import argparse
import ctypes
import re
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
CUTS = {"counts": "  // 3. This block's buckets",
        "rows": "  // 5. Their stable order",
        "order": "  if constexpr (FORM == kOrder) {",
        "zero fill": "  // 7. Window j is sorted rows",
        "long labels' table": "  // 8. Work items",
        "windows and chunks": "  // 9. A long label of more than"}
STAMP = ("if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) "
         "g_clk[g_n++] = clock64();")
PASS = "radix_pass(key, rows, spare, hist, s_red, m, shift);"
PHASE = re.compile(r"\n  // (\d)\. ")
F1_SECTION = ("// ------------------------------------------------------------"
              "------ F1 --", "// ----------------------------------------"
              "-------------------------- F2 --")


CHEAP = """
__device__ __forceinline__ float cheap_div(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float cheap_cos(float x) { return x; }
__device__ __forceinline__ float cheap_atan2(float y, float x) {
  return __fadd_rn(y, x);
}
"""


def f1_variant(src, float32, cheap):
    """The source with F1's float64 steps done in float32 (``float32``)
    and its divisions, cosf and atan2f replaced by a product, the argument
    and a sum (``cheap``): for timing only."""
    a, b = (src.index(m) for m in F1_SECTION)
    sec = src[a:b]
    if float32:
        sec = sec.replace(
            "__double2float_rn(__dadd_rn(__dmul_rn(a, b), c))",
            "__fadd_rn(__fmul_rn(a, b), c)").replace(
            "__double2float_rn(__dsqrt_rn((double)x))", "__fsqrt_rn(x)")
        if "__double2float_rn" in sec:
            raise SystemExit("F1's float64 steps are not where the tool "
                             "expects")
        sec = sec.replace("double", "float")
    if cheap:
        if not all(f in sec for f in ("__fdiv_rn(", "cosf(", "atan2f(")):
            raise SystemExit("F1's divisions and trig are not where the tool "
                             "expects")
        sec = CHEAP + sec.replace("__fdiv_rn(", "cheap_div(").replace(
            "cosf(", "cheap_cos(").replace("atan2f(", "cheap_atan2(")
    return src[:a] + sec + src[b:]


def kernel_body(src):
    """(start, end) of F2's block code in ``src``: from the row
    compaction's helper to the segment-sum kernel's closing brace."""
    a = src.index("__device__ unsigned compact_rows(")
    k = src.index("faces_segment_sum_kernel(Sources src")
    return a, src.rindex("}", k, src.index("// Blocks a cloud of n rows", k))


def variant(src, cut):
    """The source returning before ``cut`` (a key of CUTS), whole for
    None, or with clock stamps for "clock"."""
    a, b = kernel_body(src)
    body = src[a:b]
    if cut == "clock":
        body = body.replace("__syncthreads();", "__syncthreads(); " + STAMP)
        body = body.replace(PASS, PASS + " " + STAMP)
        body = PHASE.sub(lambda m: "\n  __syncthreads(); " + STAMP
                         + f" // phase {m.group(1)}\n  // {m.group(1)}. ", body)
        body = body.replace("  const long long row0 = b * n;",
                            "  const long long row0 = b * n;\n  " + STAMP, 1)
        body += "  __syncthreads(); " + STAMP + "\n"
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
    return [torch.from_numpy(a).to(dev) for a in (labels, valid, count,
                                                  centroid, normal)]


def step_inputs(name, dev):
    """(B, V, inputs, values) of the batch-8 eager step ``name``: its first
    face statistics call's labels, valid flags and sources, and the
    roughness call's values (on its own labels: the same V)."""
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(configs.CONFIGS[name]["model"])
    args, _ = cs.config_batch(name, list(range(8)), model.params, model.caps,
                              dev)
    calls = cs.record_faces(cs.eager_step(model.params, model.caps), args)
    stats = next(a for form, a in calls if form == "face_stats")
    vals = next(a for form, a in calls if form == "values")
    labels = stats[0]
    B, V = labels.numel() // labels.shape[-1], labels.shape[-1]
    flat = [x.reshape(B, *x.shape[-1 - (x.dim() > labels.dim()):])
            for x in stats[:5]]
    return B, V, flat, (vals[0].reshape(B, V), vals[1].reshape(B, V),
                        vals[2].reshape(B, V))


def calls(lib, B, V, dev, a, vals=None):
    """The face-statistics and values calls of ``lib`` on inputs ``a``
    (and ``vals``: values, labels and valid flags of the values call)."""
    labels, valid, count, centroid, normal = a
    outs = [torch.empty((B, V, 3), device=dev),
            torch.empty((B, V, 3), device=dev), torch.empty((B, V), device=dev),
            torch.empty((B, V), dtype=torch.int32, device=dev)]
    values = centroid[..., 0].contiguous()
    vlabels, vvalid = labels, valid
    if vals is not None:
        values, vlabels, vvalid = (x.contiguous() for x in vals)
    sums = torch.empty((B, V), device=dev)
    nbytes = max(int(lib.fccf_faces_segment_scratch(B, V, V, 1)),
                 int(lib.fccf_faces_segment_scratch(B, V, V, 0)))
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def face_stats():
        rc = lib.fccf_faces_face_stats(
            labels.data_ptr(), valid.data_ptr(), count.data_ptr(),
            centroid.data_ptr(), normal.data_ptr(),
            *(o.data_ptr() for o in outs), scratch.data_ptr(), B, V, V,
            stream())
        if rc:
            raise RuntimeError(f"face statistics launch: CUDA error {rc}")

    def values_sum():
        rc = lib.fccf_faces_segment_sum(
            vlabels.data_ptr(), vvalid.data_ptr(), values.data_ptr(),
            sums.data_ptr(), scratch.data_ptr(), B, V, V, stream())
        if rc:
            raise RuntimeError(f"values launch: CUDA error {rc}")

    return {"face_stats": face_stats, "values": values_sum}


def f1_main(B, V, dev, smi, src):
    """F1 whole and its timing variants (``f1_variant``), in turns, a call
    by CUDA events over a graph of 10 calls."""
    rng = np.random.default_rng(1)
    R = np.linalg.qr(rng.normal(size=(B * V, 3, 3)))[0]
    ev = rng.uniform(0.0, 1.0, (B * V, 3))
    cov = np.einsum("nij,nj,nkj->nik", R, ev, R).astype(np.float32)
    a = [torch.from_numpy(x).to(dev) for x in (
        cov.reshape(B, V, 3, 3),
        rng.uniform(-5, 5, (B, V, 3)).astype(np.float32),
        rng.integers(0, 12, (B, V)).astype(np.int32),
        rng.uniform(size=(B, V)) < 0.8,
        rng.uniform(-1, 1, (B, 3)).astype(np.float32))]
    out = {"shape": [B, V], "device": smi, "f1_us": []}
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        procs = {"whole": build(src, "fit_whole", tmp),
                 "float32": build(f1_variant(src, True, False), "fit_f32",
                                  tmp),
                 "no div/trig": build(f1_variant(src, False, True),
                                      "fit_cheap", tmp),
                 "float32, no div/trig": build(f1_variant(src, True, True),
                                               "fit_f32_cheap", tmp)}
        arms = {}
        for name, (proc, so) in procs.items():
            if proc.wait() != 0:
                raise SystemExit(f"nvcc failed for {name}:\n"
                                 f"{proc.stdout.read()[-3000:]}")
            lib = ctypes.CDLL(str(so))
            fk._bind(lib)

            def call(lib=lib):
                outs = (torch.empty((B, V, 3), device=dev),
                        torch.empty((B, V), device=dev),
                        torch.empty((B, V), dtype=torch.bool, device=dev),
                        torch.empty((B, V), dtype=torch.bool, device=dev))
                rc = lib.fccf_faces_plane_fit(
                    *(x.data_ptr() for x in a), *(o.data_ptr() for o in outs),
                    B, V, 5, 0.04, torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise RuntimeError(f"F1 launch: CUDA error {rc}")
            arms[name] = call
        names = list(procs)
        for name in names + names[::-1]:
            us = cs.graph_ms(arms[name]) * 1e3
            out["f1_us"].append((name, us))
            print(f"[phases] F1 ({B}, {V}) {name}: {us:.2f} us | {smi}",
                  flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clouds", type=int, default=16)
    ap.add_argument("--voxels", type=int, default=9216)
    ap.add_argument("--step", choices=("heritage", "office"),
                    help="the F2 inputs of that batch-8 eager step")
    ap.add_argument("--f1", action="store_true",
                    help="time F1 whole and its timing variants instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    dev = torch.device("cuda:0")
    B, V = args.clouds, args.voxels
    src = (ROOT / "fccf_pcr_torch" / "csrc" / "faces.cu").read_text()
    if args.f1:
        return f1_main(B, V, dev, smi, src)
    out = {"shape": [B, V], "device": smi, "ms": {},
           "cycles": {}}
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
        vals = None
        if args.step:
            B, V, a, vals = step_inputs(args.step, dev)
            out["shape"] = [B, V]
        else:
            a = inputs(B, V, dev)
        for name in [*CUTS, "whole"]:
            for form, fn in calls(libs[name], B, V, dev, a, vals).items():
                ms = cs.graph_ms(fn)
                out["ms"].setdefault(form, {})[name] = ms
                print(f"[phases] {form} ({B}, {V}) cut after {name}: "
                      f"{ms * 1e3:.2f} us | {smi}", flush=True)
        lib = libs["clock"]
        lib.fccf_clock_read.argtypes = [ctypes.c_void_p]
        for form, fn in calls(lib, B, V, dev, a, vals).items():
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
                  f"{stamps[-1] - stamps[0]} cycles; between stamps "
                  f"{cycles} | {smi}", flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
