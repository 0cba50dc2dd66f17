#!/usr/bin/env python3
"""The SASS of the port's CUDA kernels by instruction class: each source
given is built with the package's nvcc flags (``ops.cuda_build``) into a
temporary directory, disassembled with ``cuobjdump -sass``, and each
kernel whose name holds one of ``--kernel`` has its instructions counted
by opcode (the text before the first ``.``) and by class (float64
arithmetic, float32 <-> float64 conversions, float32 arithmetic, the
multi-function unit, integer, memory, control). The counts are static: an
instruction in a loop or in a branch not taken counts once (the slow
paths of IEEE division and square root, and of cosf's argument
reduction, are subroutines that seldom run).

    python3 tools/torch_sass_count.py SOURCE [SOURCE ...]
        [--kernel faces_plane_fit_kernel] [--top 25]

Needs nvcc and cuobjdump (the CUDA toolkit), no card. Prints one line a
(source, kernel) with its classes and most frequent opcodes, and the
whole as JSON last.
"""

import argparse
import collections
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fccf_pcr_torch.ops import cuda_build  # noqa: E402

CLASSES = {
    "float64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"),
    "conversion": ("F2F", "F2I", "I2F", "F2FP", "I2FP", "F2IP"),
    "float32": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FCHK",
                "FSET"),
    "mufu": ("MUFU",),
    "memory": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDL", "STL", "LDC",
               "ATOMS", "ATOMG", "RED", "LDSM"),
    "control": ("BRA", "EXIT", "CALL", "RET", "BSSY", "BSYNC", "BAR",
                "WARPSYNC", "BMOV", "JMP", "NOP", "YIELD", "BPT"),
}
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
FUNCTION = re.compile(r"Function : (\S+)")


def cuobjdump():
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(path).exists():
        raise SystemExit("cuobjdump not found")
    return path


def kernels(sass):
    """{mangled name: Counter of opcodes} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = FUNCTION.search(line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = INSTR.search(line)
        if name is not None and m:
            out[name][m.group(1).split(".")[0]] += 1
    return out


def classes(ops):
    got = collections.Counter()
    for op, k in ops.items():
        cls = next((c for c, names in CLASSES.items() if op in names),
                   "integer and other")
        got[cls] += k
    got["all"] = sum(ops.values())
    return dict(got)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", type=pathlib.Path)
    ap.add_argument("--kernel", action="append",
                    default=None, help="a part of the kernels' names")
    ap.add_argument("--top", type=int, default=25)
    a = ap.parse_args()
    wanted = a.kernel or ["faces_plane_fit_kernel",
                          "faces_segment_sum_kernel"]
    res = {}
    with tempfile.TemporaryDirectory() as d:
        for i, src in enumerate(a.sources):
            so = pathlib.Path(d) / f"lib{i}.so"
            proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS,
                                   "-o", str(so), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise SystemExit(f"nvcc failed for {src}:\n{proc.stderr}")
            sass = subprocess.run([cuobjdump(), "-sass", str(so)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            for name, ops in kernels(sass).items():
                if not any(w in name for w in wanted):
                    continue
                row = dict(classes=classes(ops),
                           top=ops.most_common(a.top))
                res[f"{src}:{name}"] = row
                print(f"[sass] {src} {name[:90]}: {row['classes']}; "
                      f"most: {row['top']}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
