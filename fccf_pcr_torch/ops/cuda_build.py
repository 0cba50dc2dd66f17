"""Build and load the port's CUDA kernels: one ``csrc/*.cu`` source with a
plain C interface, compiled by nvcc for Hopper (sm_90a) into a shared
library under ``fccf_pcr_torch/build/`` (gitignored) and loaded with
ctypes. Each library is built at its first use in a process when it is
missing or older than its source, or always with ``force``. A missing
nvcc or a failed build raises. ``CudaLibrary.build_log`` keeps nvcc's
output of the last build, with ptxas's registers, shared memory and
spills of each kernel (``-Xptxas -v``).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return path


class CudaLibrary:
    """``csrc/<source>`` as ``build/lib<stem>.so``; ``bind(lib)`` sets the
    ctypes argtypes and restype of its entry points."""

    def __init__(self, source: str, bind):
        self.source = CSRC_DIR / source
        self.path = BUILD_DIR / f"lib{self.source.stem}.so"
        self._bind = bind
        self._lib = None
        self.build_log = ""
        # One build at a time: host threads of a split over devices all
        # load the library at their first launch.
        self._lock = threading.Lock()

    def compile(self):
        """Run nvcc (into a temporary name, then an atomic rename)."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(f"{self.path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, self.path)
        self.build_log = proc.stdout + proc.stderr
        self._lib = None

    def load(self, force: bool = False):
        """The bound ctypes library, compiled first if needed. The source
        is checked for staleness once per process: every launch calls
        this, and two file stats per launch cost more than the launch."""
        if self._lib is not None and not force:
            return self._lib
        with self._lock:
            if self._lib is not None and not force:
                return self._lib
            stale = (
                not self.path.exists()
                or self.path.stat().st_mtime < self.source.stat().st_mtime
            )
            if force or stale:
                self.compile()
            if self._lib is None:
                lib = ctypes.CDLL(str(self.path))
                self._bind(lib)
                self._lib = lib
            return self._lib
