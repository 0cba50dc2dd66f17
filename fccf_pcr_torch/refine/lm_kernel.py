"""The LM solve of ``refine_pairs`` as one CUDA kernel (L1) and its plain
PyTorch version.

The JAX package runs the LM refine as a ``lax.while_loop``
(``fccf_pcr_tpu/refine/gauss_newton.py:100``), vmapped over the candidate
lanes, which XLA compiles into one device loop. ``refine_lm`` takes:

  - for CUDA tensors, the kernel of ``csrc/lm.cu``: one launch runs every
    lane's whole loop on the card (a warp a lane, 32 candidate steps a
    solve round), with no host sync, so the register step's CUDA graph
    captures it. It is bit-equal to the plain version run on the card: it
    does ``lm_loop``'s float32 operations in its order (the source says
    how), and a lane's result does not depend on the other lanes of the
    launch. There is no fallback: a missing ``nvcc``, a failed build or a
    refused launch raises;
  - for CPU tensors, the plain version, ``gauss_newton.lm_loop`` with its
    early exit.

Any other device raises. The library is built with nvcc into
``fccf_pcr_torch/build/`` at first use and bound with ctypes
(``ops.cuda_build``). ``LAUNCHES`` counts the kernel's launches
(``ops.graph.count_launch``: a launch captured into a CUDA graph counts at
each replay).
"""

from __future__ import annotations

import ctypes
import sys

import torch
from torch.profiler import record_function

from ..ops import geometry, graph
from ..ops.cuda_build import CudaLibrary

# Launches of lm_refine_kernel (L1).
LAUNCHES = 0
_THIS = sys.modules[__name__]
# The most plane pairs a lane of L1's registers instantiation (kRegPlanes).
REG_PLANES = 32


def _bind(lib):
    fn = lib.fccf_lm_refine
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_lm_scratch_floats
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong


_LIBRARY = CudaLibrary("lm.cu", _bind)


def build(force: bool = False):
    """Compile ``csrc/lm.cu`` (if needed, or always with ``force``) and
    load it. Returns the ctypes library."""
    return _LIBRARY.load(force)


def lm_solve(n1, p1, n2, p2, w, iters: int = 50, registers=None):
    """One launch of L1 on the current stream, asynchronously: the final
    (q (Bt, 4), t (Bt, 3), steps (Bt,) int32, accepted (Bt,) int32) of
    every lane: steps the LM steps (solves) the lane ran before it
    stopped, accepted how many of them it accepted. n1, p1, n2, p2
    (Bt, F, 3) and w (Bt, F) float32 CUDA tensors on one device, F >= 1
    (any F whose scratch can be allocated). ``registers`` picks the
    kernel's instantiation (True: planes in registers, F <= REG_PLANES;
    False: planes and rows through a scratch buffer); None takes
    registers where F allows."""
    Bt, F = w.shape[0], w.shape[-1]
    dev = w.device
    for name, x, shape in (("n1", n1, (Bt, F, 3)), ("p1", p1, (Bt, F, 3)),
                           ("n2", n2, (Bt, F, 3)), ("p2", p2, (Bt, F, 3)),
                           ("w", w, (Bt, F))):
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != shape):
            raise ValueError(
                f"lm_solve: {name} wants float32 {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if F < 1 or iters < 0:
        raise ValueError(f"lm_solve: F = {F} (want >= 1), "
                         f"iters = {iters} (want >= 0)")
    if registers is None:
        registers = F <= REG_PLANES
    if registers and F > REG_PLANES:
        raise ValueError(f"lm_solve: F = {F} does not fit in registers "
                         f"(want 1..{REG_PLANES})")
    if dev.type != "cuda":
        raise ValueError(f"lm_solve: unsupported device {dev}")
    q = torch.empty((Bt, 4), dtype=torch.float32, device=dev)
    t = torch.empty((Bt, 3), dtype=torch.float32, device=dev)
    steps = torch.empty((Bt,), dtype=torch.int32, device=dev)
    accepted = torch.empty((Bt,), dtype=torch.int32, device=dev)
    if Bt == 0:
        return q, t, steps, accepted
    inputs = [x.contiguous() for x in (n1, p1, n2, p2, w)]
    lib = build()
    scratch = None if registers else torch.empty(
        (Bt, int(lib.fccf_lm_scratch_floats(F))), dtype=torch.float32,
        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the C entry launches on the current one
        rc = lib.fccf_lm_refine(*(x.data_ptr() for x in inputs),
                                q.data_ptr(), t.data_ptr(), steps.data_ptr(),
                                accepted.data_ptr(),
                                None if scratch is None else scratch.data_ptr(),
                                Bt, F, iters, int(registers), stream)
    if rc != 0:
        raise RuntimeError(f"fccf_lm_refine launch failed: CUDA error {rc}")
    graph.count_launch(_THIS, "LAUNCHES")
    return q, t, steps, accepted


def refine_lm(n1, p1, n2, p2, w, iters: int = 50):
    """The (Bt, 4, 4) corrections of ``refine_pairs``: CPU tensors take
    ``lm_loop`` with its early exit, CUDA tensors the kernel L1 (the
    transform formed from its q and t by the same torch ops as
    ``lm_loop``'s); any other device raises."""
    with record_function("lm"):
        if n1.device.type == "cpu":
            # gauss_newton imports this module
            from .gauss_newton import lm_loop

            return lm_loop(n1, p1, n2, p2, w, iters, early_exit=True)
        if n1.device.type == "cuda":
            q, t = lm_solve(n1, p1, n2, p2, w, iters)[:2]
            return geometry.make_transform(geometry.quat_to_matrix(q), t)
        raise ValueError(f"refine_lm: unsupported device {n1.device}")
