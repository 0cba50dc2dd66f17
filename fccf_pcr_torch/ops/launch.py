"""What the kernel wrappers share around a ctypes launch: the input
checks, the stream, the device dispatch and the launch's count
(``graph.count_launch``)."""

from __future__ import annotations

import torch

from . import graph


def stream(dev):
    """The current CUDA stream of ``dev`` as the integer a C entry
    takes."""
    return torch.cuda.current_stream(dev).cuda_stream


def checked(what, tensors, dtypes, shapes):
    """Raises unless each tensor has its dtype and shape and all lie on
    the first one's device; returns them contiguous."""
    dev = tensors[0].device
    for name, t, dt, shape in zip(what, tensors, dtypes, shapes):
        if t.dtype != dt or tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(f"{name}: want {dt} {tuple(shape)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return tuple(t.contiguous() for t in tensors)


def device_type(t, what):
    """"cpu" or "cuda", the device type of ``t``; any other raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def launched(rc, entry, owner, counter):
    """Raises unless the C entry returned 0, else counts one launch of
    ``owner.counter`` (``graph.count_launch``)."""
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    graph.count_launch(owner, counter)
