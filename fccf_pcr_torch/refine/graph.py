"""A function of CUDA tensors captured once per shape as a CUDA graph
(``torch.cuda.CUDAGraph``) and replayed: the port's counterpart of
``jax.jit`` over a ``lax.while_loop`` whose test runs on the device.

``replay(fn, args, static)`` captures ``fn(*args, *static)`` the first
time a device sees its key (fn, static, each arg's shape and dtype),
after one eager warm-up run on the capture stream (which also makes the
``ops.batch.constant`` tensors ``fn`` reads: a copy from host memory
cannot be captured). Each call copies ``args`` into the graph's own
input buffers (never a view of the caller's), replays the graph on the
caller's current stream and returns a clone of its output: one host
launch, no host sync. ``fn`` must read nothing back to the host.

A device keeps at most ``MAX_GRAPHS`` graphs; the least recently used
one goes first, with its private memory pool. Each device has a lock
held across capture and replay, and captures use
``capture_error_mode="thread_local"``, so the host threads of
``parallel/mesh.py`` (one a card) go on launching while another card
captures. A capture or replay that fails raises: there is no fallback
to the eager loop. ``CAPTURES`` and ``REPLAYS`` count them.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

MAX_GRAPHS = 16
CAPTURES = 0
REPLAYS = 0
_LOCK = threading.Lock()
_DEVICES = {}  # torch.device -> (lock, OrderedDict key -> _Graph)


class _Graph:
    """``fn(*inputs, *static)`` captured on ``args``' device, with input
    buffers shaped as ``args``."""

    def __init__(self, fn, args, static):
        dev = args[0].device
        with torch.cuda.device(dev):
            current = torch.cuda.current_stream(dev)
            self.inputs = [torch.empty(a.shape, dtype=a.dtype, device=dev)
                           .copy_(a) for a in args]
            side = torch.cuda.Stream(dev)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                fn(*self.inputs, *static)  # warm-up, outside the capture
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.output = fn(*self.inputs, *static)
            current.wait_stream(side)

    def __call__(self, args):
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        return self.output.clone()


def _device(dev):
    with _LOCK:
        if dev not in _DEVICES:
            _DEVICES[dev] = (threading.Lock(), OrderedDict())
        return _DEVICES[dev]


def replay(fn, args, static=()):
    """``fn(*args, *static)`` through the device's graph for this key,
    captured first if the device has none. ``args`` are CUDA tensors on
    one device; ``static`` hashable Python values."""
    global CAPTURES, REPLAYS
    dev = args[0].device
    key = (fn, tuple(static), tuple((tuple(a.shape), a.dtype) for a in args))
    lock, graphs = _device(dev)
    with lock:
        g = graphs.get(key)
        if g is None:
            g = graphs[key] = _Graph(fn, args, static)
            while len(graphs) > MAX_GRAPHS:
                graphs.popitem(last=False)[1].graph.reset()
            with _LOCK:
                CAPTURES += 1
        else:
            graphs.move_to_end(key)
        out = g(args)
        with _LOCK:
            REPLAYS += 1
    return out


def _index(device):
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def cached(device=None):
    """The number of graphs kept for ``device`` (all devices: None)."""
    with _LOCK:
        items = list(_DEVICES.items())
    return sum(len(graphs) for dev, (_, graphs) in items
               if device is None or dev.index == _index(device))


def clear():
    """Drop every graph (and so its memory pool)."""
    with _LOCK:
        items = list(_DEVICES.values())
    for lock, graphs in items:
        with lock:
            for g in graphs.values():
                g.graph.reset()
            graphs.clear()


def pool_bytes(device):
    """Bytes the caching allocator holds in private pools on ``device``
    (the graphs' pools; from ``torch.cuda.memory_snapshot``)."""
    index = _index(device)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if s["device"] == index
               and tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))
