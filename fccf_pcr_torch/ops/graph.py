"""Functions of CUDA tensors captured once per shape as CUDA graphs
(``torch.cuda.CUDAGraph``) and replayed: the port's counterpart of
``jax.jit``, whose compiled program runs its loops on the device.

A ``Graphs`` is a cache of one kind of program, made by the module that
owns the program (``pipeline/register.py``'s ``STEP``: the whole batched
register step). ``Graphs.replay(fn, args, static)`` captures
``fn(*args, *static)`` the first time a device sees its key (fn,
static, each arg's shape and dtype), after one eager warm-up run on the
capture stream (which also
makes the ``ops.batch.constant`` tensors ``fn`` reads: a copy from host
memory cannot be captured). Each call copies ``args`` into the graph's
own input buffers (never a view of the caller's), replays the graph on
the caller's current stream and returns a clone of its output (a tensor,
or a tuple or NamedTuple of tensors): one host launch, no host sync.
``fn`` must read nothing back to the host.

A device keeps at most ``max_graphs`` graphs of a kind; the least
recently used one goes first, with its private memory pool. Each device
has a lock held across capture and replay, and captures use
``capture_error_mode="thread_local"``, so the host threads of
``parallel/mesh.py`` (one a card) go on launching while another card
captures. A capture or replay that fails raises: there is no fallback to
the eager form. ``captures`` and ``replays`` count them.

Launch counts stay honest under replay: a kernel wrapper of the port
counts its launch with ``count_launch``, which, while the calling thread
captures a graph, adds it to that graph's tally instead (the kernel is
recorded, not launched); each replay then adds the graph's tally to the
counts.
"""

from __future__ import annotations

import collections
import threading
from collections import OrderedDict

import torch

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_CAPTURING = threading.local()  # .tally: the launches of this thread's capture


def count_launch(owner, name):
    """One launch of a kernel of the port: ``owner.name += 1`` (under a
    lock: host threads launch on several cards), or, inside a capture on
    this thread, one more in the graph's tally."""
    tally = getattr(_CAPTURING, "tally", None)
    with _COUNT_LOCK:
        if tally is not None:
            tally[(owner, name)] += 1
        else:
            setattr(owner, name, getattr(owner, name) + 1)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    items = [_clone(x) for x in out]
    return type(out)(*items) if hasattr(out, "_fields") else type(out)(items)


class _Graph:
    """``fn(*inputs, *static)`` captured on ``args``' device, with input
    buffers shaped as ``args``, and the launches it counted."""

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
            self.tally = collections.Counter()
            outer = getattr(_CAPTURING, "tally", None)
            _CAPTURING.tally = self.tally
            try:
                with torch.cuda.graph(self.graph, stream=side,
                                      capture_error_mode="thread_local"):
                    self.output = fn(*self.inputs, *static)
            finally:
                _CAPTURING.tally = outer
            current.wait_stream(side)

    def __call__(self, args):
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        with _COUNT_LOCK:
            for (owner, name), n in self.tally.items():
                setattr(owner, name, getattr(owner, name) + n)
        return _clone(self.output)


def _index(device):
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


class Graphs:
    """A cache of captured graphs of one kind of program, at most
    ``max_graphs`` a device."""

    def __init__(self, max_graphs: int):
        self.max_graphs = max_graphs
        self.captures = 0
        self.replays = 0
        self._devices = {}  # torch.device -> (lock, OrderedDict key -> _Graph)

    def _device(self, dev):
        with _LOCK:
            if dev not in self._devices:
                self._devices[dev] = (threading.Lock(), OrderedDict())
            return self._devices[dev]

    def replay(self, fn, args, static=()):
        """``fn(*args, *static)`` through the device's graph for this key,
        captured first if the device has none. ``args`` are CUDA tensors
        on one device; ``static`` hashable Python values."""
        dev = args[0].device
        key = (fn, tuple(static),
               tuple((tuple(a.shape), a.dtype) for a in args))
        lock, graphs = self._device(dev)
        with lock:
            g = graphs.get(key)
            if g is None:
                g = graphs[key] = _Graph(fn, args, static)
                while len(graphs) > self.max_graphs:
                    graphs.popitem(last=False)[1].graph.reset()
                with _COUNT_LOCK:
                    self.captures += 1
            else:
                graphs.move_to_end(key)
            out = g(args)
            with _COUNT_LOCK:
                self.replays += 1
        return out

    def cached(self, device=None):
        """The number of graphs kept for ``device`` (all devices: None)."""
        with _LOCK:
            items = list(self._devices.items())
        return sum(len(graphs) for dev, (_, graphs) in items
                   if device is None or dev.index == _index(device))

    def clear(self):
        """Drop every graph of this kind (and so its memory pool)."""
        with _LOCK:
            items = list(self._devices.values())
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
