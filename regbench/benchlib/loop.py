"""The closed loop that the window times: one client hands a batch of
raw pairs to the copy (sources and targets stacked in one tensor),
``pre_downsample`` makes both sides' clouds in one call, the batched step registers them (on a card, one replay of its CUDA graph),
and the transforms and every other result field come back to the host;
then the next batch goes. Each call into a layer runs in a
record_function range of the benchmark's own (``regbench.copy``,
``regbench.pre_downsample``, ``regbench.step``, ``regbench.result``)."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

# Status bits that mean a pair got no usable transform: an overflow of a
# capacity (1, 2, 8, 16, 32) or no type scored (4).
FAILED_BITS = 1 | 2 | 4 | 8 | 16 | 32


class Runner:
    """The timed path of one cell: ``run(slot)`` sends the pool's batch
    ``slot`` through it and returns the host copies of what came back."""

    def __init__(self, port, config, pool, device, fault=None):
        self.port = port
        self.params = port.FCCFParams(**config["params"])
        self.caps = port.Capacities(**config["caps"])
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.pool = pool
        self.fn = port.make_register_fn(self.params, self.caps, batched=True,
                                        device=self.device)
        if fault is not None:
            self.fn = fault(self.fn)
        self.down = [None] * len(pool.batches)  # the latest per slot
        self.out = [None] * len(pool.batches)

    def _host(self, slot, tensors):
        """Pinned host buffers for ``tensors``, made once a slot."""
        if self.out[slot] is None:
            self.out[slot] = [torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=self.cuda)
                              for t in tensors]
        return self.out[slot]

    def run(self, slot, events=None):
        b = self.pool.batches[slot]
        dev, params, caps = self.device, self.params, self.caps
        if events is not None:
            events.append([torch.cuda.Event(enable_timing=True)
                           for _ in range(3)])
            events[-1][0].record()
        with record_function("regbench.copy"):
            points = b.points.to(dev, non_blocking=True)
            mask = b.mask.to(dev, non_blocking=True)
        with record_function("regbench.pre_downsample"):
            # both sides of the batch in one call, sources first
            d = self.port.pre_downsample(points, mask, params, caps,
                                         device=dev)
            B = b.pairs
            ds = tuple(x[:B] for x in d)
            dt = tuple(x[B:] for x in d)
        if events is not None:
            events[-1][1].record()
        with record_function("regbench.step"):
            res = self.fn(ds[0], ds[1], dt[0], dt[1])
        if events is not None:
            events[-1][2].record()
        with record_function("regbench.result"):
            fields = list(res) + [ds[2], dt[2]]
            out = self._host(slot, fields)
            for o, f in zip(out, fields):
                o.copy_(f, non_blocking=True)
            if self.cuda:
                torch.cuda.current_stream(dev).synchronize()
        self.down[slot] = (ds, dt)
        return out


def failed(out):
    """Pairs of a batch's host results with no usable transform."""
    status, src_ovf, tar_ovf = out[5], out[-2], out[-1]
    return int((((status & FAILED_BITS) != 0) | src_ovf | tar_ovf).sum())


def window(runner, seconds, events=None):
    """Batches back to back, cycling the pool from slot 0, until
    ``seconds`` have passed at the end of a batch. Returns the window's
    records: its length, the pairs sent and failed, and each batch's
    latency (s, host clock, from the hand-over of its raw clouds until
    its results are on the host)."""
    n_slots = len(runner.pool.batches)
    B = runner.pool.batches[0].pairs
    latencies, pairs, n_failed, slot = [], 0, 0, 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out = runner.run(slot, events)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        pairs += B
        n_failed += failed(out)
        slot = (slot + 1) % n_slots
        if t1 - start >= seconds:
            break
    return dict(window_s=t1 - start, pairs=pairs, failed=n_failed,
                batch=B, latencies_s=latencies)
