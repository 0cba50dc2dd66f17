"""The records of a ``--trace 1`` run, read after the measured window:

- the traced window: more batches of the same loop, half a second's
  worth at least, under torch.profiler with CUDA activity alone (after
  one batch that warms the profiler up), for the device's busy time a
  batch (the idle share, ``readers.idle_pct``), the kernels of each graph
  replay, the propagation kernel's time in the replays and the device
  operations of the breakdown. Tracing the kernels slows the host's
  launches, so this window runs slower than the measured one;
- the pool's batches again under the profiler with the host's activity
  as well, for the breakdown's idle gaps by what the host was doing
  (slower still, so those gaps are longer than untraced);
- eager steps (the form the step graph is captured from,
  ``pipeline/register._register_batch``) under torch.profiler, each
  kernel counted in the port's stage ranges around its launch call;
- one more eager step of each of those batches, outside the profiler,
  recording the propagations' inputs for their work count
  (``propagate_work``).
"""

from __future__ import annotations

import collections
import contextlib
import importlib

import torch

from . import propagate_work, trace

PROPAGATE_KERNEL = "label_prop_propagate_kernel"
# The port's stage ranges (pipeline/register.py), by the layer they
# belong to.
STAGES = {"faces": "faces", "hypotheses": "cluster", "cluster": "cluster",
          "quick_verify": "refine", "select": "refine", "refine": "refine",
          "fine_verify": "fine_verify", "downsample": "other",
          "fuse": "other"}


def traced_window(runner, batches, host_batches):
    """Runs ``batches`` (slots, in order) under the profiler with CUDA
    activity alone, after one batch under it that warms the profiler up,
    then ``host_batches`` with the host's activity as well: the traced
    window's records. The window spans the device's first and last
    operation of the first capture, from the first batch's copy to the
    last one's results."""
    trace.capture(lambda: runner.run(batches[0]), cpu=False)
    events = trace.capture(lambda: [runner.run(s) for s in batches],
                           cpu=False)
    records = trace.device_records(events)
    t0 = min(e.start_ns() for e in records)
    t1 = max(e.end_ns() for e in records)
    replays = trace.graph_replays(records)
    B = runner.pool.batches[0].pairs
    kernels = max((len(r) for r in replays), default=0)
    propagate = [sum((e.end_ns() - e.start_ns()) / 1e9 for e in r
                     if PROPAGATE_KERNEL in e.name())
                 for r in replays]
    host = trace.capture(lambda: [runner.run(s) for s in host_batches])
    host_records = trace.device_records(host)
    h0 = trace.host_ranges(host, "regbench.copy")[0][0]
    h1 = trace.host_ranges(host, "regbench.result")[-1][1]
    return dict(
        traced_busy_s=trace.busy(records, t0, t1),
        traced_window_s=(t1 - t0) / 1e9,
        traced_batches=len(batches),
        host_traced_window_s=(h1 - h0) / 1e9,
        host_traced_batches=len(host_batches),
        kernels_per_pair=kernels / B if replays else None,
        replay_slots=list(batches[:len(replays)]) if len(replays) == len(
            batches) else None,
        propagate_s=propagate,
        breakdown=dict(device_ops=trace.top_ops(records),
                       idle_gaps=trace.idle_gaps(host, host_records, h0,
                                                 h1)))


@contextlib.contextmanager
def recorded_propagations(port, calls):
    """``features.faces.label_propagate`` recording its inputs (normal,
    centroid, valid, angle) into ``calls`` while the block runs."""
    faces = importlib.import_module(port.__name__ + ".features.faces")
    original = faces.label_propagate

    def recording(normal, centroid, valid, angle, *args, **kwargs):
        calls.append((normal.detach().clone(), centroid.detach().clone(),
                      valid.detach().clone(), float(angle)))
        return original(normal, centroid, valid, angle, *args, **kwargs)

    faces.label_propagate = recording
    try:
        yield
    finally:
        faces.label_propagate = original


def eager_stages(runner, slots):
    """Device seconds a step by layer over eager steps of ``slots`` (one
    capture), and each slot's propagation bound (seconds, the limit that
    binds) from the inputs recorded in another eager step of it, outside
    the capture."""
    register = importlib.import_module(runner.port.__name__
                                       + ".pipeline.register")

    def step(s):
        ds, dt = runner.down[s]
        register.set_precision()
        return register._register_batch(ds[0], ds[1], dt[0], dt[1],
                                        runner.params, runner.caps)

    events = trace.capture(lambda: [step(s) for s in slots])
    stage_s = collections.Counter()
    for chain, _, seconds in trace.kernel_ranges(
            events, trace.device_records(events)):
        layer = next((STAGES[r] for r in chain if r in STAGES), None)
        if layer is not None:
            stage_s[layer] += seconds
    bounds = {}
    for s in slots:
        calls = []
        with recorded_propagations(runner.port, calls):
            step(s)
        ops = nbytes = 0
        for normal, centroid, valid, angle in calls:
            o, b = propagate_work.work(normal, centroid, valid, angle)
            ops, nbytes = ops + o, nbytes + b
        bounds[s] = propagate_work.bound_s(ops, nbytes)
    return {k: v / len(slots) for k, v in stage_s.items()}, bounds


def records(runner, window_events, slots_traced, host_slots, eager_slots):
    """Every per-layer record of a traced run."""
    out = {}
    if window_events:
        torch.cuda.synchronize()
        out["input_ms"] = [a.elapsed_time(b) for a, b, _ in window_events]
        out["step_ms"] = [b.elapsed_time(c) for _, b, c in window_events]
    tw = traced_window(runner, slots_traced, host_slots)
    out.update(tw)
    stage_s, bounds = eager_stages(runner, eager_slots)
    out["stage_ms"] = {k: v * 1e3 for k, v in stage_s.items()}
    if tw["replay_slots"] is not None:
        pairs = [(bounds[s], t) for s, t in zip(tw["replay_slots"],
                                                tw["propagate_s"])
                 if s in bounds]
        # a replay whose propagation records CUPTI dropped reads 0: left
        # out, with its bound
        pairs = [(b, t) for b, t in pairs if t > 0]
        if pairs:
            out["propagate"] = dict(
                bound_s=sum(b[0] for b, _ in pairs),
                time_s=sum(t for _, t in pairs),
                bound_by=collections.Counter(b[1] for b, _ in pairs)
                .most_common(1)[0][0])
    return out
