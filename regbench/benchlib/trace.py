"""Reading a torch.profiler (CUPTI) capture: the device's busy time, the
kernels of each graph replay, the device time of each stage of an eager
step, and the breakdown of the device's operations and of its idle gaps
by what the host was doing. Read from the raw kineto records; copied and
rewritten from ``chip_smoke.py``'s ``device_records`` and
``kernel_stages``."""

from __future__ import annotations

import bisect
import collections

import torch
from torch.profiler import ProfilerActivity, profile

# The host's CUDA calls that launch work on the card.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")


def capture(fn, cpu=True):
    """The raw kineto records of one capture of ``fn()``, which is run to
    the end of its device work: CUDA activity, and with ``cpu`` the host's
    ops and ranges too (which slows a host-bound loop severalfold)."""
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return list(prof.profiler.kineto_results.events())


def _is_device(e):
    return e.device_type() == torch.autograd.DeviceType.CUDA


def device_records(events):
    """Kernels, copies and fills, without the device-side mirrors of the
    record_function ranges, which are no work of their own."""
    ranges = {e.name() for e in events
              if not _is_device(e) and e.is_user_annotation()}
    return [e for e in events if _is_device(e)
            and not e.is_user_annotation() and e.name() not in ranges]


def is_kernel(e):
    return not e.name().startswith(("Memcpy", "Memset"))


def host_ranges(events, name):
    """(start_ns, end_ns) of each host range called ``name``, in order."""
    return sorted((e.start_ns(), e.end_ns()) for e in events
                  if not _is_device(e) and e.name() == name)


def busy(records, t0, t1):
    """Seconds within [t0, t1] (ns) in which some device record ran (the
    union of their intervals)."""
    spans = sorted((max(e.start_ns(), t0), min(e.end_ns(), t1))
                   for e in records)
    total, end = 0, t0
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e9


def graph_replays(records):
    """The kernels of each graph replay, in launch order: the device's
    kernel records grouped by correlation id, which a replay's kernels
    share (the id of the cudaGraphLaunch that ran them) and an eager
    launch's one kernel has to itself."""
    by_id = collections.defaultdict(list)
    for e in records:
        if is_kernel(e):
            by_id[e.correlation_id()].append(e)
    replays = [r for r in by_id.values() if len(r) > 1]
    return sorted(replays, key=lambda r: min(e.start_ns() for e in r))


def kernel_ranges(events, records):
    """Each device kernel as (ranges, name, seconds): ``ranges`` the
    record_function ranges around the host call that launched it,
    outermost first. That call is the CUDA launch call with the kernel's
    correlation id (the port's kernels are launched through ctypes,
    inside no aten op), else the aten op the kernel is linked to."""
    ranges, ops, calls = [], {}, {}
    for e in events:
        if _is_device(e):
            continue
        if e.is_user_annotation():
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
        if e.name().startswith(LAUNCH_CALLS):
            calls[e.correlation_id()] = e.start_ns()
        elif e.name().startswith("aten::"):
            ops.setdefault(e.correlation_id(), e.start_ns())
    ranges.sort()
    starts = [r[0] for r in ranges]
    out = []
    for e in records:
        if not is_kernel(e):
            continue
        t = calls.get(e.correlation_id())
        if t is None and e.linked_correlation_id() > 0:
            t = ops.get(e.linked_correlation_id())
        chain = () if t is None else tuple(
            name for start, end, name in
            ranges[:bisect.bisect_right(starts, t)] if end >= t)
        out.append((chain, e.name(), (e.end_ns() - e.start_ns()) / 1e9))
    return out


def short(name, n=160):
    """A kernel's name cut to ``n`` characters (template arguments make
    some thousands long)."""
    return name if len(name) <= n else name[:n - 3] + "..."


def top_ops(records, n=10):
    """The ``n`` device operations that took most time: [name, seconds]."""
    total = collections.Counter()
    for e in records:
        total[short(e.name())] += (e.end_ns() - e.start_ns()) / 1e9
    return [[name, s] for name, s in total.most_common(n)]


def idle_gaps(events, records, t0, t1, n=10):
    """The device's idle time within [t0, t1] (ns) by what the host was
    doing: each gap between device records named by the benchmark's range
    and the innermost host event running at its middle, summed by that
    name; the ``n`` largest as [name, seconds]."""
    host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                  if not _is_device(e))
    spans = sorted((e.start_ns(), e.end_ns()) for e in records)
    gaps, end = [], t0
    for a, b in spans + [(t1, t1)]:
        if a > end:
            gaps.append((end, min(a, t1)))
        end = max(end, b)
        if end >= t1:
            break
    starts = [h[0] for h in host]
    total = collections.Counter()
    for a, b in gaps:
        mid = (a + b) // 2
        live = [h for h in host[:bisect.bisect_right(starts, mid)]
                if h[1] >= mid]
        outer = [h[2] for h in live if h[2].startswith("regbench.")]
        inner = min(live, key=lambda h: h[1] - h[0])[2] if live else "none"
        name = " > ".join(dict.fromkeys(outer[:1] + [inner]))
        total[name] += (b - a) / 1e9
    return [[name, s] for name, s in total.most_common(n)]
