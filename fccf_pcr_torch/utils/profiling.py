"""Profiling and tracing (port of ``fccf_pcr_tpu/utils/profiling.py``).

  - ``StageTimer``: per-stage wall timing that waits for the devices;
  - ``trace``: a ``torch.profiler`` capture of the host and, with a card,
    the device, exported as a Chrome trace (chrome://tracing, Perfetto);
  - ``annotate``: a named range inside a trace
    (``torch.profiler.record_function``; the pipeline's stages carry one
    each, ``pipeline/register.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _cuda_devices(x, out):
    """Every CUDA device holding a tensor in ``x``: a tensor, or tuples
    (NamedTuples such as ``RegistrationResult`` included), lists and dict
    values of them, at any depth."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _cuda_devices(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _cuda_devices(y, out)
    return out


class StageTimer:
    """Accumulates named wall-clock stage timings (device-synchronized)."""

    def __init__(self):
        self.times = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name, *sync):
        """Times the block. CUDA work is asynchronous, so outputs made
        INSIDE the block must be registered for the exit barrier: append
        them to the yielded list::

            with timer.stage("register") as live:
                live.append(fn(x))

        On exit every CUDA device holding a tensor in that list (``*sync``
        included) is synchronized. The time is recorded even if the body
        raises."""
        live: list = list(sync)
        t0 = time.perf_counter()
        try:
            yield live
        finally:
            for dev in _cuda_devices(live, set()):
                torch.cuda.synchronize(dev)
            self.times[name] = (
                self.times.get(name, 0.0) + time.perf_counter() - t0
            )

    def report(self):
        total = sum(self.times.values())
        lines = [f"{'stage':<28}{'time (ms)':>12}{'share':>9}"]
        for k, v in self.times.items():
            lines.append(f"{k:<28}{v * 1e3:>12.2f}{v / max(total, 1e-12):>8.1%}")
        lines.append(f"{'total':<28}{total * 1e3:>12.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block (the CPU, and the
    card's kernels when one is present) and export it as a Chrome trace,
    ``logdir/trace_<pid>_<ns>.json``. Yields the profiler; its
    ``trace_path`` attribute names the file once the block has ended."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(logdir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path


annotate = record_function
