"""What the per-layer metrics' readers share."""

from __future__ import annotations


def mean_of(rec, key):
    """The mean of a list of the records, or None where there is none."""
    values = rec.get(key)
    return sum(values) / len(values) if values else None


def stage_ms(rec, layer):
    """Device ms a step of a layer's stages, or None."""
    return rec.get("stage_ms", {}).get(layer)


def idle_pct(rec):
    """The device's idle share of the measured window in %, or None: one
    less the device's busy time a batch in the traced window (CUDA
    activity alone) over the measured window's time a batch. The traced
    window's own pace is not used: tracing the kernels slows the host's
    launches, so more of that window is idle than of an untraced one."""
    busy, n = rec.get("traced_busy_s"), rec.get("traced_batches")
    if not n or busy is None or not rec.get("latencies_s"):
        return None
    per_batch = rec["window_s"] / len(rec["latencies_s"])
    return 100.0 * (1.0 - busy / n / per_batch)
