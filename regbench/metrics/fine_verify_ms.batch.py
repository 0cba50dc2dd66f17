"""fine_verify ms a step (device, CUPTI): kernels launched under the port's
stage ranges of this layer in eager steps of the pool's batches, each
kernel counted in the ranges around its launch call."""

from benchlib.readers import stage_ms


def read(rec):
    return stage_ms(rec, "fine_verify")
