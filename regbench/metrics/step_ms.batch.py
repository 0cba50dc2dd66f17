"""step ms a batch (device, CUDA events): the batched register step (one
graph replay), the mean over the window's batches."""

from benchlib.readers import mean_of


def read(rec):
    return mean_of(rec, "step_ms")
