"""input ms a batch (device, CUDA events): the copy of the raw clouds to
the card plus both sides' pre_downsample, the mean over the window's
batches."""

from benchlib.readers import mean_of


def read(rec):
    return mean_of(rec, "input_ms")
