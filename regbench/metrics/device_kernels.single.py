"""device kernels a pair (CUPTI): the kernels of one graph replay (the
most that a replay of the traced window holds: CUPTI may drop a record,
never adds one) over the batch's pairs."""


def read(rec):
    return rec.get("kernels_per_pair")
