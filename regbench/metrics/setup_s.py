"""setup_s (s, host clock): from the start of the process to the first
timed batch: imports, the card's context, the kernels' builds (in a
checkout's first run), the pool, and one pass of every batch of the pool
through the timed path, which captures the step graph."""


def read(rec):
    return rec["setup_s"]
