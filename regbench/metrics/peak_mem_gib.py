"""peak_mem_gib (GiB): torch.cuda.max_memory_reserved() over the window,
so the step graph's private pool is in it."""


def read(rec):
    return rec["peak_mem_bytes"] / 2**30 if "peak_mem_bytes" in rec else None
