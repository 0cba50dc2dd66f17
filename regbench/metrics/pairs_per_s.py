"""pairs_per_s (pairs/s, host clock): every pair whose transform reached
the host during the window, over the window's length (from the first
batch's hand-over to the end of the last batch)."""


def read(rec):
    return rec["pairs"] / rec["window_s"]
