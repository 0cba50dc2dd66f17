"""device idle % (CUPTI timeline): the share of the measured window in
which neither a kernel nor a copy ran on the card, from the device's
busy time a batch in the traced window (CUDA activity alone) over the
measured window's time a batch (``readers.idle_pct``; run.py prints
both windows' paces)."""

from benchlib.readers import idle_pct


def read(rec):
    return idle_pct(rec)
