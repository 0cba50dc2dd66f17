"""label_prop_propagate_roofline (%, CUPTI): the least time that the
propagations' inputs need (benchlib/propagate_work.py, from inputs
recorded in eager steps of the same batches) over the device time of
label_prop_propagate_kernel in the traced graph replays."""


def read(rec):
    p = rec.get("propagate")
    if not p or p["time_s"] <= 0:
        return None
    return 100.0 * p["bound_s"] / p["time_s"]
