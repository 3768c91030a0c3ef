"""K2's share of its roofline: the frozen least time of the row writes in
the traced stretch (``flops.row_bound`` over the distinct rows each commit
writes) over K2's device time there, %."""

import flops


def read(run):
    t = run["trace"].device_s(flops.KERNEL_NAMES["k2"])
    b = run["bounds"].get("k2")
    return 100.0 * b / t if t > 0 and b else None
