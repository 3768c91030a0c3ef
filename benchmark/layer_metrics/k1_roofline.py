"""K1's share of its roofline: the frozen least time of the launches in
the traced stretch (``flops.k1_bound`` at the cell's shapes) over K1's
device time there, %."""

import flops


def read(run):
    t = run["trace"].device_s(flops.KERNEL_NAMES["k1"])
    b = run["bounds"].get("k1")
    return 100.0 * b / t if t > 0 and b else None
