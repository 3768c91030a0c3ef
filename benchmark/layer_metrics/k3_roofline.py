"""K3's share of its roofline: the frozen least time of the launches in
the traced stretch (``flops.k3_bound`` at the cell's shapes) over K3's
device time there, %."""

import flops


def read(run):
    t = run["trace"].device_s(flops.KERNEL_NAMES["k3"])
    b = run["bounds"].get("k3")
    return 100.0 * b / t if t > 0 and b else None
