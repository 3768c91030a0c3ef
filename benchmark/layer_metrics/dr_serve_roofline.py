"""The DR serving path's share of its roofline: the frozen least time of
the profiled batches (``flops_dr.serve_bound`` at the cell's shapes) over
the device's busy time there (the union of every kernel, copy and set), %."""


def read(run):
    b = run["bounds"].get("dr_serve")
    busy = run["trace"].busy_s
    return 100.0 * b / busy if busy > 0 and b else None
