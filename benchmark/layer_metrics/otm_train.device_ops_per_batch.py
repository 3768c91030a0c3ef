"""Kernels, copies and sets on the device an OTM batch (its frozen part and
its level steps), from the trace."""


def read(run):
    tr = run["trace"]
    return tr.count() / tr.units if tr.units and tr.count() else None
