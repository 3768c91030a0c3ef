"""Kernels, copies and sets on the device a DR serving batch, from the
trace."""


def read(run):
    tr = run["trace"]
    return tr.count() / tr.units if tr.units and tr.count() else None
