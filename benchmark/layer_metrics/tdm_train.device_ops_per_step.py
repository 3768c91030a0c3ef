"""Kernels, copies and sets on the device a TDM train step, from the trace
of a ``train_resident`` call."""


def read(run):
    tr = run["trace"]
    return tr.count() / tr.units if tr.units and tr.count() else None
