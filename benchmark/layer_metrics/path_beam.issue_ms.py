"""The path beam's D layers issued on the host (the port's span
``path_beam.search``, no synchronize), ms a batch (``dr_serving.batches``)
of a stretch served with the port's recording on."""


def read(run):
    snap = run["spans"].get("program") or {}
    s = snap.get("spans", {}).get("path_beam.search")
    n = snap.get("counters", {}).get("dr_serving.batches")
    return 1e3 * s["total_s"] / n if s and n else None
