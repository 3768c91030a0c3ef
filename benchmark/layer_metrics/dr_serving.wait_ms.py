"""The wait for the device and the ids' copy to the host (the port's span
``dr_serving.download``), ms a batch (``dr_serving.batches``) of a stretch
served with the port's recording on."""


def read(run):
    snap = run["spans"].get("program") or {}
    s = snap.get("spans", {}).get("dr_serving.download")
    n = snap.get("counters", {}).get("dr_serving.batches")
    return 1e3 * s["total_s"] / n if s and n else None
