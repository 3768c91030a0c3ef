"""95th percentile of ``DRServing.recommend_batch_device``'s own span
(``dr_serving.recommend_batch``: upload, path beam, rerank, download) over
the batches of a stretch served with the port's recording on, ms."""


def read(run):
    snap = run["spans"].get("program") or {}
    s = snap.get("spans", {}).get("dr_serving.recommend_batch")
    return 1e3 * s["p95_s"] if s else None
