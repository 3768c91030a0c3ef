"""Download of the beam's results and the host's consumed filter and top-k
(``retrieval/tree_beam.filter_topk``), host clock, mean ms a batch."""


def read(run):
    s = run["spans"].get("serve.filter")
    return 1e3 * sum(s) / len(s) if s else None
