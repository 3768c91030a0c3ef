"""The beam loop (``retrieval/packed_beam.py``): host clock from the codes'
upload to the device's results, ended by a synchronize, mean ms a batch."""


def read(run):
    s = run["spans"].get("beam")
    return 1e3 * sum(s) / len(s) if s else None
