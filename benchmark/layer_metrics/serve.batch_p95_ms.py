"""95th percentile of every batch's host-clock latency in the spans window
(codes upload to the top-k lists on the host), ms."""

import numpy as np


def read(run):
    s = run["spans"].get("serve.batch")
    return 1e3 * float(np.percentile(s, 95)) if s else None
