"""95th percentile, in ms, of the commit latency of every request committed
inside the window: from its submission at the leader to the moment the
last replica committed its decision (the benchmark's own host clock)."""

import numpy as np


def read(run):
    lat = run.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95.0)) * 1e3
