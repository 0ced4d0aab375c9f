"""95th percentile, in ms, of the WAL's group-commit fsyncs in the window,
from the program's ``wal.fsync`` spans of every replica."""

import numpy as np


def read(run):
    spans = run.get("fsync_s")
    if not spans:
        return None
    return float(np.percentile(np.asarray(spans), 95.0)) * 1e3
