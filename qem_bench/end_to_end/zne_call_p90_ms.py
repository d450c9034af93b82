"""The 90th percentile of the latency of every ZNE sweep in the window, ms
(numpy's linear interpolation; a window holds ~150 sweeps, so ten or more
lie beyond it)."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 90)) * 1e3
