"""The 95th percentile of the latency of every call in the window, ms
(numpy's linear interpolation between order statistics)."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3
