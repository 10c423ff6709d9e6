"""ttft_p95_ms: the 95th percentile, over every request the window
admitted, of the milliseconds from its arrival to its greedy tokens being
synchronised (host clock): its time to first token."""

import numpy as np


def read(run):
    if run.kind != "prefill" or not run.window["ttft_s"]:
        return None
    return float(np.percentile(run.window["ttft_s"], 95)) * 1e3
