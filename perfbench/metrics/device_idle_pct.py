"""device_idle_pct: the share of a traced segment in which no kernel,
copy or fill ran on the card, from a trace of the device alone, so that
tracing the host does not slow what it measures (torch.profiler)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
