"""A kernel's share of its roofline: the bounds of its calls in the
traced segment (perfbench.work, from each call's arguments) over the
device time under its spans. Nothing when the segment made no call."""


def share(run, op):
    t = run.trace
    if not t or not t["calls"].get(op) or not t["op_device_s"].get(op):
        return None
    return 100.0 * t["bound_s"][op] / t["op_device_s"][op]
