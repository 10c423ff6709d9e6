"""k7_roofline: K7 (``repro_torch.kernels.ops.ssd_scan``) as a share of its
roofline in the traced segment."""

from perfbench.metrics._roofline import share


def read(run):
    return share(run, "ssd_scan")
