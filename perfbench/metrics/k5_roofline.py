"""k5_roofline: K5 (``repro_torch.kernels.ops.flash_attention``) as a share of its
roofline in the traced segment."""

from perfbench.metrics._roofline import share


def read(run):
    return share(run, "flash_attention")
