"""k3_roofline: K3 (``repro_torch.kernels.ops.quant_pack``) as a share of its
roofline in the traced segment."""

from perfbench.metrics._roofline import share


def read(run):
    return share(run, "quant_pack")
