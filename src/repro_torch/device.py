"""Device resolution: the card unless the caller asks for the CPU.

There is no silent fallback. Asking for ``"cuda"`` where PyTorch sees no
CUDA device raises, so a run that claims the card cannot quietly run on
the host.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``"cuda"`` / ``"cuda:N"`` / ``"cpu"``.

    Raises ``RuntimeError`` when CUDA is requested and unavailable, and
    ``ValueError`` for any other device type.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available()"
                " is False; pass device='cpu' to run on the host")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device must be 'cuda' or 'cpu', got {str(device)!r}")


def describe(device: DeviceLike = "cuda") -> Dict[str, object]:
    """Name and count of the devices of ``device``'s type."""
    dev = resolve(device)
    if dev.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}
