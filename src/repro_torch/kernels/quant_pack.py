"""Int8 block quantisation: CUDA kernel wrapper, plain version and unpack.

Port of ``repro/kernels/quant_pack.py`` and of ``quant_pack_ref`` /
``quant_unpack_ref`` in ``repro/kernels/ref.py``. For x of any shape whose
size is a multiple of ``block``, each block of ``block`` consecutive values
gets ``scale = max(max|x|, 1e-12) / 127`` and
``q = clip(round(x / scale), -127, 127)`` (round half to even). Returns
(q int8 of x's shape, scale (size / block,) float32).

* :func:`quant_pack_kernel` launches ``csrc/quant_pack.cu`` on a CUDA
  float32 tensor, block 256 (it raises for anything else);
* :func:`quant_pack_plain` is the same function in tensor ops, used for
  CPU tensors and as the kernel's yardstick on the card; its int8 values
  and scales are bit-equal to the kernel's;
* :func:`quant_unpack` dequantises, plain tensor ops on every device (the
  JAX package has no kernel for it either).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

BLOCK = 256                 # kBlock in csrc/quant_pack.cu


def _blocks(x: torch.Tensor, block: int) -> int:
    if block < 1 or x.numel() % block:
        raise ValueError(f"size {x.numel()} is not a multiple of the block "
                         f"{block}")
    return x.numel() // block


def quant_pack_plain(x: torch.Tensor, block: int = BLOCK,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    nb = _blocks(x, block)
    xb = x.reshape(nb, block).float()
    # 127 as a tensor on x's device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is not the kernel's (or
    # JAX's) IEEE quotient
    d127 = torch.tensor(127.0, device=x.device)
    scale = torch.clamp_min(xb.abs().amax(dim=1), 1e-12) / d127
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(x.shape), scale


def quant_unpack(q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    block = q.numel() // scale.numel()
    xb = q.reshape(-1, block).float() * scale[:, None]
    return xb.reshape(q.shape).to(dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("quant_pack")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.quant_pack_launch.argtypes = [p, p, p, ctypes.c_longlong, p]
        lib.quant_pack_launch.restype = ctypes.c_int
        lib.quant_pack_error_string.argtypes = [ctypes.c_int]
        lib.quant_pack_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def quant_pack_kernel(x: torch.Tensor, block: int = BLOCK,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/quant_pack.cu``: (q int8 of x's shape, scale float32).

    x contiguous float32 on a CUDA device, 16-byte aligned (a fresh
    tensor is), its size a multiple of 256; the kernel knows no other
    block.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"quant_pack kernel needs a CUDA tensor, got {dev}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous float32 tensor, got "
                         f"{x.dtype} (contiguous={x.is_contiguous()})")
    if block != BLOCK:
        raise ValueError(f"the kernel quantises blocks of {BLOCK}, not {block}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel loads float4)")
    nb = _blocks(x, block)
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    scale = torch.empty(nb, dtype=torch.float32, device=dev)
    if nb == 0:
        return q, scale
    lib = _lib()
    rc = lib.quant_pack_launch(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                               nb, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_pack kernel launch failed: "
                           f"{lib.quant_pack_error_string(rc).decode()}")
    _build.launch_counts["quant_pack"] += 1
    return q, scale
