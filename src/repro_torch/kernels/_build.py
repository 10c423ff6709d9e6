"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers;
``nvcc`` builds it into ``lib<name>-<hash>.so`` (seconds for the placement
kernels, longer for the attention and SSD kernels, which instantiate one
kernel per route and width class) under the build directory
(``<repo>/build/repro_torch`` unless ``REPRO_TORCH_BUILD_DIR`` says
otherwise). The hash is of the source and of the shared headers
(``csrc/*.cuh``), so an edited source or header is rebuilt on its next
use. Libraries are loaded with ``ctypes``; pointers and the
stream are passed as ``ctypes.c_void_p``, and every C entry returns
``cudaGetLastError()`` for the wrapper to check.

``launch_counts`` counts launches per kernel: each wrapper adds one where
it launches its kernel, and nowhere else, once per call whatever number of
CUDA launches the call makes. A kernel with more than one route (K5 and K7:
``bf16_tc`` for bfloat16, ``f32`` for float32, :data:`ROUTES`) also adds one
to ``route_counts["<name>.<route>"]``; :func:`reset_launch_counts` clears
both.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("overlap", "entropy_features", "flash_attention",
           "decode_attention", "ssd_scan", "quant_pack", "byte_entropy")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last reset
launch_counts: "collections.Counter[str]" = collections.Counter()
#: "<kernel>.<route>" -> launches since the last reset (K5 and K7)
route_counts: "collections.Counter[str]" = collections.Counter()
#: source name -> nvcc's output (the ``-Xptxas -v`` register/smem report)
build_log: Dict[str, str] = {}

#: the ``dtype`` argument of the attention and SSD entries
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the route each dtype takes in K5 and K7: the CUDA-core kernel for
#: float32, the tensor-core kernel for bfloat16
ROUTES = {torch.float32: "f32", torch.bfloat16: "bf16_tc"}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    launch_counts.clear()
    route_counts.clear()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def library_path(name: str) -> Tuple[Path, Path]:
    """``(source, shared library)`` for ``csrc/<name>.cu``."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return src, build_dir() / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every source of ``names`` that has no up-to-date library,
    one ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 for a library that was already there)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {n: 0.0 for n in names}
    for name in names:
        src, lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = tmp.with_suffix(".log").open("w+")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, lib, time.perf_counter())
    failed = []
    pending = dict(procs)
    while pending:                  # poll, so each build is timed alone
        for name, (proc, log, tmp, lib, t0) in list(pending.items()):
            if proc.poll() is None:
                continue
            secs[name] = time.perf_counter() - t0
            del pending[name]
            with log:
                log.seek(0)
                build_log[name] = log.read()
            os.remove(log.name)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{build_log[name]}")
                continue
            os.replace(tmp, lib)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _, path = library_path(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
