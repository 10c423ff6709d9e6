"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
it compiles in seconds into ``lib<name>-<hash>.so`` under the build
directory (``<repo>/build/repro_torch`` unless ``REPRO_TORCH_BUILD_DIR``
says otherwise). The hash is of the source, so an edited source is rebuilt
on its next use. Libraries are loaded with ``ctypes``; pointers and the
stream are passed as ``ctypes.c_void_p``, and every C entry returns
``cudaGetLastError()`` for the wrapper to check.

``launch_counts`` counts launches per kernel: each wrapper adds one where
it launches its kernel, and nowhere else.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("overlap", "entropy_features")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last reset
launch_counts: "collections.Counter[str]" = collections.Counter()
#: source name -> nvcc's stderr (the ``-Xptxas -v`` register/smem report)
build_log: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    launch_counts.clear()


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
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
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
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        stdout, stderr = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_log[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, lib)
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
