"""Compression codec registry for the tiered store and COMPREDICT.

A copy of ``repro.storage.codecs``. The paper evaluates gzip/snappy/lz4
(+bz2/zlib/lzma/...); the registry holds zlib (== gzip payload), lzma,
zstandard where it is installed, and a lossy int8 block codec (`quant8`).
Scheme index 0 is always 'none' (R=1, D=0) per the paper's convention.
"""

from __future__ import annotations

import dataclasses
import lzma
import time
import zlib
from typing import Callable, List

import numpy as np

try:
    import zstandard as zstd
    _HAVE_ZSTD = True
except ImportError:  # pragma: no cover
    _HAVE_ZSTD = False


@dataclasses.dataclass(frozen=True)
class Codec:
    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]
    lossy: bool = False


def _zstd_codec(level: int) -> Codec:
    c = zstd.ZstdCompressor(level=level)
    d = zstd.ZstdDecompressor()
    return Codec(f"zstd-{level}", c.compress, d.decompress)


def _quant8_compress(raw: bytes) -> bytes:
    """Lossy int8 block quantization, 256-element blocks.

    Interprets the payload as float32; 256-element blocks share one scale.
    Ratio ~= 3.9x on float data; decompression is memory-speed.
    """
    arr = np.frombuffer(raw, dtype=np.uint8)
    pad = (-arr.size) % 4
    f = np.frombuffer(np.concatenate([arr, np.zeros(pad, np.uint8)]).tobytes(),
                      dtype=np.float32)
    blocks = f.reshape(-1, 256) if f.size % 256 == 0 else None
    if blocks is None:
        bpad = (-f.size) % 256
        blocks = np.concatenate([f, np.zeros(bpad, np.float32)]).reshape(-1, 256)
    scale = np.maximum(np.abs(blocks).max(axis=1), 1e-12) / 127.0
    q = np.clip(np.round(blocks / scale[:, None]), -127, 127).astype(np.int8)
    header = np.array([f.size], np.int64).tobytes()
    return header + scale.astype(np.float32).tobytes() + q.tobytes()


def _quant8_decompress(payload: bytes) -> bytes:
    n = int(np.frombuffer(payload[:8], np.int64)[0])
    nblk = -(-n // 256)
    scale = np.frombuffer(payload[8:8 + 4 * nblk], np.float32)
    q = np.frombuffer(payload[8 + 4 * nblk:], np.int8).reshape(nblk, 256)
    f = (q.astype(np.float32) * scale[:, None]).reshape(-1)[:n]
    return f.tobytes()


def default_codecs() -> List[Codec]:
    codecs = [
        Codec("none", lambda b: b, lambda b: b),
        Codec("zlib-1", lambda b: zlib.compress(b, 1), zlib.decompress),
        Codec("zlib-6", lambda b: zlib.compress(b, 6), zlib.decompress),
    ]
    if _HAVE_ZSTD:
        codecs += [_zstd_codec(3), _zstd_codec(19)]
    codecs += [
        Codec("lzma-1", lambda b: lzma.compress(b, preset=1), lzma.decompress),
        Codec("quant8", _quant8_compress, _quant8_decompress, lossy=True),
    ]
    return codecs


def codec_by_name(name: str) -> Codec:
    for c in default_codecs():
        if c.name == name:
            return c
    raise KeyError(name)


# Scheme order follows the paper's evaluation set; index 0 must stay 'none'.
DEFAULT_SCHEME_PREFERENCE = ("none", "zlib-1", "zstd-3", "zstd-19", "lzma-1")


def available_schemes(
        preferred: tuple = DEFAULT_SCHEME_PREFERENCE) -> tuple:
    """``preferred`` filtered down to codecs importable in this environment.

    Lets pipeline defaults degrade gracefully when optional compressors
    (zstandard) are absent instead of raising ``KeyError`` at config time.
    """
    names = {c.name for c in default_codecs()}
    return tuple(s for s in preferred if s in names)


@dataclasses.dataclass
class CodecMeasurement:
    ratio: float            # R = raw / compressed  (>= lower is worse)
    compress_sec: float
    decompress_sec_per_gb: float


def measure(codec: Codec, raw: bytes, repeats: int = 1) -> CodecMeasurement:
    """Ground-truth (ratio, decompression speed) for COMPREDICT labels."""
    t0 = time.perf_counter()
    comp = codec.compress(raw)
    t1 = time.perf_counter()
    best = np.inf
    for _ in range(repeats):
        t2 = time.perf_counter()
        codec.decompress(comp)
        best = min(best, time.perf_counter() - t2)
    gb = max(len(raw), 1) / 1e9
    return CodecMeasurement(
        ratio=len(raw) / max(len(comp), 1),
        compress_sec=t1 - t0,
        decompress_sec_per_gb=(0.0 if codec.name == "none" else best / gb),
    )
