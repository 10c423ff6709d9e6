"""The port's benchmark: one run of one cell on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It makes the cell's weights and inputs
from ``--seed``, warms up (counted in ``setup_s``), measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints, as the last lines of standard error, each number
compared beside its limit, and as the last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.

It exits non-zero and prints no result where PyTorch sees no CUDA card or
fewer than the cell asks for, where the program (``src/repro_torch``) is
not in the checkout, or where JAX, flax or the JAX package is loaded once
the window has closed. Kernel builds and caches stay inside the checkout
(``build/``), at fixed paths.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fail(msg: str, code: int = 1) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import torch
    from perfbench import bench, harness
    try:
        chips = bench.workload(bench.load_bench(ROOT), args.workload)["chips"]
    except (OSError, KeyError) as e:
        return _fail(f"cannot find workload {args.workload!r}: {e}")
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: no card to run on",
                     2)
    if torch.cuda.device_count() < chips:
        return _fail(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} are visible", 2)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program is not in this checkout: {e}")

    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        return _fail(f"modules loaded that the port must not load: {found}",
                     3)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
