"""Helpers for the port's distributed tests: gloo ranks and JAX references,
each in processes of their own.

The pytest process never starts a process group (a fake one included)
and never sets an environment variable. A test writes its inputs under
its ``tmp_path``; :func:`run_ranks` runs N processes that join one gloo
group through a ``file://`` rendezvous in that directory (no TCP port)
and write their results there; :func:`run_jax` runs the JAX package on 8
host devices in a subprocess, as ``tests/test_distributed.py`` does.
Every process has a timeout, and all of a call's ranks are killed when it
passes.
"""

import itertools
import os
import pathlib
import subprocess
import sys
import textwrap
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TESTS = str(ROOT / "tests")
_calls = itertools.count()


def _env(**extra):
    env = {"PYTHONPATH": SRC + os.pathsep + TESTS,
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    env.update(extra)
    return env


def run_py(code: str, *, timeout: int = 300, **env) -> str:
    """Run ``code`` in a fresh Python with ``env`` added; assert it exits
    0 and return its standard output."""
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=_env(**env), cwd=str(ROOT))
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    return res.stdout


def run_jax(code: str, devices: int = 8, timeout: int = 600) -> str:
    """The JAX package on ``devices`` host devices."""
    prog = ("import os\n"
            f"os.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={devices}'\n"
            + textwrap.dedent(code))
    return run_py(prog, timeout=timeout)


PRELUDE = """\
import sys
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD, TMP = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + sys.argv[4],
                        rank=RANK, world_size=WORLD)
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(code: str, world: int, tmp_path, timeout: int = 300):
    """Run ``code`` as ``world`` gloo ranks; the code sees ``RANK``,
    ``WORLD`` and ``TMP`` (``tmp_path`` as a string) and a started default
    group. Returns each rank's standard output; fails with every rank's
    output if one exits non-zero or the call outlasts ``timeout``."""
    tmp = pathlib.Path(tmp_path)
    n = next(_calls)
    script = tmp / f"ranks{n}.py"
    script.write_text(PRELUDE + textwrap.dedent(code) + EPILOGUE)
    rdzv = tmp / f"rdzv{n}"
    logs, procs = [], []
    for r in range(world):
        out = open(tmp / f"ranks{n}.{r}.log", "w+")
        logs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(r), str(world), str(tmp),
             str(rdzv)], stdout=out, stderr=subprocess.STDOUT, env=_env(),
            cwd=str(ROOT)))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        timed_out = any(p.poll() is None for p in procs)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out in logs:
        out.seek(0)
        texts.append(out.read())
        out.close()
    failed = timed_out or any(p.returncode != 0 for p in procs)
    assert not failed, ("timed out after %ds\n" % timeout if timed_out
                        else "") + "\n".join(
        f"--- rank {r} (exit {p.returncode}) ---\n{t}"
        for r, (p, t) in enumerate(zip(procs, texts)))
    return texts
