"""What the harness loads: no module whose top-level name is ``jax`` or
``repro`` (``repro_torch`` passes), and the reference's side none of the
program. Each check runs in a fresh interpreter. Also the entry point's
refusals: no card, and no program beside the benchmark."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ENV = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")

LOADED = """
import json, sys
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def top_level_after(body: str):
    out = subprocess.run([sys.executable, "-c", LOADED.format(body=body)],
                         env=ENV, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_side_imports_nothing_of_the_program():
    loaded = top_level_after(
        "from perfbench import reference, weights, traffic, work, modelcfg")
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_a_run_loads_no_jax_and_no_jax_package():
    body = """
import time
from pathlib import Path
from perfbench import harness, bench as bn
data = Path("perfbench/tests/data")
b = bn.load_json(data / "bench.json")
b["end_to_end"] = [m for m in bn.load_bench()["end_to_end"]
                   if m["name"] == "setup_s"]
b["per_layer"] = []
for cell in ("mamba2-smoke-train", "mla-moe-smoke-prefill"):
    harness.run(cell, 5, 0.1, False, device="cpu", t_start=time.perf_counter(),
                bench=b, root=data, data=data)
"""
    loaded = top_level_after(body)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}
    from perfbench import harness
    assert harness.forbidden_modules(["repro_torch.models", "reprox",
                                      "jax.numpy", "repro"]) == ["jax", "repro"]


def run_py(cwd: Path):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "mamba2-780m.train-s2048",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
