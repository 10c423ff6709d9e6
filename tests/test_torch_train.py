"""The training slice of the PyTorch port, held against ``repro``.

On smoke-size configs in float32 with ``repro``'s weights carried over by
``convert.train_state_from_arrays``:

* the loss (rel 1e-5) and every gradient (normwise, ``||t - j|| / ||j||``,
  1e-4) against ``jax.value_and_grad(repro...loss_fn)``, for zamba2 (Mamba2
  and the shared attention block) and gemma2 (local attention, softcaps,
  post-norms); remat on and off give the same gradients;
* three train steps, with the int8 error-feedback mean off and on and
  with 1 and 2 microbatches, against ``repro``'s jitted ``train_step``
  (compressed on a 1x1 mesh), per step:
  - the loss within rel 1e-5;
  - uncompressed, the moments normwise within 1e-4 (m) and 2e-4 (v):
    they are linear and quadratic in the gradients, which agree to 1e-4
    (A_log's, a sum with cancellation, to about 1e-5; most leaves to a few
    1e-6);
  - compressed, m and v within 5e-3 and the residual err identical (abs
    1e-6) at 98% of its elements or more. A gradient that differs in its
    last bits can land on the other side of a rounding boundary of the
    int8 grid, which moves that element of the dequantised gradient by a
    whole quantisation step (max|block| / 127) and its residual by the
    same: about 0.1-1% of the elements here. The exact arithmetic of the
    compressed mean is held at 1e-6 on equal inputs in
    ``test_torch_quant_pack.py``;
  - the update ``master_new - master_old`` normwise within 1e-2. At step 1
    the update of an element is ``lr * g / (|g| + eps)``, eps 1e-8, so a
    gradient element of order 1e-8 that differs in its last bits moves
    its update by a visible fraction of ``lr`` (measured up to 5.5e-3 on
    the first step, 7e-4 after).
  These steps run without the global-norm clip: under ``jit`` the JAX
  package's float32 global norm of the smoke model's gradients is 1.9e-3
  off its float64 value (14.4705 against 14.4979), which would scale every
  moment by that much; the port's is within 1e-6. The clip itself is held
  against ``repro``'s ``apply_updates`` on gradients small enough for
  both float32 norms to be exact to 1e-6;
* the data path: ``write_token_shards`` and ``TieredDataLoader`` give the
  same batches and the same metered bill as ``repro``'s, with the
  straggler hedge out of reach and with its backup read forced;
* the launcher runs on the CPU and prints finite losses; with
  ``--ckpt-every`` it checkpoints and bills the store, and ``--resume``
  with no checkpoint starts at step 0, as the JAX launcher does.
"""

import functools
import math
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread, train_state_arrays  # noqa: F401

from repro.configs.registry import get_config as j_config
from repro.data import loader as jloader
from repro.distributed import ctx
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as jtr
from repro.storage.store import TieredStore as JStore
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import convert
from repro_torch.configs.registry import get_config as t_config
from repro_torch.data import loader as tloader
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttr
from repro_torch.storage.store import TieredStore as TStore
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

ROOT = Path(__file__).resolve().parents[1]


def _paths(tree, prefix=""):
    """{path: numpy array} of a tree of dicts and tuples (jax or torch)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy().copy()}
    return {prefix: np.asarray(tree, np.float32)}


def _normwise(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_trees(t_tree, j_tree, tol, what):
    t, j = _paths(t_tree), _paths(j_tree)
    assert sorted(t) == sorted(j), what
    worst = max((_normwise(t[k], j[k]), k) for k in j)
    assert worst[0] <= tol, f"{what}: {worst[1]} normwise {worst[0]:.3e}"


def _batch(seed, cfg, B=4, S=16):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _states(arch, tcfg_j, tcfg_t):
    cfg = j_config(arch, smoke=True)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), cfg, tcfg_j)
    tstate = convert.train_state_from_arrays(
        train_state_arrays(jstate), t_config(arch, smoke=True), device="cpu")
    return cfg, t_config(arch, smoke=True), jstate, tstate


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma2-9b"])
def test_loss_and_grads_match_jax(arch):
    cfg, tcfg, jstate, tstate = _states(arch, jts.TrainConfig(),
                                        tts.TrainConfig())
    batch = _batch(1, cfg)
    # one label masked out: the mean runs over labels >= 0 only
    batch["labels"][0, 3] = -1
    jl, jg = jax.jit(jax.value_and_grad(functools.partial(
        jtr.loss_fn, cfg=cfg)))(jstate["params"],
                                {k: jnp.asarray(v) for k, v in batch.items()})
    for remat in (True, False):
        tl, tg = tts._value_and_grad(tstate["params"], tts._on_device(
            batch, torch.device("cpu")), tcfg, remat)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
        _assert_trees(tg, jg, 1e-4, f"{arch} grads (remat {remat})")
        if remat:
            g_remat = _paths(tg)
    g_plain = _paths(tg)
    for k, v in g_remat.items():
        assert _normwise(v, g_plain[k]) <= 1e-6, k


def _zoo_batch(seed, cfg, B=2, S=12):
    """Tokens and labels, plus vision's patch embeddings ('context') or
    whisper's frames ('frames', encoded by the train step's loss)."""
    batch = _batch(seed, cfg, B, S)
    rng = np.random.default_rng(seed + 100)
    if cfg.cross_context:
        batch["context"] = rng.standard_normal(
            (B, cfg.cross_context, cfg.d_model)).astype(np.float32)
    if cfg.encoder_stages is not None:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_context, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "llama4-scout-17b-a16e",
                                  "llama-3.2-vision-90b", "whisper-small"])
def test_loss_and_grads_match_jax_with_moe_mla_and_context(arch):
    """MLA and MoE blocks (deepseek, llama4), cross-attention into patch
    embeddings (vision) and the encoder (whisper's frames encoded inside
    the loss), against ``jax.value_and_grad`` of ``repro``'s train-step
    loss: the loss within rel 1e-5 and every gradient, the router's and
    the encoder's included, normwise within 1e-4."""
    cfg, tcfg, jstate, tstate = _states(arch, jts.TrainConfig(),
                                        tts.TrainConfig())
    batch = _zoo_batch(2, cfg)
    jl, jg = jax.jit(jax.value_and_grad(functools.partial(
        jts._loss, cfg=cfg)))(jstate["params"],
                              {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = tts._value_and_grad(tstate["params"], tts._on_device(
        batch, torch.device("cpu")), tcfg, True)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _assert_trees(tg, jg, 1e-4, f"{arch} grads")
    if cfg.encoder_stages is not None:
        assert float(np.abs(_paths(tg["encoder"])["/final_norm"]).max()) > 0


def test_loss_fn_takes_aux_weight_and_ignores_it():
    """As in repro, ``loss_fn`` takes ``aux_weight`` and adds no MoE
    load-balancing term: the loss is the same at any weight."""
    cfg, tcfg, _, tstate = _states("llama4-scout-17b-a16e",
                                   jts.TrainConfig(), tts.TrainConfig())
    batch = tts._on_device(_batch(3, cfg), torch.device("cpu"))
    losses = {w: float(ttr.loss_fn(tstate["params"], batch, tcfg,
                                   aux_weight=w)) for w in (0.0, 0.01, 10.0)}
    assert len(set(losses.values())) == 1


@pytest.mark.parametrize("compressed,microbatches", [
    (False, 1), (True, 1), (False, 2), (True, 2)])
def test_three_train_steps_match_jax(compressed, microbatches):
    arch = "zamba2-2.7b"
    kw = dict(compressed_grads=compressed, microbatches=microbatches)
    # no clip (see the module docstring); warmup and decay as by default
    kw_j = dict(kw, adamw=jopt.AdamWConfig(grad_clip=math.inf))
    kw_t = dict(kw, adamw=topt.AdamWConfig(grad_clip=math.inf))
    cfg, tcfg, jstate, tstate = _states(arch, jts.TrainConfig(**kw_j),
                                        tts.TrainConfig(**kw_t))
    mesh = make_test_mesh(1, 1)
    jstep = jax.jit(functools.partial(jts.train_step, cfg=cfg,
                                      tcfg=jts.TrainConfig(**kw_j), mesh=mesh))
    tstep = tts.make_train_step(tcfg, tts.TrainConfig(**kw_t))
    for i in range(3):
        batch = _batch(10 + i, cfg)
        old, old_j = _paths(tstate["opt"].master), \
            _paths(jstate["opt"].master)
        with ctx.activate(mesh):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        what = f"step {i + 1} ({kw})"
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5), what
        assert int(tm["step"]) == int(jm["step"]) == i + 1
        tol_m, tol_v = (5e-3, 5e-3) if compressed else (1e-4, 2e-4)
        _assert_trees(tstate["opt"].m, jstate["opt"].m, tol_m, f"m, {what}")
        _assert_trees(tstate["opt"].v, jstate["opt"].v, tol_v, f"v, {what}")
        new_t, new_j = _paths(tstate["opt"].master), \
            _paths(jstate["opt"].master)
        worst = max(_normwise(new_t[k] - old[k], new_j[k] - old_j[k])
                    for k in new_j)
        assert worst <= 1e-2, f"update, {what}: {worst:.3e}"
        # the parameters are the master weights in the compute dtype
        _assert_trees(tstate["params"], tstate["opt"].master, 0.0,
                      f"params, {what}")
        if compressed:
            et, ej = _paths(tstate["opt"].err), _paths(jstate["opt"].err)
            same = sum(int((np.abs(et[k] - ej[k]) <= 1e-6).sum()) for k in ej)
            n = sum(v.size for v in ej.values())
            assert same >= 0.98 * n, f"err, {what}: {same} of {n} equal"
        else:
            assert tstate["opt"].err is None and jstate["opt"].err is None


def test_global_norm_clip_matches_jax():
    """The default AdamW (clip 1.0 binding, warmup, decay) for two steps
    on gradients of a few thousand values, where JAX's float32 norm and
    the port's agree to 1e-6, against ``repro``'s ``apply_updates``; and
    the port's global norm of the smoke model's gradients within 1e-6 of
    the float64 norm."""
    rng = np.random.default_rng(5)
    arr = lambda shp, s: (rng.standard_normal(shp) * s).astype(np.float32)
    params = {"w": arr((8, 256), 0.1), "b": arr((37,), 0.1),
              "k": {"c": arr((3, 5, 7), 0.1)}}
    jp = jax.tree.map(jnp.asarray, params)
    tp = ttr.tree_map(torch.as_tensor, params)
    jst, tst = jopt.init_state(jp, jopt.AdamWConfig()), \
        topt.init_state(tp, topt.AdamWConfig())
    for _ in range(2):
        g = {"w": arr((8, 256), 0.5), "b": arr((37,), 2.0),
             "k": {"c": arr((3, 5, 7), 1.0)}}
        jp, jst = jopt.apply_updates(jst, jax.tree.map(jnp.asarray, g),
                                     jopt.AdamWConfig(), jnp.float32)
        tst = topt.apply_updates(tst, ttr.tree_map(torch.as_tensor, g),
                                 topt.AdamWConfig(), tp, torch.float32)
        for a, b, what in ((tst.m, jst.m, "m"), (tst.v, jst.v, "v"),
                           (tp, jp, "params")):
            _assert_trees(a, b, 1e-6, what)
    assert _normwise(_paths(tst.master)["/w"] - params["w"],
                     _paths(jst.master)["/w"] - params["w"]) <= 1e-5
    assert float(tst.step) == 2
    cfg = t_config("zamba2-2.7b", smoke=True)
    p = ttr.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, grads = tts._value_and_grad(p, tts._on_device(
        _batch(10, cfg), torch.device("cpu")), cfg, False)
    exact = math.sqrt(sum(float(np.vdot(g.double().numpy().ravel(),
                                        g.double().numpy().ravel()))
                          for g in ttr.tree_leaves(grads)))
    got = float(topt.global_norm(ttr.tree_leaves(grads)))
    assert got == pytest.approx(exact, rel=1e-6)


#: a straggler budget no honest fetch reaches: the speculative backup read
#: (a second ``store.get``) would otherwise fire on host load alone and
#: land in one package's meter and not the other's
NO_HEDGE = dict(straggler_factor=1e9, fetch_timeout_s=600.0)


def test_token_shards_and_loader_match_jax():
    """The same shards, the same batches in the same order, and the same
    metered bill (cents, reads, writes, latency) as ``repro``'s. The
    decompression compute is wall-clock time in both stores, so it is
    left out of the comparison. Both loaders run with the straggler hedge
    out of reach, so each shard is read exactly once."""
    js, ts_ = JStore(), TStore()
    jk = jloader.write_token_shards(js, n_shards=6, rows=8, seq=16,
                                    vocab=500, seed=3)
    tk = tloader.write_token_shards(ts_, n_shards=6, rows=8, seq=16,
                                    vocab=500, seed=3)
    assert jk == tk and js.keys() == ts_.keys()
    for epoch in (0, 1):
        jl = jloader.TieredDataLoader(js, jk, batch=4, seq=16, **NO_HEDGE)
        tl = tloader.TieredDataLoader(ts_, tk, batch=4, seq=16, **NO_HEDGE)
        jb, tb = list(jl.batches(epoch=epoch)), list(tl.batches(epoch=epoch))
        assert jl.stats.speculative_retries == 0
        assert tl.stats.speculative_retries == 0
        assert len(jb) == len(tb) == 12
        for a, b in zip(jb, tb):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
    for store in (js, ts_):
        store.advance_months(1.5)
        store.change_tier(jk[0], 2)
    exact = ("storage_cents", "read_cents", "write_cents", "penalty_cents",
             "egress_cents", "ttfb_seconds", "n_reads", "n_writes")
    jm, tm = js.meter.as_dict(), ts_.meter.as_dict()
    assert {k: jm[k] for k in exact} == {k: tm[k] for k in exact}
    assert tm["n_reads"] == 2 * 6 and tm["storage_cents"] > 0


def _backup_first_loader(loader_mod, store, keys):
    """A loader whose primary replica (0) answers only after the backup
    (1) has: every fetch goes through the speculative retry, whatever the
    host's load. Returns the loader and a wait for the primaries' reads."""
    answered = {k: threading.Event() for k in keys}
    done = threading.Semaphore(0)

    def fetch(key, replica):
        if replica == 1:
            blob = store.get(key)
            answered[key].set()
            return blob
        try:
            assert answered[key].wait(60.0), f"no backup read of {key}"
            return store.get(key)
        finally:
            done.release()

    def primaries_done():
        for _ in keys:
            assert done.acquire(timeout=60.0), "a primary read never ended"

    loader = loader_mod.TieredDataLoader(
        store, keys, batch=4, seq=16, fetch_fn=fetch,
        straggler_factor=0.0, fetch_timeout_s=1.0)
    return loader, primaries_done


def test_loader_backup_read_matches_jax():
    """The straggler hedge forced in both packages: the same batches, one
    speculative retry per shard, and once every primary read has landed
    the same metered bill."""
    js, ts_ = JStore(), TStore()
    jk = jloader.write_token_shards(js, n_shards=6, rows=8, seq=16,
                                    vocab=500, seed=5)
    tk = tloader.write_token_shards(ts_, n_shards=6, rows=8, seq=16,
                                    vocab=500, seed=5)
    jl, j_done = _backup_first_loader(jloader, js, jk)
    tl, t_done = _backup_first_loader(tloader, ts_, tk)
    jb, tb = list(jl.batches(epoch=0)), list(tl.batches(epoch=0))
    assert len(jb) == len(tb) == 12
    for a, b in zip(jb, tb):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    assert jl.stats.speculative_retries == tl.stats.speculative_retries == 6
    j_done()
    t_done()
    exact = ("read_cents", "write_cents", "ttfb_seconds", "n_reads",
             "n_writes")
    jm, tm = js.meter.as_dict(), ts_.meter.as_dict()
    assert {k: jm[k] for k in exact} == {k: tm[k] for k in exact}
    assert tm["n_reads"] == 2 * 6


def test_train_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "zamba2-2.7b", "--smoke", "--steps", "4", "--batch", "4", "--seq",
         "64", "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    losses = [float(x) for x in re.findall(r"loss (\S+) ", out.stdout)]
    assert losses and all(math.isfinite(x) for x in losses), out.stdout
    assert "done at step 4 on cpu" in out.stdout


def _launch(*flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "zamba2-2.7b", "--smoke", "--batch", "4", "--seq", "64", "--device",
         "cpu", *flags], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)


def test_train_launcher_checkpoints_and_bills_storage():
    """``--ckpt-every 2 --steps 4``: two saves through the
    ``CheckpointManager``, then the store's bill, as the JAX launcher
    prints it."""
    out = _launch("--steps", "4", "--ckpt-every", "2")
    assert out.returncode == 0, out.stderr
    bill = re.search(r"^ckpt bill: (\{.*\})$", out.stdout, re.M)
    assert bill, out.stdout
    cents = {k: float(v) for k, v in
             re.findall(r"'(\w+)': (?:np\.float64\()?([-\d.e]+)",
                        bill.group(1))}
    assert cents["write_cents"] > 0 and cents["n_writes"] > 0, cents
    assert "done at step 4 on cpu" in out.stdout


def test_train_launcher_resume_without_checkpoint_starts_at_zero():
    """``--resume`` in a fresh process finds no checkpoint (the store is a
    new one in memory, as in the JAX launcher) and trains from step 0."""
    out = _launch("--steps", "2", "--resume")
    assert out.returncode == 0, out.stderr
    assert "done at step 2 on cpu" in out.stdout
    assert "ckpt bill" not in out.stdout


@pytest.mark.parametrize("flag", [["--model-mesh", "2"]])
def test_train_launcher_refuses_what_is_not_ported(flag, monkeypatch):
    """Tensor-parallel training is ported; what one process cannot run,
    two model ranks outside torchrun, is refused before any process group
    starts, naming the command that starts them."""
    monkeypatch.setattr(sys, "argv", ["train", "--smoke", "--device", "cpu",
                                      *flag])
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tlaunch.main()
