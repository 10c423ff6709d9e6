"""The port's ``CheckpointManager`` against ``repro``'s.

The same tree goes through both managers: nested dicts, a tuple, an int32
scalar, float32 and bfloat16 leaves (a ``NamedTuple`` with a ``None``
field in the training-state case). ``measure`` is made deterministic in
both packages (each codec's true ratio on the sample, a fixed
decompression speed: the truth-mode timing would let the codec choice
flip from run to run). Checks:

* identical leaf names (``jax.tree_util.keystr``) and order, shard keys,
  stored bytes, sha256, tiers and codecs, manifests and the deterministic
  meter fields, with shards small enough that leaves span several;
* over four saves the lifecycle and retention give identical tiers and
  keep the same steps; under GCS's prices ten saves leave the older
  checkpoints on cooler tiers, identically (under Azure's, at the default
  120 s SLA, the lifecycle moves nothing in either package);
* a crash mid-save (shards without a manifest) falls back to the last
  manifest, in a fresh manager that scans the store;
* bfloat16 round-trips bit-exact, and either package restores the
  other's checkpoint;
* a training step from a state restored on the CPU equals, bit for bit,
  the same step from the live state.
"""

import hashlib
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from repro.checkpoint import manager as jman
from repro.storage import codecs as jcodecs
from repro.storage.store import TieredStore as JStore
from repro_torch.checkpoint import manager as tman
from repro_torch.configs.registry import get_config as t_config
from repro_torch.storage import codecs as tcodecs
from repro_torch.storage.store import TieredStore as TStore
from repro_torch.training import train_step as tts

#: decompression seconds per GB, fixed per codec (see the module docstring)
DSPEED = {"zlib-1": 2.0, "zstd-3": 1.0, "lzma-1": 12.0}
FIELDS = ("storage_cents", "read_cents", "write_cents", "penalty_cents",
          "egress_cents", "ttfb_seconds", "n_reads", "n_writes")


def _det(codecs_mod):
    def measure(codec, raw, repeats=1):
        comp = codec.compress(raw)
        return codecs_mod.CodecMeasurement(
            ratio=len(raw) / max(len(comp), 1), compress_sec=0.0,
            decompress_sec_per_gb=DSPEED.get(codec.name, 0.0))
    return measure


@pytest.fixture
def det(monkeypatch):
    """Deterministic ``measure`` in both managers; shards of 16 KiB with
    4 KiB samples, so the small test leaves span several shards; and one
    manifest timestamp, so both stores bill manifests of the same size."""
    for mod, codecs in ((jman, jcodecs), (tman, tcodecs)):
        monkeypatch.setattr(mod, "measure", _det(codecs))
        monkeypatch.setattr(mod, "SHARD_BYTES", 16 << 10)
        monkeypatch.setattr(mod, "SAMPLE_BYTES", 4 << 10)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: 1.7e9))


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((96, 64)) * 0.02).astype(np.float32),
            "emb": rng.standard_normal((40, 128)).astype(np.float32),
            "z": np.zeros((3000,), np.float32),
            "s0": rng.standard_normal((2, 16, 16)).astype(np.float32)}


def _trees(seed):
    """``(jax tree, torch tree)`` of the same values."""
    a = _arrays(seed)
    jt = {"params": {"w": jnp.asarray(a["w"]),
                     "emb": jnp.asarray(a["emb"]).astype(jnp.bfloat16),
                     "zeros": jnp.asarray(a["z"])},
          "stages": (jnp.asarray(a["s0"]),),
          "step": jnp.asarray(3, jnp.int32)}
    tt = {"params": {"w": torch.as_tensor(a["w"]),
                     "emb": torch.as_tensor(a["emb"]).to(torch.bfloat16),
                     "zeros": torch.as_tensor(a["z"])},
          "stages": (torch.as_tensor(a["s0"]),),
          "step": torch.tensor(3, dtype=torch.int32)}
    # jax's bfloat16 cast rounds as torch's does
    assert np.asarray(jt["params"]["emb"]).view(np.uint16).tobytes() == \
        tt["params"]["emb"].view(torch.int16).numpy().tobytes()
    return jt, tt


def _managers(**kw):
    js, ts_ = JStore(), TStore()
    return (js, jman.CheckpointManager(js, **kw)), \
        (ts_, tman.CheckpointManager(ts_, device="cpu", **kw))


def _objs(store):
    return {k: (o.payload, o.tier, o.codec, o.stored_gb)
            for k, o in store._objs.items() if not k.endswith("MANIFEST")}


def _manifest(mgr, step):
    return json.loads(json.dumps(mgr._manifests[step]))


def _bits(t):
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def test_leaf_names_and_order_are_jax_keystr():
    from repro.training.optimizer import AdamWState as JState
    from repro_torch.training.optimizer import AdamWState as TState
    jt, tt = _trees(0)
    jt["opt"] = JState(step=jt["step"], master={"b": jt["stages"][0],
                                                "a": jt["params"]["w"]},
                       m=(), v=[jt["step"]], err=None)
    tt["opt"] = TState(step=tt["step"], master={"b": tt["stages"][0],
                                                "a": tt["params"]["w"]},
                       m=(), v=[tt["step"]], err=None)
    jp, tp = jman._leaf_paths(jt), tman._leaf_paths(tt)
    assert [p for p, _ in tp] == [p for p, _ in jp]
    assert "['opt'].master['a']" in [p for p, _ in tp]
    for (_, a), (_, b) in zip(jp, tp):
        raw, shape, dt = tman._leaf_bytes(b)
        assert raw == np.asarray(a).tobytes()
        assert (shape, dt) == (list(np.asarray(a).shape),
                               str(np.asarray(a).dtype))


def test_save_matches_repro_shard_by_shard(det):
    (js, jm), (ts_, tm) = _managers()
    jt, tt = _trees(1)
    jm.save(100, jt, blocking=True)
    tm.save(100, tt, blocking=True)
    assert _manifest(tm, 100) == _manifest(jm, 100)
    shards = tm._manifests[100]["shards"]
    assert len({s["leaf_path"] for s in shards}) == 5 < len(shards)
    assert len({s["codec"] for s in shards}) > 1
    assert _objs(ts_) == _objs(js)
    assert {f: getattr(ts_.meter, f) for f in FIELDS} == \
        {f: getattr(js.meter, f) for f in FIELDS}
    for s in shards:
        assert hashlib.sha256(ts_.get(s["key"])).hexdigest() == s["sha256"]


def test_default_shard_size_and_real_measure_restore():
    """At the default 4 MiB shards and the real (timed) ``measure``: the
    tree comes back bit for bit, each leaf in its saved dtype."""
    store = TStore()
    mgr = tman.CheckpointManager(store, device="cpu")
    _, tt = _trees(2)
    mgr.save(7, tt, blocking=True)
    out, step = mgr.restore(tt, device="cpu")
    assert step == 7
    for (p, a), (q, b) in zip(tman._leaf_paths(tt), tman._leaf_paths(out)):
        assert p == q and a.dtype == b.dtype and a.shape == b.shape
        assert _bits(a) == _bits(b)
    assert isinstance(out["stages"], tuple)


def test_lifecycle_and_retention_match_repro(det):
    (js, jm), (ts_, tm) = _managers(keep=2)
    for s in range(4):
        jt, tt = _trees(10 + s)
        jm.save(s, jt, blocking=True)
        tm.save(s, tt, blocking=True)
        assert sorted(tm._manifests) == sorted(jm._manifests)
        assert _objs(ts_) == _objs(js)
        for k in tm._manifests:
            assert _manifest(tm, k) == _manifest(jm, k)
    assert sorted(tm._manifests) == [2, 3]
    assert {f: getattr(ts_.meter, f) for f in FIELDS} == \
        {f: getattr(js.meter, f) for f in FIELDS}


def _gcp(costs):
    return costs.multi_cloud_table([costs.gcp_gcs_provider()])


def test_lifecycle_moves_older_checkpoints_cooler(det):
    """Under Azure's prices and the default 120 s SLA the lifecycle never
    moves a shard (Archive's first byte takes hours; Cool is cheapest at
    every restore rate up to 4), in either package. Under GCS's, a
    checkpoint leaves Standard for Nearline once its restore rate
    ``4 exp(-age / 5)`` falls near 1: older checkpoints sit cooler, in
    both packages alike."""
    from repro.core import costs as jcosts
    from repro_torch.core import costs as tcosts
    js, ts_ = JStore(_gcp(jcosts)), TStore(_gcp(tcosts))
    jm = jman.CheckpointManager(js, keep=12)
    tm = tman.CheckpointManager(ts_, keep=12, device="cpu")
    for s in range(10):
        jt, tt = _trees(20)
        jm.save(s, jt, blocking=True)
        tm.save(s, tt, blocking=True)
        assert _objs(ts_) == _objs(js)
    mean = [np.mean([ts_.tier_of(m["key"])
                     for m in tm._manifests[s]["shards"]]) for s in range(10)]
    assert all(a >= b for a, b in zip(mean, mean[1:]))
    assert mean[0] > mean[-1]
    out, _ = tm.restore(tt, step=0, device="cpu")
    assert _bits(out["params"]["w"]) == _bits(tt["params"]["w"])
    (_, _), (az, am) = _managers(keep=12)
    for s in range(10):
        am.save(s, tt, blocking=True)
    assert len({az.tier_of(k) for k in az.keys()
                if not k.endswith("MANIFEST")}) == 1


def test_async_save_latest_and_crash_fall_back(det):
    store = TStore()
    mgr = tman.CheckpointManager(store, device="cpu")
    _, tt = _trees(3)
    w10 = tt["params"]["w"].clone()
    mgr.save(10, tt)
    tt["params"]["w"].add_(1.0)       # in place, after save() returned
    mgr.save(20, tt)
    mgr.wait()
    assert mgr.latest_step() == 20
    out, _ = mgr.restore(tt, step=10, device="cpu")
    assert _bits(out["params"]["w"]) == _bits(w10)
    # a crash mid-save: step 30's shards written, its manifest never
    store.put("ckpt/30/00000", b"garbage", tier=0)
    fresh = tman.CheckpointManager(store, device="cpu")
    assert fresh.latest_step() == 20
    out, step = fresh.restore(tt, device="cpu")
    assert step == 20
    assert _bits(out["params"]["w"]) == _bits(tt["params"]["w"])


def test_bfloat16_round_trips_and_packages_read_each_other(det):
    (js, jm), (ts_, tm) = _managers()
    jt, tt = _trees(4)
    jm.save(5, jt, blocking=True)
    tm.save(6, tt, blocking=True)
    got, step = tman.CheckpointManager(js, device="cpu").restore(
        tt, device="cpu")
    assert step == 5
    want, _ = tm.restore(tt, device="cpu")
    assert got["params"]["emb"].dtype == torch.bfloat16
    for (_, a), (_, b), (_, c) in zip(tman._leaf_paths(got),
                                      tman._leaf_paths(want),
                                      tman._leaf_paths(tt)):
        assert _bits(a) == _bits(b) == _bits(c)
    back, _ = jman.CheckpointManager(ts_).restore(jt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_restore_refuses_what_it_cannot_do(det):
    store = TStore()
    mgr = tman.CheckpointManager(store, device="cpu")
    _, tt = _trees(5)
    with pytest.raises(FileNotFoundError):
        mgr.restore(tt, device="cpu")
    mgr.save(1, tt, blocking=True)
    with pytest.raises(ValueError, match="mesh and shardings go together"):
        mgr.restore(tt, device="cpu", mesh=object())
    key = mgr._manifests[1]["shards"][0]["key"]
    o = store._objs[key]
    store.replace(key, b"x" + tcodecs.codec_by_name(o.codec).decompress(
        o.payload)[1:], o.tier, o.codec)
    with pytest.raises(IOError, match="corrupt shard"):
        mgr.restore(tt, device="cpu")
    mgr.delete(1)
    assert store.keys() == [] or not any(k.startswith("ckpt/1/")
                                         for k in store.keys())
    assert mgr.latest_step() is None


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        tman.CheckpointManager(TStore())


def test_step_from_restored_state_is_bit_identical():
    cfg = t_config("zamba2-2.7b", smoke=True)
    tcfg = tts.TrainConfig(remat=False, compressed_grads=True)
    state = tts.init_train_state(torch.Generator().manual_seed(0), cfg,
                                 tcfg, device="cpu")
    step = tts.make_train_step(cfg, tcfg)
    rng = np.random.default_rng(0)

    def batch():
        tok = rng.integers(0, cfg.vocab_size, (2, 17))
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    state, _ = step(state, batch())           # err now holds a residual
    mgr = tman.CheckpointManager(TStore(), device="cpu")
    mgr.save(1, state, blocking=True)
    restored, _ = mgr.restore(state, device="cpu")
    assert restored["opt"].err is not None
    b = batch()
    live, m_live = step(state, b)
    again, m_again = step(restored, b)
    assert float(m_live["loss"]) == float(m_again["loss"])
    la, lb = tman._leaf_paths(live), tman._leaf_paths(again)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, a), (_, c) in zip(la, lb):
        assert a.dtype == c.dtype and _bits(a) == _bits(c), p
