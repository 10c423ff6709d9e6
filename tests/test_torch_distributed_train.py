"""The port's data-parallel training over gloo ranks, against the JAX
package's train step on a mesh of host devices, and the launchers' mesh
flags.

The reference's step runs once per case in one JAX subprocess (8 host
devices, ``make_test_mesh(data, 1)``, the shardings of
``tests/test_distributed.py``); the port's as ``data`` gloo ranks that
meet through a file in the test's directory. The comparison uses
``tests/test_distributed.py``'s tolerances (loss rtol 2e-4, parameters
within 5e-3), without the global-norm clip (ROADMAP's hazards: JAX's
jitted float32 global norm is off by 1.9e-3 on a smoke model). The
pytest process starts no process group.
"""

import math
import pickle
import sys

import numpy as np
import pytest
from _torch_dist import run_jax, run_ranks

from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

CASES = [(2, False), (2, True), (4, False), (4, True)]
ARCH, BATCH, SEQ, STEPS = "qwen3-4b", 8, 17, 2

JAX_TRAIN = """
import functools, math, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.registry import get_config
from repro.distributed import ctx
from repro.distributed.sharding import (batch_specs, param_specs, to_named,
                                        zero1_specs)
from repro.launch.mesh import make_test_mesh
from repro.training import optimizer as opt
from repro.training import train_step as ts

cfg = get_config("{arch}", smoke=True)
tok = jax.random.randint(jax.random.PRNGKey(1), ({batch}, {seq}), 0,
                         cfg.vocab_size)
labels = np.array(tok[:, 1:])
labels[:2, :6] = -1          # ranks hold different numbers of loss tokens
batch = {{"tokens": tok[:, :-1], "labels": jnp.asarray(labels)}}
f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
out = {{"batch": {{k: np.asarray(v) for k, v in batch.items()}}}}
for data, comp in {cases}:
    tcfg = ts.TrainConfig(remat=True, compressed_grads=comp,
                          adamw=opt.AdamWConfig(grad_clip=math.inf))
    state = ts.init_train_state(jax.random.PRNGKey(0), cfg, tcfg, tp=1)
    o = state["opt"]
    init = {{"params": f32(state["params"]),
            "opt": {{"step": int(o.step), "master": f32(o.master),
                    "m": f32(o.m), "v": f32(o.v), "err": None}}}}
    mesh = make_test_mesh(data=data, model=1)
    p_specs = param_specs(state["params"], cfg, 1)
    z = zero1_specs(p_specs, state["params"], "data", data)
    s_specs = {{"params": p_specs,
               "opt": opt.AdamWState(step=P(), master=z, m=z, v=z, err=None)}}
    losses = []
    fn = functools.partial(ts.train_step, cfg=cfg, tcfg=tcfg,
                           mesh=mesh if comp else None)
    with ctx.activate(mesh):
        for i in range({steps}):
            # the error-feedback residual joins the state after step 1
            s_specs["opt"] = s_specs["opt"]._replace(
                err=None if state["opt"].err is None else z)
            sh = (to_named(s_specs, mesh),
                  to_named(batch_specs(cfg, mesh), mesh))
            step = jax.jit(fn, in_shardings=sh)
            state, m = step(jax.device_put(state, sh[0]),
                            jax.device_put(batch, sh[1]))
            losses.append(float(m["loss"]))
    out[(data, comp)] = dict(init=init, losses=losses,
                             params=f32(state["params"]))
pickle.dump(out, open("{tmp}/train_ref.pkl", "wb"))
print("OK")
"""

PORT_TRAIN = """
import math, pickle
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.distributed import ctx
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

ref = pickle.load(open(TMP + "/train_ref.pkl", "rb"))
case = ({data}, {comp})
cfg = get_config("{arch}", smoke=True)
tcfg = ts.TrainConfig(remat=True, compressed_grads={comp},
                      adamw=opt.AdamWConfig(grad_clip=math.inf))
state = convert.train_state_from_arrays(ref[case]["init"], cfg, device="cpu")
mesh = make_test_mesh(data={data}, model=1)
step = ts.make_train_step(cfg, tcfg, mesh)
losses = []
for i in range({steps}):
    state, m = step(state, ref["batch"])
    losses.append(float(m["loss"]))
pickle.dump(dict(losses=losses, reduced=dict(ctx.reduced_on),
                 params=[t.float().numpy()
                         for t in tr.tree_leaves(state["params"])]),
            open(TMP + f"/train{{RANK}}.pkl", "wb"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_ref")
    run_jax(JAX_TRAIN.format(arch=ARCH, batch=BATCH, seq=SEQ, cases=CASES,
                             steps=STEPS, tmp=tmp))
    with open(tmp / "train_ref.pkl", "rb") as f:
        return tmp, pickle.load(f)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("data,comp", CASES)
def test_dp_train_step_matches_the_reference(reference, tmp_path, data, comp):
    """Data 2 and 4, model 1, with and without the int8 compressed mean:
    two steps of qwen3-4b (smoke) on a batch of 8 whose first two rows
    hold fewer loss tokens, every rank holding its rows. Each rank's
    losses and parameters are the reference mesh's (loss rtol 2e-4,
    parameters within 5e-3)."""
    ref_dir, ref = reference
    (tmp_path / "train_ref.pkl").write_bytes(
        (ref_dir / "train_ref.pkl").read_bytes())
    run_ranks(PORT_TRAIN.format(arch=ARCH, data=data, comp=comp,
                                steps=STEPS), data, tmp_path)
    want = ref[(data, comp)]
    want_p = _leaves(want["params"])
    for rank in range(data):
        with open(tmp_path / f"train{rank}.pkl", "rb") as f:
            got = pickle.load(f)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
        assert len(got["params"]) == len(want_p)
        worst = max(float(np.abs(a - b).max())
                    for a, b in zip(got["params"], want_p))
        assert worst < 5e-3, f"param divergence {worst}"
        # the gradient and the loss were summed over the data ranks (and
        # the token counts), once per step, plus the compressed mean
        assert got["reduced"]["cpu"] == STEPS * (3 if comp else 2)


LAUNCHER = """
import math
from repro_torch.configs.registry import get_config
from repro_torch.data.loader import TieredDataLoader, write_token_shards
from repro_torch.launch import train as lt
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer as tr
from repro_torch.storage.store import TieredStore
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

cfg = get_config("zamba2-2.7b", smoke=True)
tcfg = ts.TrainConfig(remat=False, adamw=opt.AdamWConfig(grad_clip=math.inf))
store = TieredStore()
shards = write_token_shards(store, n_shards=4, rows=8, seq=16,
                            vocab=cfg.vocab_size)
loader = TieredDataLoader(store, shards, batch=4, seq=16)
runs = {}
for name, mesh in (("one", None), ("dp", make_test_mesh(data=WORLD))):
    state = ts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                                device="cpu")
    res = lt.train(cfg, tcfg, state, loader, 3, mesh=mesh)
    runs[name] = (res.losses, [t.float().numpy()
                               for t in tr.tree_leaves(res.state["params"])])
(l1, p1), (l2, p2) = runs["one"], runs["dp"]
np.testing.assert_allclose(l2, l1, rtol=1e-5)
worst = max(float(np.abs(a - b).max()) for a, b in zip(p1, p2))
assert worst < 1e-5, worst
# the same loop tensor-parallel: each rank its shards of the same weights
mesh = make_test_mesh(data=1, model=WORLD)
state = ts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                            WORLD, mesh, device="cpu")
res = lt.train(cfg, tcfg, state, loader, 3, mesh=mesh)
np.testing.assert_allclose(res.losses, l1, rtol=1e-4)
print("OK", l2)
"""


def test_launcher_loop_is_data_parallel_over_two_ranks(tmp_path):
    """``launch.train.train`` (the launcher's loop) with a data-2 mesh over
    the tiered loader's batches: the losses and weights of three zamba2
    (smoke) steps equal the one-device loop's (rtol 1e-5), only rank 0
    prints a mesh run's progress (each rank prints its own one-device
    run's), and over a mesh whose model axis is 2 (tensor-parallel
    weights) the loop's losses are the one-device loop's within rtol
    1e-4."""
    outs = run_ranks(LAUNCHER, 2, tmp_path)
    assert all("OK" in o for o in outs)
    assert outs[0].count("step 3 loss") == 3
    assert outs[1].count("step 3 loss") == 1


@pytest.mark.parametrize("argv,err,match", [
    (["--model-mesh", "2"], ValueError, "torchrun --nproc-per-node 2"),
    (["--data-mesh", "0"], ValueError, "production 16 x 16"),
])
def test_train_cli_refuses_what_one_card_cannot_run(argv, err, match,
                                                    monkeypatch):
    """A mesh of two ranks outside torchrun (one process cannot be two
    tensor-parallel ranks) and the production mesh are refused before any
    process group starts."""
    monkeypatch.setattr(sys, "argv", ["train", "--arch", ARCH, "--smoke",
                                      "--device", "cpu", *argv])
    with pytest.raises(err, match=match):
        ttrain.main()


def test_serve_cli_refuses_the_production_mesh(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "zamba2-2.7b",
                                      "--smoke", "--device", "cpu",
                                      "--data-mesh", "0"])
    with pytest.raises(ValueError, match="one card"):
        tserve.main()


SERVE = """
from repro_torch.configs.registry import get_config
from repro_torch.distributed import ctx, sharding
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as tr
from repro_torch.serving import decode

cfg = get_config("zamba2-2.7b", smoke=True)
params = tr.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
prompts = torch.randint(0, cfg.vocab_size, (4, 8),
                        generator=torch.Generator().manual_seed(1))
mesh = make_test_mesh(data=1, model=WORLD)
one = serve(decode.make_decode_step(cfg), params,
            decode.init_cache(cfg, 4, 16, device="cpu"), prompts, 6)
ctx.reduced_on.clear()
cache = decode.init_cache(cfg, 4, 16, mesh=mesh, device="cpu")
kv = [c for st, sc in zip(cfg.stages, cache)
      for kind, c in zip(st.unit, sc) if kind == "shared_attn"]
assert kv and all(t.shape[2] == 16 // WORLD for c in kv for t in c)
mine = sharding.shard_tree(params, sharding.param_specs(params, cfg, WORLD),
                           mesh)
sharded = serve(decode.make_decode_step(cfg, mesh), mine, cache, prompts, 6)
assert torch.equal(sharded.tokens, one.tokens)
err = float((sharded.prompt_logits - one.prompt_logits).abs().max())
assert err < 1e-4, err
assert ctx.reduced_on["cpu"] > 0
print("OK", err)
"""


def test_serve_loop_over_a_sequence_sharded_cache(tmp_path):
    """The serve loop of ``launch.serve`` with ``--model-mesh 2``'s layout
    (each rank its shards of the weights and 8 of the 16 slots of the
    shared attention block's cache): the same greedy tokens as one device,
    and the prompt's last logits within 1e-4."""
    outs = run_ranks(SERVE, 2, tmp_path)
    assert all("OK" in o for o in outs)
