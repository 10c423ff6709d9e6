"""``repro_torch.launch.shapes`` held against ``repro.launch.shapes``: the
shape grid, ``applicable``, and ``input_specs``'s meta-device tensors
against JAX's ``ShapeDtypeStruct``s (every leaf's path, shape and dtype),
for every arch and every shape of the grid. Nothing is allocated: the
port's caches are on the meta device, JAX's come from ``eval_shape``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import arch_names
from repro.configs.registry import get_config as j_config
from repro.launch import shapes as jshapes
from repro_torch.configs.registry import get_config as t_config
from repro_torch.launch import shapes as tshapes

DTYPES = {torch.int32: "int32", torch.bfloat16: "bfloat16",
          torch.float32: "float32"}


def _specs(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of dicts, tuples and leaves;
    None (a cross block's cache) is no leaf, as in a JAX pytree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_specs(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", prefix
        return {prefix: (tuple(tree.shape), DTYPES[tree.dtype])}
    return {prefix: (tuple(tree.shape), np.dtype(tree.dtype).name)}


def test_shape_grid_matches_jax():
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", arch_names())
@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_input_specs_match_jax(arch, shape):
    jcfg, tcfg = j_config(arch), t_config(arch)
    assert tshapes.applicable(tcfg, shape) == jshapes.applicable(jcfg, shape)
    want = _specs(jshapes.input_specs(jcfg, shape))
    got = _specs(tshapes.input_specs(tcfg, shape))
    assert got == want


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small"])
def test_context_shapes_for_the_cross_attention_models(arch):
    """The two shapes chip_smoke.py's zoo phase takes from here: 4,100
    patch embeddings for vision, 1,500 frames for whisper."""
    specs = tshapes.input_specs(t_config(arch), "prefill_32k")
    want = {"llama-3.2-vision-90b": 4100, "whisper-small": 1500}[arch]
    assert specs["context"].shape[1] == want
    assert specs["context"].dtype == torch.bfloat16
