"""The port's dry-run arithmetic, meta-device sizes and sharding rules
against the JAX package's.

* ``launch.dryrun``: ``microbatches_for`` / ``serve_window`` /
  ``model_flops_estimate`` ``==`` the reference for the ten configs (full
  and reduced), every ``INPUT_SHAPES`` entry and the modes train /
  prefill / decode; the meta-device bytes of the parameters, the AdamW
  state and a decode cache ``==`` the bytes of the reference's
  ``jax.eval_shape`` of the same constructors, for the ten reduced
  configs.
* ``models.sharding``: every parameter's spec ``==`` ``tuple(spec)`` of
  the reference's ``param_shardings`` on an ``AbstractMesh`` of the same
  shape (the reference stacks a stage's layers on a leading axis its
  rules never shard: the port's per-layer spec is the rest), at mesh
  shapes (1, 1), (2, 2), (16, 16) and (2, 16, 16) with ``pod``, with and
  without FSDP, ``serve_attn_dh`` and ``expert_grid``; ``needs_fsdp`` at
  the reference's 8e9-byte budget, passed in; ``batch_spec``.

Importing ``repro.launch.dryrun`` appends a 512-device flag to
``XLA_FLAGS``; the flag is restored at once, before any jax backend here
could read it.
"""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.models import sharding as jshd
from repro.models import transformer as jtf
from repro.models.config import INPUT_SHAPES as J_SHAPES
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.models.config import INPUT_SHAPES

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ARCHS = registry.list_archs()
MESHES = {"1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
VARIANTS = [dict(fsdp=f, serve_attn_dh=a, expert_grid=e)
            for f in (False, True) for a in (False, True)
            for e in (False, True)]
#: The reference's per-device budget in ``needs_fsdp``: half a 16 GB chip.
REFERENCE_BUDGET = 8e9


def _configs(arch):
    return ((registry.get(arch), jreg.get(arch)),
            (registry.reduced(registry.get(arch)),
             jreg.reduced(jreg.get(arch))))


def test_input_shapes_are_the_references():
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for name, s in INPUT_SHAPES.items():
        j = J_SHAPES[name]
        assert (s.seq_len, s.global_batch, s.kind) == (
            j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_arithmetic_is_the_references(arch, shape):
    for cfg, jcfg in _configs(arch):
        s, js = INPUT_SHAPES[shape], J_SHAPES[shape]
        assert dryrun.serve_window(cfg, shape) == jdry.serve_window(jcfg,
                                                                    shape)
        for shards in (1, 2, 16, 32, 512):
            assert dryrun.microbatches_for(cfg, shards, s.global_batch) == \
                jdry.microbatches_for(jcfg, shards, js.global_batch)
        for mode in ("train", "prefill", "decode"):
            assert dryrun.model_flops_estimate(cfg, s, mode) == \
                jdry.model_flops_estimate(jcfg, js, mode)


def _jax_bytes(tree) -> int:
    return sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
               for leaf in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_sizes_are_the_reference_eval_shape(arch):
    """Parameters, the AdamW state and a windowed and a full decode cache
    (B = 2, T = 64) of the reduced config, allocated nowhere."""
    (_, _), (cfg, jcfg) = _configs(arch)
    params = dryrun.meta_params(cfg)
    assert all(t.device.type == "meta"
               for t in dryrun._tensors(params))
    jparams = jtf.abstract_params(jcfg)
    assert dryrun.nbytes(params) == _jax_bytes(jparams)
    opt = dryrun.meta_opt_state(cfg, params)
    jopt = jax.eval_shape(JAdamW(learning_rate=3e-4).init, jparams)
    assert dryrun.nbytes(opt) == _jax_bytes(jopt)
    for window in (0, 16):
        cache = tf.init_cache(cfg, 2, 64, window=window, device="meta")
        jcache = jax.eval_shape(functools.partial(
            jtf.init_cache, jcfg, 2, 64, window=window))
        assert dryrun.nbytes(cache) == _jax_bytes(jcache), window


def test_estimate_reports_every_field():
    rec = dryrun.estimate("qwen1.5-0.5b", "decode_32k")
    assert rec["param_dtype"] == "bfloat16"
    assert rec["param_bytes"] == dryrun.nbytes(dryrun.meta_params(
        dataclasses.replace(registry.get("qwen1.5-0.5b"),
                            param_dtype="bfloat16")))
    assert rec["model_flops"] == jdry.model_flops_estimate(
        jreg.get("qwen1.5-0.5b"), J_SHAPES["decode_32k"], "decode")
    assert rec["total_bytes"] == (rec["param_bytes"] + rec["cache_bytes"]
                                  + rec["input_bytes"])
    train = dryrun.estimate("qwen1.5-0.5b", "train_4k", data_shards=16)
    assert train["microbatches"] == jdry.microbatches_for(
        jreg.get("qwen1.5-0.5b"), 16, 256)
    assert train["optimizer_bytes"] == 2 * train["param_bytes"] + 4


@pytest.fixture
def fsdp_sizes():
    """``param_shardings`` records the mesh's axis sizes in the
    reference's module state; put it back after each test."""
    saved = dict(jshd._FSDP_SIZE)
    yield
    jshd._FSDP_SIZE.clear()
    jshd._FSDP_SIZE.update(saved)


def _key(path) -> tuple:
    return tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                 for p in path)


def _reference_specs(jcfg, mesh_shape, **variant) -> dict:
    """The reference's specs by the port's leaf paths: a stage's stacked
    leaf gives every layer it stacks its spec without the stacking axis,
    which must be unsharded."""
    mesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    tree = jshd.param_shardings(jcfg, jtf.abstract_params(jcfg), mesh,
                                **variant)
    first, offset = [], 0
    for group, repeats in jcfg.stages():
        first.append(offset)
        offset += len(group) * repeats
    out = {}
    for path, sharding in jax.tree_util.tree_leaves_with_path(tree):
        key, spec = _key(path), tuple(sharding.spec)
        if key[0] != "stages":
            out[key] = spec
            continue
        assert spec[0] is None, (key, spec)
        si, gi = int(key[1]), int(key[2])
        group, repeats = jcfg.stages()[si]
        for r in range(repeats):
            layer = first[si] + r * len(group) + gi
            out[("layers", str(layer)) + key[3:]] = spec[1:]
    return out


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat(sub, path + (str(name),)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, path + (str(i),)).items()}
    return {path: tree}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_references(arch, mesh, fsdp_sizes):
    (_, _), (cfg, jcfg) = _configs(arch)
    params = dryrun.meta_params(cfg)
    shape = MESHES[mesh]
    for variant in VARIANTS:
        got = _flat(shd.param_specs(cfg, params, shape, **variant))
        want = _reference_specs(jcfg, shape, **variant)
        assert got == want, variant


@pytest.mark.parametrize("arch", ARCHS)
def test_needs_fsdp_at_the_reference_budget(arch, fsdp_sizes):
    for cfg, jcfg in _configs(arch):
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, param_dtype=dtype)
            jc = dataclasses.replace(jcfg, param_dtype=dtype)
            for shape in MESHES.values():
                mesh = AbstractMesh(tuple(shape.values()), tuple(shape))
                for train in (False, True):
                    assert shd.needs_fsdp(c, shape, train,
                                          REFERENCE_BUDGET) == \
                        jshd.needs_fsdp(jc, mesh, train), (shape, train)


def test_needs_fsdp_takes_the_budget_it_is_given():
    cfg = registry.get("deepseek-67b")
    shape = MESHES["16x16"]
    assert shd.needs_fsdp(cfg, shape, True, 1e9)
    assert not shd.needs_fsdp(cfg, shape, True, 1e12)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_are_the_references(mesh):
    shape = MESHES[mesh]
    jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    assert shd.data_axes(shape) == jshd.data_axes(jmesh)
    for batch in (1, 2, 16, 32, 128, 256, 512):
        for rank, axis in ((1, 0), (2, 0), (3, 1)):
            assert shd.batch_spec(shape, batch, rank, axis) == tuple(
                jshd.batch_spec(jmesh, batch, rank, axis)), (batch, rank)
