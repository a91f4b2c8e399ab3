#!/usr/bin/env python3
"""How far three float32 AdamW train steps of the JAX package and of the
PyTorch port lie from a float64 run of the same steps (CPU).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/train_step_bar.py

For each reduced config and micro-batch count of
``tests/test_torch_lm_train.py::test_train_step_matches_reference`` (the
same weights, batches, schedule and steps), prints the largest absolute
distance of the parameters, the first moments and the second moments
after the steps: the reference's float32 run from its float64 run, the
port's float32 run from the reference's float64 run, and the port's from
the reference's float32 run. The test's bar (TRAIN_ATOL) rests on the
first two.

The reference's float64 run replaces ``jnp.float32`` inside its model and
optimizer modules by float64 (its AdamW and its loss cast to float32 by
name) and gives its configs float64 parameters and activations; nothing
in ``src/repro/`` is edited. The port casts to float32 with ``.float()``
at the same points, so it has no float64 run: its float32 run is held to
the reference's float64 one instead.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import test_torch_lm_train as t   # noqa: E402
from repro.models import attention, layers, moe, ssm  # noqa: E402
from repro.models import transformer as jtf           # noqa: E402
from repro.optim import adamw as jadamw               # noqa: E402


class _Float64Numpy:
    """jax.numpy with float32 meaning float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _float64_reference(arch, microbatches):
    jcfg, _ = t._cfgs(arch)
    jcfg = dataclasses.replace(jcfg, param_dtype="float64",
                               activation_dtype="float64")
    modules = (attention, layers, moe, ssm, jtf, jadamw)
    saved = [m.jnp for m in modules]
    dtype_of = layers.dtype_of
    try:
        for m in modules:
            m.jnp = _Float64Numpy()
        for m in (attention, layers, moe, ssm, jtf):
            if hasattr(m, "dtype_of"):
                m.dtype_of = lambda name: jnp.float64
        opt = jadamw.AdamW(learning_rate=jadamw.warmup_cosine(
            t.TRAIN_LR, warmup=1, total=t.TRAIN_STEPS))
        step = jax.jit(jtf.make_train_step(jcfg, opt,
                                           microbatches=microbatches))
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), t._init(arch))
        state = opt.init(params)
        for i in range(t.TRAIN_STEPS):
            batch = {k: jnp.asarray(v) for k, v in
                     t._batch(jcfg, seed=i).items()}
            params, state, _ = step(params, state, batch)
        return t._np(params), t._np(state)
    finally:
        for m, j in zip(modules, saved):
            m.jnp = j
        for m in (attention, layers, moe, ssm, jtf):
            if hasattr(m, "dtype_of"):
                m.dtype_of = dtype_of


def _dist(a_tree, b_tree, cfg):
    """max |a - b| over the leaves of two reference-layout trees."""
    a = t.pytree.tree_leaves(t.ttf.params_from_numpy(a_tree, cfg))
    b = t.pytree.tree_leaves(t.ttf.params_from_numpy(b_tree, cfg))
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


def main():
    worst = {}
    for arch in t.TRAIN_ARCHS:
        _, tcfg = t._cfgs(arch)
        for mb in (1, 2):
            _, p32, s32 = t._reference_train(arch, mb)
            with jax.enable_x64(True):
                p64, s64 = _float64_reference(arch, mb)
            _, tp, ts = t._port_train(arch, mb)
            port = {"params": _as_np(tp), "m": _as_np(ts.m),
                    "v": _as_np(ts.v)}
            ref32 = {"params": p32, "m": s32.m, "v": s32.v}
            ref64 = {"params": p64, "m": s64.m, "v": s64.v}
            for what in ("params", "m", "v"):
                row = (_dist(ref32[what], ref64[what], tcfg),
                       _dist_port(port[what], ref64[what], tcfg),
                       _dist_port(port[what], ref32[what], tcfg))
                worst[what] = max(worst.get(what, 0.0), *row[:2])
                print(f"{arch:18s} mb={mb} {what:6s}: ref32-ref64 "
                      f"{row[0]:.3g}  port32-ref64 {row[1]:.3g}  "
                      f"port32-ref32 {row[2]:.3g}", flush=True)
    print("largest float32-to-float64 distance of either package:",
          {k: float(f"{v:.3g}") for k, v in worst.items()})


def _as_np(tree):
    return t.pytree.tree_map(lambda p: p.detach().double().numpy(), tree)


def _dist_port(port_tree, ref_tree, cfg):
    a = t.pytree.tree_leaves(port_tree)
    b = t.pytree.tree_leaves(t.ttf.params_from_numpy(ref_tree, cfg))
    return max(float(np.abs(x - y.double().numpy()).max())
               for x, y in zip(a, b))


if __name__ == "__main__":
    main()
