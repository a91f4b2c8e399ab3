"""Dry run: what every (architecture x input shape) would hold and compute.

The port of ``repro/launch/dryrun.py``'s host arithmetic and of its
memory question. Per combination it reports, as one JSON line:

  * ``microbatches`` (train), ``window`` (the sliding-window serve of
    ``long_500k``) and ``model_flops`` (6 N D to train, 2 N D to serve,
    N the active parameters), the reference's arithmetic;
  * the bytes of the parameters, of the AdamW state (train) or the decode
    caches (decode), and of the inputs: built on ``device="meta"``, so
    nothing is allocated. Serving holds bf16 parameters, as the reference
    lowers it.

The reference lowers and compiles each combination on a TPU pod mesh
(``build_lowerable``, ``run_one``) and reads XLA's memory, cost and
collective figures from the compiled program; a torch program has no such
artifact, so those fields have no counterpart here.

    python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--data-shards 16]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from repro_torch.configs import registry
from repro_torch.data.pipeline import input_specs
from repro_torch.models import transformer as tf
from repro_torch.models.config import INPUT_SHAPES, ArchConfig
from repro_torch.optim.adamw import AdamW


def microbatches_for(cfg: ArchConfig, data_shards: int,
                     global_batch: int) -> int:
    """Micro-batches of a train step: activation-memory control for
    train_4k (tokens a device a micro-batch stay at about 16k for the
    giants)."""
    per_dev = max(1, global_batch // max(data_shards, 1))
    if cfg.d_model >= 6144:
        want = 8
    elif cfg.d_model >= 3072:
        want = 4
    else:
        want = 2
    while per_dev % want:
        want //= 2
    return max(1, want)


def serve_window(cfg: ArchConfig, shape_name: str) -> int:
    """long_500k uses the sliding-window serve variant for attention archs
    (SSM/hybrid run natively; their attention window is already bounded)."""
    if shape_name == "long_500k" and cfg.family not in ("ssm",):
        return cfg.sliding_window or 0
    return 0


def model_flops_estimate(cfg: ArchConfig, shape, mode: str) -> float:
    """6 N_active D (train) / 2 N_active D (inference) token-FLOPs."""
    n = cfg.active_param_count()
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n * tokens


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def nbytes(tree) -> int:
    """Bytes of every tensor in a tree (dicts, lists, tuples,
    dataclasses)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _on_meta(tree):
    return pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def meta_params(cfg: ArchConfig) -> Dict[str, Any]:
    """``cfg``'s parameter tree as ``device="meta"`` tensors: its
    ``init_params`` traced without allocating or drawing anything (the
    counterpart of ``jax.eval_shape`` of the reference's init)."""
    with FakeTensorMode():
        params = tf.init_params(cfg, torch.Generator())
    return _on_meta(params)


def meta_opt_state(cfg: ArchConfig, params) -> Any:
    """The AdamW state of ``params`` on ``device="meta"``; bf16 moments
    above 150 B parameters, as the reference's dry run."""
    moment = "bfloat16" if cfg.param_count() > 1.5e11 else "float32"
    return AdamW(learning_rate=3e-4, moment_dtype=moment).init(params)


def estimate(arch: str, shape_name: str,
             data_shards: int = 1) -> Dict[str, Any]:
    """One combination's record (see the module docstring)."""
    cfg = registry.get(arch)
    shape = INPUT_SHAPES[shape_name]
    mode = shape.kind
    if mode != "train":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    params = meta_params(cfg)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mode": mode,
        "param_dtype": cfg.param_dtype,
        "window": serve_window(cfg, shape_name),
        "model_flops": model_flops_estimate(cfg, shape, mode),
        "param_bytes": nbytes(params),
        "input_bytes": nbytes(input_specs(cfg, shape))}
    if mode == "train":
        rec["microbatches"] = microbatches_for(cfg, data_shards,
                                               shape.global_batch)
        rec["optimizer_bytes"] = nbytes(meta_opt_state(cfg, params))
    if mode == "decode":
        rec["cache_bytes"] = nbytes(tf.init_cache(
            cfg, shape.global_batch, shape.seq_len, window=rec["window"],
            device="meta"))
    rec["total_bytes"] = sum(v for k, v in rec.items()
                             if k.endswith("_bytes"))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--data-shards", type=int, default=1,
                    help="data-parallel ranks a train step's global batch "
                         "is split over (sets the micro-batches)")
    args = ap.parse_args(argv)
    archs = (registry.list_archs() if args.all or not args.arch
             else [args.arch])
    shapes = (list(INPUT_SHAPES) if args.all or not args.shape
              else [args.shape])
    for arch in archs:
        for shape in shapes:
            print(json.dumps(estimate(arch, shape, args.data_shards)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
