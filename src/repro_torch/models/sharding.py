"""Name- and shape-based sharding rules for parameters and batches.

The port of the rule half of ``repro/models/sharding.py``, as plain host
code. A table maps a parameter's *name* to the dimension that carries
model parallelism; a dimension shards on the ``model`` axis only when the
axis divides it (the reference replicates instead of padding). Batch axes
shard over (``pod``,) ``data``; with FSDP a second weight dimension shards
over the data axes as well.

Here a spec is a tuple with one entry per dimension: an axis name, a tuple
of axis names, or None (the reference's ``PartitionSpec`` as a tuple). A
mesh is its shape, a ``{"data": d, "model": m}`` (or ``{"pod": p, "data":
d, "model": m}``) mapping passed in explicitly: there is no module state.
The rules use negative dimension indices, so they hold for the port's
per-layer parameters as for the reference's stage-stacked ones (whose
leading stacking axis they leave alone).

The reference's ``NamedSharding`` trees (``param_shardings``,
``cache_shardings``, ``replicated``) and ``constrain_batch`` place arrays
on a device mesh. Their torch meaning is DTensor placements, which no
slice of the port needs yet: the transformer runs on one card.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

from repro_torch.models.config import ArchConfig

Spec = Tuple[Any, ...]

# name -> candidate (negative) dims for the `data` axis under FSDP
# (ZeRO-3-style): the dim NOT taken by model parallelism, so giants shard
# over the full chip grid.
_FSDP_DIM_RULES: Dict[str, Tuple[int, ...]] = {
    "wq": (-3,), "wk": (-3,), "wv": (-3,), "wo": (-1,),
    "wq_a": (-2,), "wq_b": (-3,), "wkv_a": (-2,), "wk_b": (-3,),
    "wv_b": (-3,),
    "w_gate": (-2,), "w_up": (-2,), "w_down": (-1,),
    "in_proj": (-2,), "x_proj": (-1,), "dt_proj": (-2,),
    "out_proj": (-1,),
    "in_x": (-2,), "in_gate": (-2,), "out": (-1,),
    "table": (-1,), "w": (-2,),
}

# name -> candidate (negative) dims to try sharding on `model`, in order.
_MODEL_DIM_RULES: Dict[str, Tuple[int, ...]] = {
    # attention
    "wq": (-2,), "wk": (-2,), "wv": (-2,), "wo": (-3,),
    "bq": (-2,), "bk": (-2,), "bv": (-2,),
    # MLA
    "wq_a": (), "wq_b": (-2,), "wkv_a": (), "wk_b": (-2,), "wv_b": (-2,),
    # dense mlp (also MoE shared expert)
    "w_gate": (-1,), "w_up": (-1,), "w_down": (-2,),
    # moe router
    "router": (),
    # mamba
    "in_proj": (-1,), "conv_w": (-1,), "conv_b": (-1,),
    "x_proj": (-2,), "dt_proj": (-1,), "dt_bias": (-1,),
    "a_log": (-2,), "d_skip": (-1,), "out_proj": (-2,),
    # rglru
    "in_x": (-1,), "in_gate": (-1,), "w_input_gate": (-1,),
    "w_rec_gate": (-1,), "lambda_p": (-1,), "out": (-2,),
    # embedding / head
    "table": (-2,), "w": (-1,), "b": (-1,),
    # norms
    "norm1": (), "norm2": (), "final_norm": (), "scale": (),
}

# Serving variant: shard attention projections on the head_dim instead of
# heads, so kv-indivisible GQA decodes with partial scores and a small
# all-reduce instead of gathering the KV cache.
_ATTN_DH_RULES: Dict[str, Tuple[int, ...]] = {
    "wq": (-1,), "wk": (-1,), "wv": (-1,), "wo": (-2,),
    "bq": (-1,), "bk": (-1,), "bv": (-1,),
}


def data_axes(mesh_shape: Mapping[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape)


def _spec_for_param(names: Sequence[str], shape, cfg: ArchConfig,
                   mesh_shape: Mapping[str, int],
                   fsdp_axes: Tuple[str, ...] = (),
                   serve_attn_dh: bool = False,
                   expert_grid: bool = False) -> Spec:
    """The spec of one parameter: ``names`` is its path (the last entry
    its name), ``shape`` its shape."""
    model_size = mesh_shape["model"]
    name = str(names[-1]) if names else ""
    ndim = len(shape)
    spec = [None] * ndim
    # MoE expert weights: the leading expert dim takes priority.
    if cfg.num_experts and "ffn" in names and name in ("w_gate", "w_up",
                                                       "w_down"):
        grid = mesh_shape.get("data", 1) * mesh_shape.get("model", 1)
        for ax in range(ndim):
            # the expert dim is the 3rd-from-last at most (E, d, f tail)
            if shape[ax] == cfg.num_experts and ndim - ax == 3:
                if expert_grid and cfg.num_experts % grid == 0:
                    # one expert (group) per chip
                    spec[ax] = ("data", "model")
                    return tuple(spec)
                if cfg.num_experts % model_size == 0:
                    spec[ax] = "model"
                break   # found the expert dim (sharded or indivisible)
    rules = _MODEL_DIM_RULES
    if serve_attn_dh and cfg.num_kv_heads and \
            cfg.num_kv_heads % model_size != 0 and name in _ATTN_DH_RULES:
        rules = {**_MODEL_DIM_RULES, **_ATTN_DH_RULES}
    if not any(spec):
        for nd in rules.get(name, ()):
            ax = ndim + nd
            if 0 <= ax < ndim and shape[ax] % model_size == 0 \
                    and shape[ax] >= model_size:
                spec[ax] = "model"
                break
    if fsdp_axes:
        fs = 1
        for a in fsdp_axes:
            fs *= mesh_shape.get(a, 1)
        for nd in _FSDP_DIM_RULES.get(name, ()):
            ax = ndim + nd
            if 0 <= ax < ndim and spec[ax] is None \
                    and shape[ax] % fs == 0 and shape[ax] >= fs:
                spec[ax] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
                break
    return tuple(spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(cfg: ArchConfig, params, mesh_shape: Mapping[str, int],
                fsdp: bool = False, serve_attn_dh: bool = False,
                expert_grid: bool = False):
    """The spec of every leaf of a parameter (or optimizer-moment) tree,
    in the tree's structure. ``fsdp=True`` also shards a second weight
    dimension over the data (and pod) axes."""
    axes = data_axes(mesh_shape) if fsdp else ()
    return _map_with_path(
        lambda path, leaf: _spec_for_param(
            path, tuple(leaf.shape), cfg, mesh_shape, axes,
            serve_attn_dh=serve_attn_dh, expert_grid=expert_grid), params)


def needs_fsdp(cfg: ArchConfig, mesh_shape: Mapping[str, int], train: bool,
               budget_bytes: float) -> bool:
    """Whether model-parallel-only weights (and the AdamW moments when
    training) exceed ``budget_bytes`` per device."""
    bytes_per_param = {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    if train:
        bytes_per_param += 2 * (2 if cfg.param_count() > 1.5e11 else 4)
    per_dev = cfg.param_count() * bytes_per_param / mesh_shape["model"]
    return per_dev > budget_bytes


def batch_spec(mesh_shape: Mapping[str, int], global_batch: int, rank: int,
               batch_axis: int = 0) -> Spec:
    """Shard the batch dim over (pod, data) when divisible, else over data
    alone when that divides, else replicate."""
    axes = data_axes(mesh_shape)
    total = 1
    for a in axes:
        total *= mesh_shape[a]
    spec: list = [None] * rank
    if global_batch % total == 0 and global_batch >= total:
        # one axis is named alone, as a PartitionSpec canonicalises it
        spec[batch_axis] = axes if len(axes) > 1 else axes[0]
    elif "data" in mesh_shape and global_batch % mesh_shape["data"] == 0 \
            and global_batch >= mesh_shape["data"]:
        spec[batch_axis] = "data"
    return tuple(spec)

