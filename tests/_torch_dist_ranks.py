"""Rank programs of ``tests/test_torch_dist.py``, one process a fog.

``repro_torch.runtime.dist.spawn`` starts them (start method ``spawn``),
so they live in a module the ranks can import by name. Each rank serves
through ``Engine(..., executor="mesh-bsp", device="cpu")`` while the
default process group is up, i.e. its own shard only, and saves what it
served to ``rank<r>.npz`` for the test process to compare with the
folded run.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import Engine
from repro_torch.gnn import datasets, models
from repro_torch.launch.mesh import make_fog_mesh, make_host_mesh
from repro_torch.runtime.dist import WIRE

SCALE = 0.05
STALE_BOUND = 2
#: configurations also served through the activation cache (frontier)
#: and the stale-tolerant exchange (halo_async).
EXTRA = (("gcn", "daq", "pallas", "halo"),
         ("sage", "none", "segment_sum", "halo"))


def graph():
    return datasets.load("siot", scale=SCALE, seed=0)


def engine(inputs, kind, comp, agg, exchange, cluster, **kw):
    layers = [{k.split("/")[3]: inputs[k] for k in inputs
               if k.startswith(f"{kind}/param/{i}/")}
              for i in range(int(inputs[f"{kind}/layers"]))]
    return Engine((models.params_from_numpy(layers), kind), cluster=cluster,
                  compressor=comp, exchange=exchange, executor="mesh-bsp",
                  aggregation=agg, device="cpu", **kw)


def serve(inputs, configs, cluster, g, out) -> None:
    """Every configuration: one query and one batch; the EXTRA ones also
    through the activation cache and the stale-tolerant exchange. The
    folded run of the test process calls this with no group up."""
    for config in configs:
        tag = "/".join(config)
        stack = inputs[tag + "/stack"]
        sess = engine(inputs, *config, cluster).compile(g).session()
        WIRE.reset()
        res = sess.query()
        out[tag + "/embeddings"] = res.embeddings
        out[tag + "/exchange_bytes"] = np.asarray(res.exchange_bytes)
        out[tag + "/query_syncs"] = np.asarray(WIRE.sync_bytes, np.int64)
        WIRE.reset()
        out[tag + "/many"] = np.stack(sess.execute_many(stack))
        out[tag + "/many_syncs"] = np.asarray(WIRE.sync_bytes, np.int64)
        if config not in EXTRA:
            continue
        kind, comp, agg, _ = config
        frontier = engine(inputs, *config, cluster).compile(g).session(
            activation_cache=True, frontier_max_fraction=1.0)
        seq = inputs["frontier/feats"]
        got = [frontier.execute(seq[0]), frontier.execute(seq[1])]
        out[tag + "/frontier_used"] = np.asarray(
            frontier.last_frontier is not None)
        got += frontier.execute_many(seq[2:])
        out[tag + "/frontier"] = np.stack(got)
        stale = engine(inputs, kind, comp, agg, "halo_async", cluster,
                       staleness_bound=STALE_BOUND).compile(g).session()
        got, ages = [], []
        for i in range(4):
            got.append(stale.execute(seq[i % 2]))
            ages.append(stale.last_staleness)
        got += stale.execute_many(seq[2:])
        ages.append(stale.last_staleness)
        out[tag + "/stale"] = np.stack(got)
        out[tag + "/stale_ages"] = np.asarray(ages)


def serve_rank(rank, inputs_path, configs, cluster, mismatch, out_dir):
    """One rank: the fog and host meshes over the group, ``serve`` on its
    shard, then a plan of ``mismatch`` (a cluster of another fog count)
    must be refused by the executor."""
    with np.load(inputs_path) as f:
        inputs = dict(f)
    g = graph()
    world = dist.get_world_size()
    out = {"world": np.asarray(world), "rank": np.asarray(rank)}
    fog = make_fog_mesh(world, "cpu")
    host = make_host_mesh(2, "cpu")
    out["fog_mesh"] = np.asarray(
        [fog.mesh_dim_names == ("fog",), fog.size(),
         dist.get_world_size(fog.get_group()), fog.get_local_rank()])
    out["host_mesh"] = np.asarray(
        [host.mesh_dim_names == ("data", "model"), *host.mesh.shape])
    try:
        make_fog_mesh(world + 2, "cpu")
        out["fog_mesh_refused"] = np.asarray("")
    except ValueError as e:
        out["fog_mesh_refused"] = np.asarray(str(e))
    serve(inputs, configs, cluster, g, out)
    try:
        engine(inputs, "gcn", "none", "pallas", "halo",
               mismatch).compile(g).session()
        out["mismatch"] = np.asarray("")
    except RuntimeError as e:
        out["mismatch"] = np.asarray(str(e))
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


def raise_before_gather(rank):
    """Rank 1 raises before any collective; the others block in their
    first ``all_gather`` until the launcher ends them."""
    if rank == 1:
        raise RuntimeError(f"rank {rank} failed on purpose")
    world = dist.get_world_size()
    dist.all_gather([torch.zeros(1) for _ in range(world)], torch.zeros(1))
