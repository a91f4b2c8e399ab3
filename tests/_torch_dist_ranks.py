"""Rank programs of ``tests/test_torch_dist.py``, one process a fog.

``repro_torch.runtime.dist.spawn`` starts them (start method ``spawn``),
so they live in a module the ranks can import by name. Each rank serves
through ``Engine(..., executor="mesh-bsp", device="cpu")`` while the
default process group is up, i.e. its own shard only (none after its fog
crashed), and saves what it served to ``rank<r>.npz`` for the test
process to compare with the folded run.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import Engine, GraphDelta
from repro_torch.api.faults import Fault, FaultSchedule
from repro_torch.api.server import Request
from repro_torch.gnn import datasets, models
from repro_torch.launch.mesh import make_fog_mesh, make_host_mesh
from repro_torch.runtime import dist as fog_dist
from repro_torch.runtime.dist import WIRE

SCALE = 0.05
STALE_BOUND = 2
#: configurations also served through the activation cache (frontier)
#: and the stale-tolerant exchange (halo_async).
EXTRA = (("gcn", "daq", "pallas", "halo"),
         ("sage", "none", "segment_sum", "halo"))


#: configurations failed over on ranks: the kernel path on the DAQ wire
#: and the segment sum of SAGE and GAT.
FAILOVER = (("gcn", "daq", "pallas", "halo"),
            ("sage", "none", "segment_sum", "halo"),
            ("gat", "none", "segment_sum", "halo"))
#: The crashed node, fog 1: rank 1 then holds no shard, and the
#: survivors' ranks 0, 2 and 3 hold shards 0, 1 and 2.
CRASHED = "fog1(B)"
#: The second crash of the sequence of two failovers and a restore.
CRASHED_NEXT = "fog3(C)"
#: tests/test_torch_faults.py's JAX mesh reference: its cluster, its
#: seeded chaos schedule and its trace.
CHAOS_CLUSTER = "1A+3B"
CHAOS = dict(horizon=0.5, crash_rate=1.5, loss_rate=2.0, straggler_rate=1.0,
             mean_outage=0.3, seed=16)
CHAOS_REQUESTS = 16
#: Schedules that fail a node of CHAOS_CLUSTER over through the Server
#: and bring it back (tests/test_torch_faults.py's tier-3 cases; the halo
#: loss comes before the first serve, so no stale tables can absorb it).
SCHEDULES = {"crash-restore": [(0.10, "crash", "fog3(B)"),
                               (0.40, "recover", "fog3(B)")],
             "loss-failover": [(0.0, "halo_loss", "fog2(B)", 0.0, 1.0, 6),
                               (0.40, "recover", "fog2(B)")]}
SCHEDULE_REQUESTS = 24


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


def _query(sess, out, key) -> None:
    """One query: its embeddings, ``exchange_bytes`` and each sync's
    bytes on the wire."""
    WIRE.reset()
    res = sess.query()
    out[key + "/query"] = res.embeddings
    out[key + "/exchange_bytes"] = np.asarray(res.exchange_bytes)
    out[key + "/query_syncs"] = np.asarray(WIRE.sync_bytes, np.int64)


def fail_over(inputs, cluster, g, out) -> None:
    """Every FAILOVER configuration: the whole plan's query, then per mode
    a session failed over CRASHED serves one query, one execute and one
    ``execute_many`` of the stack, and is rebound to the whole plan (as
    ``Server._recover`` does) for one more query."""
    for config in FAILOVER:
        tag = "/".join(config)
        plan = engine(inputs, *config, cluster).compile(g)
        out[tag + "/before"] = plan.session().query().embeddings
        for mode in ("repair", "recompile"):
            key = f"{tag}/{mode}"
            sess = plan.session()
            out[key + "/fog_ranks"] = np.asarray(
                sess.failover(CRASHED, mode=mode).fog_ranks)
            _query(sess, out, key)
            out[key + "/execute"] = sess.execute(sess.collect())
            WIRE.reset()
            out[key + "/many"] = np.stack(
                sess.execute_many(inputs[tag + "/stack"]))
            out[key + "/many_syncs"] = np.asarray(WIRE.sync_bytes, np.int64)
            sess.rebind(plan)
            out[key + "/restored"] = sess.query().embeddings


def sequence(inputs, cluster, g, out) -> None:
    """One GCN DAQ session: a failover of CRASHED, one of CRASHED_NEXT,
    a restore; after each the fogs' ranks and a query."""
    plan = engine(inputs, *FAILOVER[0], cluster).compile(g)
    sess = plan.session()
    steps = (lambda: sess.failover(CRASHED),
             lambda: sess.failover(CRASHED_NEXT),
             lambda: sess.rebind(plan))
    for i, step in enumerate(steps):
        step()
        ranks = sess.plan.fog_ranks
        out[f"sequence/{i}/fog_ranks"] = np.asarray(
            range(sess.plan.num_fogs) if ranks is None else ranks)
        out[f"sequence/{i}/query"] = sess.query().embeddings


def update_and_adapt(inputs, cluster, g, out) -> None:
    """GCN DAQ: one structural ``Session.update`` on the whole plan and one
    on a failover plan, then one ``Session.adapt`` with fog 0 overloaded;
    a query after each."""
    delta = GraphDelta(**{k[len("delta/"):]: v for k, v in inputs.items()
                          if k.startswith("delta/")})
    for name, crash in (("update", None), ("update_failover", CRASHED)):
        sess = engine(inputs, *FAILOVER[0], cluster).compile(g).session()
        if crash is not None:
            sess.failover(crash)
        out[name + "/mode"] = np.asarray(sess.update(delta).mode)
        ranks = sess.plan.fog_ranks
        out[name + "/fog_ranks"] = np.asarray(
            range(sess.plan.num_fogs) if ranks is None else ranks)
        _query(sess, out, name)
    sess = engine(inputs, *FAILOVER[0], cluster).compile(g).session()
    sess.plan.cluster.nodes[0].background_load = 10.0
    out["adapt/action"] = np.asarray(sess.adapt())
    out["adapt/assignment"] = np.asarray(sess.placement.assignment)
    _query(sess, out, "adapt")


def _replay(srv, requests: int, out, key) -> None:
    """``srv`` serves ``requests`` arrivals 0.03 s apart: each response's
    embeddings, latency and tags, and the nodes still crashed."""
    resp = srv.serve([Request(arrival_time=i * 0.03)
                      for i in range(requests)])
    out[key + "/crashed"] = np.asarray(sorted(srv._crashed), dtype=str)
    for r in resp:
        at = f"{key}/{r.request_id}/"
        out[at + "embeddings"] = r.embeddings
        out[at + "latency"] = np.asarray(r.latency)
        out[at + "tags"] = np.array([str(r.recovered), str(r.retries),
                                     r.capacity, str(r.staleness)])


def chaos(inputs, g, out) -> None:
    """tests/test_torch_faults.py's JAX mesh reference on the port: GCN on
    the DAQ wire with ``halo_async``, a repair failover of node 2 and a
    seeded chaos ``Server`` replay (a halo loss the retry and stale tiers
    absorb), then replays whose schedules fail a node over through the
    ``Server`` (a crash; a halo loss past the stale tier) and restore it."""
    layers = [{k.split("/")[3]: inputs[k] for k in inputs
               if k.startswith(f"chaos/param/{i}/")} for i in range(2)]
    eng = Engine((models.params_from_numpy(layers), "gcn"), CHAOS_CLUSTER,
                 executor="mesh-bsp", aggregation="pallas", compressor="daq",
                 exchange="halo_async", staleness_bound=2, device="cpu")
    plan = eng.compile(g)
    plan2 = eng.fail_nodes(plan, plan.cluster.nodes[2].name, mode="repair")
    out["chaos/failover/assignment"] = plan2.placement.assignment
    out["chaos/failover/embeddings"] = plan2.session().query().embeddings
    names = [nd.name for nd in plan.cluster.nodes]
    _replay(plan.server(max_batch=4, faults=FaultSchedule.random(
        names, **CHAOS)), CHAOS_REQUESTS, out, "replay/chaos")
    for name, events in SCHEDULES.items():
        _replay(plan.server(max_batch=4, faults=FaultSchedule(
            [Fault(*e) for e in events])), SCHEDULE_REQUESTS, out,
            "replay/" + name)


def faults(inputs, cluster, g, out) -> None:
    """The failover, restore, update, adapt and chaos runs, in the order
    every rank and the folded run make them."""
    fail_over(inputs, cluster, g, out)
    sequence(inputs, cluster, g, out)
    update_and_adapt(inputs, cluster, g, out)
    chaos(inputs, g, out)


def serve_rank(rank, inputs_path, configs, cluster, mismatch, out_dir):
    """One rank: the fog and host meshes over the group, ``serve`` and
    ``faults`` on its shard, the groups it made, then a plan of
    ``mismatch`` (a cluster of another fog count, compiled afresh) must
    be refused by the executor."""
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
    faults(inputs, cluster, g, out)
    out["groups"] = np.asarray(["-".join(map(str, r))
                                for r in fog_dist.groups_made()])
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


#: tests/test_torch_gat_heads.py's multi-head GAT: heads a layer and
#: each head's width (hidden heads concatenated, the last averaged).
GAT_HEADS = (2, 2, 3)
GAT_HEAD_DIMS = (8, 8, 5)


def gat_heads_many(inputs, cluster, g) -> np.ndarray:
    """The multi-head GAT (``gat_heads``) of ``inputs`` (``param/<layer>/
    <name>`` arrays) serves the ``stack`` batch on the mesh."""
    layers = [{name: inputs[f"param/{i}/{name}"]
               for name in ("w", "att_src", "att_dst")}
              for i in range(len(GAT_HEADS))]
    sess = Engine((models.params_from_numpy(layers), "gat_heads"),
                  cluster=cluster, compressor="none", exchange="halo",
                  executor="mesh-bsp", aggregation="segment_sum",
                  device="cpu").compile(g).session()
    return np.stack(sess.execute_many(inputs["stack"]))


def serve_gat_heads_rank(rank, inputs_path, cluster, out_dir):
    """One rank: ``gat_heads_many`` on its shard, saved to
    ``gat_heads<r>.npz``."""
    with np.load(inputs_path) as f:
        inputs = dict(f)
    np.savez(f"{out_dir}/gat_heads{rank}.npz",
             many=gat_heads_many(inputs, cluster, graph()))
