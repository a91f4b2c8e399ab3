"""The port's ``mesh-bsp`` with one fog per ``torch.distributed`` rank.

One gloo group of four CPU ranks (``CLUSTER = "1A+2B+1C"``, four fogs)
serves every configuration of ``tests/test_torch_mesh.py``'s ``CONFIGS``
through ``Engine(..., executor="mesh-bsp", device="cpu")``: rank ``r``
holds shard ``r`` only and its halo (or its DAQ codes, scales and mins)
crosses ``torch.distributed.all_gather``. Each rank's ``query()`` and
``execute_many`` of B = 2 must be bitwise the folded run (no process
group: every shard on one device) on the same weights and features, and
within ``tests/test_torch_mesh.py``'s bars of the JAX reference's
``mesh-bsp`` (four forced host devices, one subprocess). Each BSP sync's
bytes on the wire must be the reference's ``exchange_bytes`` for that
layer's width. Frontier (activation cache) and stale (``halo_async``)
serves on ranks are bitwise their folded runs, a plan of six fogs on the
four-rank group is refused, and a rank that raises ends the group at once.

Failover on ranks: a session fails ``fog1(B)`` over in either mode and
its three survivors serve on a group of their own ranks (0, 2 and 3);
rank 1 holds no shard, enters no sync and still returns the survivors'
answer. Queries, executes and batches on every rank, rank 1 included, are
bitwise the folded failover, each sync moves the survivor plan's
``exchange_bytes``, and a rebind to the whole plan serves the pre-crash
answer. Two failovers and a restore make the same groups in the same
order on every rank; ``Session.update`` (on the whole and on a failover
plan) and ``Session.adapt`` on ranks are their folded runs bitwise; and
``tests/test_torch_faults.py``'s "1A+3B" repair failover and seeded chaos
``Server`` replay on the four ranks are bitwise the folded replay and
match that file's JAX ``mesh-bsp`` reference (assignment, latencies and
tags ``==``, embeddings within the DAQ wire's bar).

The ranks start once a session (the first xdist worker to need them runs
them, the others wait on a file lock and read the results), and the JAX
references are ``tests/test_torch_mesh.py``'s and
``tests/test_torch_faults.py``'s, each run once for both files.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch.distributed as dist

import _torch_dist_ranks as ranks
import test_torch_faults as faults_tests
import test_torch_mesh as mesh_tests
from repro_torch.runtime import bsp as tbsp
from repro_torch.runtime import dist as fog_dist

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

TESTS = os.path.dirname(os.path.abspath(__file__))
CONFIGS = mesh_tests.CONFIGS
CLUSTER = mesh_tests.CLUSTER
WORLD = 4
MISMATCH = "1A+4B+1C"     # six fogs
WIDTHS = (16,)            # the hidden width: layer 1's input
#: Sensors whose readings change between the frontier queries.
CHANGED = (3, 40, 41, 200)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return mesh_tests.shared_npz(tmp_path_factory, "mesh_reference",
                                 mesh_tests.build_reference)


@pytest.fixture(scope="module")
def chaos_reference(tmp_path_factory):
    return mesh_tests.shared_npz(tmp_path_factory, "faults_reference",
                                 faults_tests.build_mesh_reference)


def _inputs(reference, chaos_reference=None) -> dict:
    """What both runs read: the references' weights and batches, the
    frontier sequence (the graph's features, then CHANGED perturbed, then
    a batch of two more perturbations) and a seeded structural delta."""
    inputs = {k: v for k, v in reference.items()
              if "/param/" in k or k.endswith("/stack")}
    if chaos_reference is not None:
        inputs.update({"chaos/" + k: v for k, v in chaos_reference.items()
                       if k.startswith("param/")})
    for kind in ("gcn", "sage", "gat"):
        inputs[f"{kind}/layers"] = np.asarray(
            len({k.split("/")[2] for k in inputs
                 if k.startswith(f"{kind}/param/")}))
    f0 = ranks.graph().features.astype(np.float32)
    seq = [f0]
    for step in (1, 2, 3):
        f = f0.copy()
        f[list(CHANGED)] += np.float32(0.25 * step)
        seq.append(f)
    inputs["frontier/feats"] = np.stack(seq)
    inputs.update(_delta(ranks.graph()))
    return inputs


def _delta(g) -> dict:
    """A structural delta's arrays under ``delta/``: new vertices wired
    into the graph, removed vertices and edges, feature upserts."""
    rng = np.random.default_rng(5)
    v, k = g.num_vertices, 16
    fanout = rng.integers(1, 4, size=k)
    removed = rng.choice(v, size=k // 2, replace=False)
    eidx = rng.integers(0, g.num_edges, size=k)
    upd = np.setdiff1d(rng.choice(v, size=k, replace=False), removed)
    return {"delta/add_features": rng.normal(
                size=(k, g.feature_dim)).astype(np.float32),
            "delta/add_edges": np.stack(
                [np.repeat(v + np.arange(k), fanout),
                 rng.integers(0, v, int(fanout.sum()))], axis=1),
            "delta/remove_vertices": removed,
            "delta/remove_edges": np.stack(
                [g.senders[eidx], g.receivers[eidx]], axis=1),
            "delta/feature_ids": upd,
            "delta/feature_values": rng.normal(size=(len(upd),
                                                     g.feature_dim))}


def _runs(reference, chaos_reference):
    def build(tmp):
        inputs = _inputs(reference, chaos_reference)
        path = tmp / "inputs.npz"
        np.savez(path, **inputs)
        fog_dist.spawn(ranks.serve_rank, WORLD, str(tmp), str(path),
                       CONFIGS, CLUSTER, MISMATCH, str(tmp))
        out = {}
        for r in range(WORLD):
            with np.load(tmp / f"rank{r}.npz") as f:
                out.update({f"rank{r}/{k}": v for k, v in f.items()})
        folded = {}
        ranks.serve(inputs, CONFIGS, CLUSTER, ranks.graph(), folded)
        ranks.faults(inputs, CLUSTER, ranks.graph(), folded)
        out.update({f"folded/{k}": v for k, v in folded.items()})
        np.savez(tmp / "runs.npz", **out)
        return tmp / "runs.npz"
    return build


@pytest.fixture(scope="module")
def runs(reference, chaos_reference, tmp_path_factory):
    return mesh_tests.shared_npz(tmp_path_factory, "dist_runs",
                                 _runs(reference, chaos_reference))


def test_each_rank_holds_its_shard_of_the_group(runs):
    assert [int(runs[f"rank{r}/rank"]) for r in range(WORLD)] == list(
        range(WORLD))
    assert all(int(runs[f"rank{r}/world"]) == WORLD for r in range(WORLD))


def test_fog_and_host_meshes_span_the_ranks(runs):
    """``launch.mesh``: the ``("fog",)`` mesh is the whole group, one rank
    a fog (the group ``bsp`` takes); the ``("data", "model")`` mesh of
    model 2 is 2 x 2; a fog mesh of another size is refused."""
    for r in range(WORLD):
        assert runs[f"rank{r}/fog_mesh"].tolist() == [1, WORLD, WORLD, r]
        assert runs[f"rank{r}/host_mesh"].tolist() == [1, 2, 2]
        assert "need 6 ranks for 6 fogs, the world has 4" in str(
            runs[f"rank{r}/fog_mesh_refused"])


@pytest.mark.parametrize("config", CONFIGS, ids="-".join)
def test_ranks_serve_the_folded_run_bitwise(runs, config):
    tag = "/".join(config)
    for key in ("embeddings", "many"):
        want = runs[f"folded/{tag}/{key}"]
        for r in range(WORLD):
            assert np.array_equal(runs[f"rank{r}/{tag}/{key}"], want), (r, key)


@pytest.mark.parametrize("config", CONFIGS, ids="-".join)
def test_ranks_match_the_jax_mesh(runs, reference, config):
    tag = "/".join(config)
    daq_wire = config[1] == "daq" and config[2] == "pallas"
    for r in range(WORLD):
        mesh_tests._assert_embeddings(runs[f"rank{r}/{tag}/embeddings"],
                                      reference[tag + "/embeddings"],
                                      daq_wire)
        for got, want in zip(runs[f"rank{r}/{tag}/many"],
                             reference[tag + "/many"]):
            mesh_tests._assert_embeddings(got, want, daq_wire)


@pytest.mark.parametrize("config", CONFIGS, ids="-".join)
def test_wire_bytes_per_sync_are_the_exchange_bytes(runs, reference, config):
    """Each layer's sync moves ``exchange_bytes`` at that layer's input
    width (the reference's figure at layer 0); a batch of two moves twice
    that per layer, in one sync on the kernel path and in one per example
    on the segment path (layer by layer: both examples' first syncs come
    before their second). The folded run crosses no wire."""
    kind, comp, agg, exchange = config
    tag = "/".join(config)
    want = int(reference[tag + "/exchange_bytes"])
    sess = ranks.engine(_inputs(reference), *config, CLUSTER).compile(
        ranks.graph()).session()
    pg = sess.partitioned()
    dtype_bytes, overhead = sess.resolve_executor().wire_format(
        sess.plan, exchange, agg)
    per_layer = [want] + [tbsp.exchange_bytes(pg, f, exchange, dtype_bytes,
                                              overhead) for f in WIDTHS]
    batched = ([2 * b for b in per_layer] if agg == "pallas"
               else [b for b in per_layer for _ in range(2)])
    for r in range(WORLD):
        assert int(runs[f"rank{r}/{tag}/exchange_bytes"]) == want
        assert runs[f"rank{r}/{tag}/query_syncs"].tolist() == per_layer
        assert runs[f"rank{r}/{tag}/many_syncs"].tolist() == batched
    assert runs[f"folded/{tag}/query_syncs"].tolist() == []


@pytest.mark.parametrize("config", ranks.EXTRA, ids="-".join)
@pytest.mark.parametrize("what", ("frontier", "stale"))
def test_frontier_and_stale_serves_on_ranks_are_folded_bitwise(runs, config,
                                                               what):
    tag = "/".join(config)
    want = runs[f"folded/{tag}/{what}"]
    for r in range(WORLD):
        assert np.array_equal(runs[f"rank{r}/{tag}/{what}"], want), r
    if what == "frontier":
        assert bool(runs[f"folded/{tag}/frontier_used"])
        assert all(bool(runs[f"rank{r}/{tag}/frontier_used"])
                   for r in range(WORLD))
    else:
        ages = [0, 1, 2, 0, 1]
        assert runs[f"folded/{tag}/stale_ages"].tolist() == ages
        for r in range(WORLD):
            assert runs[f"rank{r}/{tag}/stale_ages"].tolist() == ages


def test_a_plan_of_another_fog_count_is_refused_on_every_rank(runs):
    for r in range(WORLD):
        msg = str(runs[f"rank{r}/mismatch"])
        assert "needs 6 ranks" in msg and "has 4" in msg, msg


def test_bsp_refuses_a_group_of_another_size(reference, tmp_path):
    """The entry points name both numbers, like the reference's
    ``_default_mesh`` (the executor's ``check`` refuses the plan first):
    here a one-rank group in this process against four partitions."""
    sess = ranks.engine(_inputs(reference), "gcn", "none", "pallas", "halo",
                        CLUSTER).compile(ranks.graph()).session()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="need 4 ranks for 4 "
                           "partitions, the process group has 1"):
            tbsp.bsp_apply(list(sess.plan.model.params), "gcn",
                           sess.partitioned(), aggregation="pallas",
                           device="cpu", group=dist.group.WORLD)
        with pytest.raises(RuntimeError, match="needs 4 ranks .* has 1"):
            sess.plan.session()
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# failover, restore, updates and chaos replays on ranks
# ----------------------------------------------------------------------------

MODES = ("repair", "recompile")
#: The survivors' ranks after CRASHED; the rank outside their group.
SURVIVORS = [0, 2, 3]
OUTSIDE = 1


def _failover_plan(reference, config, mode):
    """The folded failover's plan, as the ranks derive it."""
    plan = ranks.engine(_inputs(reference), *config, CLUSTER).compile(
        ranks.graph())
    return plan.session().failover(ranks.CRASHED, mode=mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("config", ranks.FAILOVER, ids="-".join)
def test_failover_on_ranks_is_the_folded_failover_bitwise(runs, config, mode):
    """Every rank, the one outside the survivors' group included, serves
    the folded failover's query, execute and batch bitwise."""
    key = "/".join(config) + "/" + mode
    assert runs[f"folded/{key}/fog_ranks"].tolist() == SURVIVORS
    for r in range(WORLD):
        assert runs[f"rank{r}/{key}/fog_ranks"].tolist() == SURVIVORS
        for what in ("query", "execute", "many"):
            assert np.array_equal(runs[f"rank{r}/{key}/{what}"],
                                  runs[f"folded/{key}/{what}"]), (r, what)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("config", ranks.FAILOVER, ids="-".join)
def test_survivor_syncs_move_the_survivor_plans_exchange_bytes(
        runs, reference, config, mode):
    """Each survivor's sync moves the three-fog plan's ``exchange_bytes``
    at the layer's width (the query's figure at layer 0); a batch of two
    twice that, layer by layer, as on the whole plan; rank 1 enters no
    sync."""
    kind, comp, agg, exchange = config
    key = "/".join(config) + "/" + mode
    sess = _failover_plan(reference, config, mode).session()
    pg = sess.partitioned()
    assert pg.n == len(SURVIVORS)
    dtype_bytes, overhead = sess.resolve_executor().wire_format(
        sess.plan, exchange, agg)
    per_layer = [tbsp.exchange_bytes(pg, f, exchange, dtype_bytes, overhead)
                 for f in (pg.feats.shape[-1],) + WIDTHS]
    batched = ([2 * b for b in per_layer] if agg == "pallas"
               else [b for b in per_layer for _ in range(2)])
    for r in range(WORLD):
        assert int(runs[f"rank{r}/{key}/exchange_bytes"]) == per_layer[0]
        inside = r != OUTSIDE
        assert runs[f"rank{r}/{key}/query_syncs"].tolist() == (
            per_layer if inside else []), r
        assert runs[f"rank{r}/{key}/many_syncs"].tolist() == (
            batched if inside else []), r


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("config", ranks.FAILOVER, ids="-".join)
def test_a_restore_on_ranks_serves_the_pre_crash_answer(runs, config, mode):
    tag = "/".join(config)
    want = runs[f"folded/{tag}/before"]
    assert np.array_equal(runs[f"folded/{tag}/{mode}/restored"], want)
    for r in range(WORLD):
        assert np.array_equal(runs[f"rank{r}/{tag}/before"], want), r
        assert np.array_equal(runs[f"rank{r}/{tag}/{mode}/restored"],
                              want), r


def test_every_rank_makes_the_same_groups_in_the_same_order(runs):
    """Two failovers and a restore on one session: the world, then the
    survivors of fog 1, then of fogs 1 and 3, then the world again (its
    own group, made first); the chaos replay's crashes add theirs after.
    Every rank made the same groups in the same order and served each
    step bitwise the folded run."""
    groups = runs["rank0/groups"].tolist()
    assert groups[:3] == ["0-1-2-3", "0-2-3", "0-2"], groups
    assert len(set(groups)) == len(groups)
    steps = ([0, 2, 3], [0, 2], [0, 1, 2, 3])
    for r in range(WORLD):
        assert runs[f"rank{r}/groups"].tolist() == groups, r
        for i, fog_ranks in enumerate(steps):
            assert runs[f"rank{r}/sequence/{i}/fog_ranks"].tolist() == \
                fog_ranks
            assert np.array_equal(runs[f"rank{r}/sequence/{i}/query"],
                                  runs[f"folded/sequence/{i}/query"]), (r, i)


@pytest.mark.parametrize("name", ("update", "update_failover", "adapt"))
def test_updates_and_adapt_on_ranks_are_folded_bitwise(runs, name):
    """A structural ``Session.update`` on the whole plan and on a failover
    plan (which keeps its survivors' ranks), and an ``adapt`` that
    migrates vertices off an overloaded fog: each rank's query after it is
    the folded one, and only the survivors sync."""
    folded = f"folded/{name}/"
    if name == "adapt":
        assert str(runs[folded + "action"]).startswith("diffusion")
    else:
        assert str(runs[folded + "mode"]) == "incremental"
        want = SURVIVORS if name == "update_failover" else list(range(WORLD))
        assert runs[folded + "fog_ranks"].tolist() == want
    for r in range(WORLD):
        mine = f"rank{r}/{name}/"
        for key in ("action", "assignment", "mode", "fog_ranks"):
            if folded + key in runs:
                assert np.array_equal(runs[mine + key], runs[folded + key])
        assert np.array_equal(runs[mine + "query"], runs[folded + "query"])
        syncs = runs[mine + "query_syncs"].tolist()
        outside = name == "update_failover" and r == OUTSIDE
        assert (syncs == []) == outside, (r, syncs)
        if not outside:
            assert syncs[0] == int(runs[mine + "exchange_bytes"])


def _responses(runs, name):
    """The request ids of the folded replay ``name``."""
    return sorted({k.split("/")[3] for k in runs
                   if k.startswith(f"folded/replay/{name}/")
                   and k.endswith("/latency")}, key=int)


#: Each replay's recovery tags, as the folded replay shows them.
REPLAY_TAGS = {"chaos": {"retry", "None"},
               "crash-restore": {"failover", "restored"},
               "loss-failover": {"failover", "restored"}}


@pytest.mark.parametrize("name", sorted(REPLAY_TAGS))
def test_server_replays_on_ranks_are_the_folded_replays(runs, name):
    """The "1A+3B" Server replays (the seeded chaos schedule, a crash and a
    halo loss that fail a node over, each restored): every rank's
    responses bitwise the folded replay's, the same latencies and tags."""
    ids = _responses(runs, name)
    assert len(ids) == (ranks.CHAOS_REQUESTS if name == "chaos"
                        else ranks.SCHEDULE_REQUESTS)
    tags = {str(runs[f"folded/replay/{name}/{i}/tags"][0]) for i in ids}
    assert REPLAY_TAGS[name] <= tags, tags
    keys = [f"replay/{name}/crashed"] + [
        f"replay/{name}/{i}/{what}" for i in ids
        for what in ("embeddings", "latency", "tags")]
    if name == "chaos":
        keys += ["chaos/failover/assignment", "chaos/failover/embeddings"]
    for r in range(WORLD):
        for key in keys:
            assert np.array_equal(runs[f"rank{r}/{key}"],
                                  runs[f"folded/{key}"]), (r, key)


def test_chaos_replay_on_ranks_matches_the_jax_mesh(runs, chaos_reference):
    """Against tests/test_torch_faults.py's JAX ``mesh-bsp`` reference:
    the failover's assignment ``==``, every response's latency and tags
    ``==``, embeddings within the DAQ wire's bar."""
    ref = chaos_reference
    for r in range(WORLD):
        assert np.array_equal(runs[f"rank{r}/chaos/failover/assignment"],
                              ref["failover/assignment"])
        mesh_tests._assert_embeddings(
            runs[f"rank{r}/chaos/failover/embeddings"],
            ref["failover/embeddings"], True)
        for i in _responses(runs, "chaos"):
            mine, key = f"rank{r}/replay/chaos/{i}/", f"chaos/{i}/"
            assert float(runs[mine + "latency"]) == float(
                ref[key + "latency"])
            assert runs[mine + "tags"].tolist() == ref[key + "tags"].tolist()
            mesh_tests._assert_embeddings(runs[mine + "embeddings"],
                                          ref[key + "embeddings"], True)


FAILING = textwrap.dedent("""
    import sys, tempfile, time
    sys.path.insert(0, sys.argv[1])
    import _torch_dist_ranks as ranks
    from repro_torch.runtime import dist as fog_dist
    t0 = time.perf_counter()
    try:
        fog_dist.spawn(ranks.raise_before_gather, 3, tempfile.mkdtemp())
    except Exception as e:
        print("RAISED", time.perf_counter() - t0, type(e).__name__, str(e))
""")


def test_a_rank_that_raises_ends_the_group_within_seconds():
    """One rank raises before its first ``all_gather``; the others block
    in theirs. ``spawn`` must raise in the parent and end them well before
    the group's 60 s timeout; the subprocess's own limit turns a hang into
    a failure. The error the parent reports is the first rank's to end:
    the raising one, or one whose ``all_gather`` lost that peer (gloo says
    the connection was closed or reset by it, by the timing)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(mesh_tests.REPO, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FAILING, TESTS], env=env,
                          capture_output=True, text=True, timeout=45)
    wall = time.perf_counter() - t0
    assert "RAISED" in proc.stdout, proc.stderr[-2000:]
    line = proc.stdout[proc.stdout.index("RAISED"):]
    assert "ProcessRaisedException" in line, line
    assert ("rank 1 failed on purpose" in line
            or "closed by peer" in line or "reset by peer" in line), line
    assert float(line.split()[1]) < 20, line
    assert wall < 30, wall
    assert fog_dist.TIMEOUT_S == 60


def test_the_folded_executor_has_no_group_and_crosses_no_wire(reference):
    from repro_torch.api.registry import EXECUTORS
    assert EXECUTORS.resolve("mesh-bsp").group() is None
    fog_dist.WIRE.reset()
    ranks.engine(_inputs(reference), "gcn", "daq", "pallas", "halo",
                 CLUSTER).compile(ranks.graph()).session().query()
    assert fog_dist.WIRE.bytes == 0 and fog_dist.WIRE.sync_bytes == []
