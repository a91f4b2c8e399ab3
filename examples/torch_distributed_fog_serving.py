"""Distributed BSP inference on the PyTorch port.

The same Engine config switches executor backends by key: "single" runs
the one-program reference, "mesh-bsp" runs the paper's BSP runtime
(§III-E), one shard per fog partition with a halo/allgather exchange per
GNN layer. In one process the port folds the shards onto one device (a
CUDA card unless ``--device cpu``). ``--ranks N`` then serves the same
queries with one fog per process: N gloo ranks (``cluster="4B"`` has four
fogs, so N = 4) joined in a ``("fog",)`` device mesh, each holding its own
shard and exchanging boundary rows through ``torch.distributed``; on one
card every rank shares it.

    PYTHONPATH=src python examples/torch_distributed_fog_serving.py \
        [--device cpu] [--ranks 4]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.api import Engine, traces
from repro_torch.gnn import datasets, models
from repro_torch.launch.mesh import make_fog_mesh
from repro_torch.runtime import dist as fog_dist

CLUSTER = "4B"
EXCHANGES = ("allgather", "halo")


def engine(params, device, exchange: str) -> Engine:
    # One shared config; only the executor / exchange registry keys change.
    return Engine((params, "sage"), executor="mesh-bsp", exchange=exchange,
                  cluster=CLUSTER, network="wifi", compressor="none",
                  device=device)


def rank_main(rank: int, world: int, params, device: str, folded: dict,
              single):
    """One fog: its shard of every exchange's query; rank 0 reports. The
    executor serves over the default group, which the fog mesh spans."""
    make_fog_mesh(world, torch.device(device).type)
    g = datasets.load("yelp", scale=0.1, seed=0)
    for ex in EXCHANGES:
        r = engine(params, device, ex).compile(g).session().query()
        if rank == 0:
            d_fold = float(np.abs(r.embeddings - folded[ex]).max())
            d_single = float(np.abs(r.embeddings - single).max())
            print(f"ranks    {ex:10s} bytes/sync={r.exchange_bytes:>10,d} "
                  f"max|dist - folded|={d_fold:.2e} "
                  f"max|dist - single|={d_single:.2e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0,
                    help="also serve with one fog per gloo rank (4 for "
                         f"cluster {CLUSTER!r})")
    args = ap.parse_args()
    device = torch.device(args.device)

    g = datasets.load("yelp", scale=0.1, seed=0)
    params, _ = models.train_node_classifier(
        torch.Generator(device=device).manual_seed(0), "sage", g, steps=60)

    ref = Engine((params, "sage"), executor="single", cluster=CLUSTER,
                 network="wifi", compressor="none",
                 device=device).compile(g).session().query()

    folded = {}
    for ex in EXCHANGES:
        plan = engine(params, device, ex).compile(g)
        if ex == "allgather":
            pg = plan.partitioned
            print(f"partitions: slots={pg.slots} edges/part="
                  f"{pg.edges_per_part} boundary={pg.boundary_slots}")
        r = plan.session().query()
        folded[ex] = r.embeddings
        err = float(np.abs(r.embeddings - ref.embeddings).max())
        print(f"exchange={ex:10s} bytes/sync={r.exchange_bytes:>10,d} "
              f"max|dist - single|={err:.2e}")
    print("halo exchange moves only boundary rows — the paper's "
          "'exchange vertices data when needed'.")

    # Request-level serving over the mesh: the Server micro-batches a
    # Poisson trace into batched BSP supersteps and pipelines collection
    # against execution (§III-D) — same numerics per request.
    halo_plan, halo_ref = plan, r       # the loop's last iteration (halo)
    server = halo_plan.server(max_batch=4, max_wait=0.05)
    responses = server.replay(traces.poisson(12, rate=6.0, seed=1))
    ok = all(np.allclose(resp.embeddings, halo_ref.embeddings)
             for resp in responses)
    s = server.summarize(responses)
    print(f"mesh-bsp trace of {s['requests']}: makespan "
          f"{s['makespan_s']:.2f}s throughput {s['throughput_rps']:.2f}/s "
          f"mean batch {s['mean_batch']:.2f} (numerics match: {ok})")

    if args.ranks:
        if device.type == "cuda":
            from repro_torch.kernels import build
            build.build()    # once, before the ranks load the kernels
        cpu = [{k: v.cpu() for k, v in p.items()} for p in params]
        with tempfile.TemporaryDirectory() as rendezvous:
            fog_dist.spawn(rank_main, args.ranks, rendezvous, args.ranks,
                           cpu, str(device), folded, ref.embeddings)


if __name__ == "__main__":
    main()
