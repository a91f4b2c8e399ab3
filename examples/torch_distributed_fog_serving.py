"""Distributed BSP inference on the PyTorch port.

The same Engine config switches executor backends by key: "single" runs
the one-program reference, "mesh-bsp" runs the paper's BSP runtime
(§III-E), one shard per fog partition with a halo/allgather exchange per
GNN layer. The port folds the shards onto one device (a CUDA card unless
``--device cpu``), so no device-count flag is needed.

    PYTHONPATH=src python examples/torch_distributed_fog_serving.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import Engine, traces
from repro_torch.gnn import datasets, models

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)

g = datasets.load("yelp", scale=0.1, seed=0)
params, _ = models.train_node_classifier(
    torch.Generator(device=device).manual_seed(0), "sage", g, steps=60)

# One shared config; only the executor / exchange registry keys change.
base = dict(cluster="4B", network="wifi", compressor="none", device=device)
ref = Engine((params, "sage"), executor="single",
             **base).compile(g).session().query()

for ex in ("allgather", "halo"):
    engine = Engine((params, "sage"), executor="mesh-bsp", exchange=ex,
                    **base)
    plan = engine.compile(g)
    if ex == "allgather":
        pg = plan.partitioned
        print(f"partitions: slots={pg.slots} edges/part={pg.edges_per_part} "
              f"boundary={pg.boundary_slots}")
    r = plan.session().query()
    err = float(np.abs(r.embeddings - ref.embeddings).max())
    print(f"exchange={ex:10s} bytes/sync={r.exchange_bytes:>10,d} "
          f"max|dist - single|={err:.2e}")
print("halo exchange moves only boundary rows — the paper's "
      "'exchange vertices data when needed'.")

# Request-level serving over the mesh: the Server micro-batches a Poisson
# trace into batched BSP supersteps and pipelines collection against
# execution (§III-D) — same numerics per request.
halo_plan, halo_ref = plan, r       # the loop's last iteration (halo)
server = halo_plan.server(max_batch=4, max_wait=0.05)
responses = server.replay(traces.poisson(12, rate=6.0, seed=1))
ok = all(np.allclose(resp.embeddings, halo_ref.embeddings)
         for resp in responses)
s = server.summarize(responses)
print(f"mesh-bsp trace of {s['requests']}: makespan {s['makespan_s']:.2f}s "
      f"throughput {s['throughput_rps']:.2f}/s mean batch "
      f"{s['mean_batch']:.2f} (numerics match: {ok})")
