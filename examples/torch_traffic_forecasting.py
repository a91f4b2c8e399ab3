"""Case study (paper §IV-C) on the PyTorch port: traffic-flow forecasting
over the PeMS sensor network with ASTGCN-lite, trained on a CUDA card
(``--device cpu`` for the CPU), served by Fograph.

    PYTHONPATH=src python examples/torch_traffic_forecasting.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import compression, placement, simulation
from repro_torch.gnn import datasets, models
from repro_torch.gnn.layers import EdgeList

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
ap.add_argument("--steps", type=int, default=300)
args = ap.parse_args()
device = torch.device(args.device)

# PeMS-style spatial-temporal data: 307 sensors, 12x5-min history window.
tg = datasets.load_pems_window(scale=1.0, seed=0)
g = tg.graph
print(f"PeMS-like sensor graph: {g.num_vertices} sensors, "
      f"{g.num_edges // 2} roads; forecasting {tg.target.shape[0]} steps")

# The init is drawn on the host, so every device trains from the same
# weights (a CUDA generator's stream is not the CPU's). ASTGCN-lite trains
# on raw readings at lr 1e-3 and diverges from some inits, in the JAX
# package as well. Every timestep's spatial sum is one segment-sum launch
# over [V, 12 * 3], forward and backward.
init = models.astgcn_init(torch.Generator().manual_seed(0),
                          tg.history.shape[-1], tg.history.shape[0],
                          tg.target.shape[0])
params, (mu, sd), loss = models.train_astgcn(
    torch.Generator(device=device).manual_seed(0), tg, steps=args.steps,
    init=init)
edges = EdgeList.from_graph(g, device=device)
with torch.no_grad():
    pred = models.astgcn_apply(params, tg.history, edges).cpu().numpy()
pred = pred * sd + mu
print(f"trained on {device} (loss {loss:.3f}); forecast errors:",
      {k: round(v, 2) for k, v in
       models.forecast_errors(pred, tg.target).items()})

# Degree-aware quantized collection of the sensor window (paper §III-D).
window = tg.history.transpose(1, 0, 2).reshape(g.num_vertices, -1)
packed = compression.daq_pack(window.astype(np.float64), g.degrees)
print(f"DAQ: {packed.raw_bits // 8} B -> {packed.nbytes(True)} B on the wire "
      f"(ratio {packed.nbytes(True) / (packed.raw_bits // 8):.3f})")

# Serving comparison on the case-study cluster (1xA + 2xB + 1xC, 4G).
g_srv = dataclasses.replace(g, features=window.astype(np.float32))
cluster = simulation.make_cluster("1A+2B+1C", "4g", g_srv,
                                  hidden=256, k_layers=4)
fogs = cluster.fog_specs(seed=0)
pl = placement.iep_place(g_srv, fogs, seed=0, sync_cost=cluster.sync_cost)
cloud = simulation.simulate_cloud(cluster)
fograph = simulation.simulate_multi_fog(cluster, pl, compress="daq")
print(f"cloud {cloud.total_latency:.2f}s vs Fograph "
      f"{fograph.total_latency:.2f}s "
      f"({cloud.total_latency / fograph.total_latency:.2f}x speedup; "
      f"paper reports up to 2.79x)")
print("vertices per fog (heterogeneity-aware):",
      np.bincount(pl.assignment, minlength=4))
