"""Quickstart on the PyTorch port: train a GNN, compile a Fograph serving
plan and serve queries, on a CUDA card (``--device cpu`` for the CPU).

The whole paper workflow (Fig. 5/6) behind one API:

    train_node_classifier(generator, kind, graph) -> params   (training)
    Engine(model, cluster, **knobs).compile(graph) -> Plan   (setup phase)
    Plan.session() -> Session                                 (runtime)
    Session.query() / .adapt()
    Plan.server() -> Server                                   (request level)
    Server.replay(traces.poisson(...)) -> [Response, ...]

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
    (or, after `pip install -e .[torch]`:  fograph-demo-torch)
"""
import argparse

import numpy as np
import torch

from repro_torch.api import Engine, Server, traces
from repro_torch.core import simulation
from repro_torch.gnn import datasets, models

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)

# 1. Data + a trained GNN (SIoT-style social-IoT graph, GCN classifier),
#    trained on the device of the generator: the segment sums and their
#    backward run on the card's kernel.
graph = datasets.load("siot", scale=0.1, seed=0)
params, loss = models.train_node_classifier(
    torch.Generator(device=device).manual_seed(0), "gcn", graph, steps=80)
print(f"trained 2-layer GCN on |V|={graph.num_vertices} "
      f"|E|={graph.num_edges} (loss {loss:.3f}) on {device}")

# 2. Setup phase: every pipeline stage is a registry key — swap
#    placement="metis+greedy", compressor="uniform8", executor="mesh-bsp",
#    ... with no other code changes.
engine = Engine((params, "gcn"),
                cluster="1A+4B+1C",   # paper Table II node types
                network="wifi", compressor="daq", placement="iep",
                executor="sim", device=device)
plan = engine.compile(graph)          # profile + IEP placement, frozen
print("placement (vertices per fog):", plan.vertices_per_fog())
print(f"estimated makespan: {plan.est_makespan:.3f}s")

# 3. Runtime phase: a session serves repeated queries and owns the
#    adaptive-scheduler state; the plan stays immutable.
labels = torch.as_tensor(graph.labels)
session = plan.session(accuracy_fn=lambda emb: float(
    models.accuracy(torch.as_tensor(emb), labels)))
result = session.query()
print(f"latency {result.latency:.3f}s  "
      f"throughput {result.throughput:.2f}/s  "
      f"wire {result.wire_bytes / 1e3:.1f} KB  "
      f"accuracy {result.accuracy:.4f}  [{result.backend}]")

# 4. Request-level serving (§III-D): a Server micro-batches compatible
#    arrivals into one batched collect + one executor run, and pipelines
#    query i+1's collection against query i's execution. Same numerics,
#    higher throughput under load than the serial one-at-a-time loop.
trace = traces.poisson(24, rate=8.0, seed=1)       # arrivals on a sim clock
serial = plan.server(max_batch=1, pipelined=False).replay(list(trace))
batched = plan.server(max_batch=8, max_wait=0.05).replay(list(trace))
s0, s1 = Server.summarize(serial), Server.summarize(batched)
print(f"serial loop : makespan {s0['makespan_s']:.2f}s  "
      f"throughput {s0['throughput_rps']:.2f}/s")
print(f"server      : makespan {s1['makespan_s']:.2f}s  "
      f"throughput {s1['throughput_rps']:.2f}/s  "
      f"(mean batch {s1['mean_batch']:.2f}, "
      f"{s0['makespan_s'] / s1['makespan_s']:.2f}x)")

# 5. Adaptive scheduling: overload the busiest node, watch the dual-mode
#    scheduler migrate vertices away (paper Fig. 10 diffusion).
t = simulation.measured_exec_times(plan.cluster, session.placement)
plan.cluster.nodes[int(np.argmax(t))].background_load = 2.5
print("scheduler action after overload:", session.adapt(lam=1.2))
print("latency after adaptation:", f"{session.query().latency:.3f}s")
