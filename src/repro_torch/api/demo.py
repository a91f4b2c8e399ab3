"""``fograph-demo-torch`` console entry point: the quickstart, end to end.

Trains a small GCN on the SIoT-style graph, compiles a serving plan on a
heterogeneous simulated fog cluster, serves a Poisson arrival trace
through the micro-batching ``Server`` front-end (vs. the cloud baseline),
then overloads the busiest fog and shows the adaptive scheduler reacting
— the full Fig. 5/6 workflow on the Engine/Plan/Session/Server API, on a
CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="siot")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--kind", default="gcn", choices=["gcn", "gat", "sage"])
    ap.add_argument("--cluster", default="1A+4B+1C")
    ap.add_argument("--network", default="wifi")
    ap.add_argument("--compressor", default="daq")
    ap.add_argument("--placement", default="iep")
    ap.add_argument("--executor", default="sim")
    ap.add_argument("--aggregation", default="auto",
                    choices=["segment_sum", "pallas", "auto"],
                    help="shard-local aggregation path (pallas = the "
                         "block-CSR kernels; auto = the kernels on a CUDA "
                         "device)")
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate (req/s) for the trace")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default="cuda",
                    help="torch device of training and serving (cuda, "
                         "cuda:1, cpu)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.api import Engine, traces
    from repro_torch.api.engine import resolve_device
    from repro_torch.core import simulation
    from repro_torch.gnn import datasets, models

    device = resolve_device(args.device)
    graph = datasets.load(args.dataset, scale=args.scale, seed=0)
    # The init is drawn on the host, the same on every device (as the
    # reference's PRNG key is), so the card and --device cpu train alike.
    hidden, classes = 64, int(graph.labels.max()) + 1
    init = models.gnn_init(torch.Generator().manual_seed(0), args.kind,
                           [graph.feature_dim, hidden, classes])
    params, loss = models.train_node_classifier(
        torch.Generator(device=device), args.kind, graph, hidden=hidden,
        steps=args.steps, init=init)
    print(f"trained {args.kind} on |V|={graph.num_vertices} "
          f"|E|={graph.num_edges} (loss {loss:.3f}) on {device}")

    engine = Engine((params, args.kind), cluster=args.cluster,
                    network=args.network, compressor=args.compressor,
                    placement=args.placement, executor=args.executor,
                    aggregation=args.aggregation, device=device)
    plan = engine.compile(graph)
    print("placement (vertices per fog):", plan.vertices_per_fog())
    print(f"estimated makespan: {plan.est_makespan:.3f}s")

    labels = torch.as_tensor(graph.labels)
    acc_fn = lambda emb: float(models.accuracy(  # noqa: E731
        torch.as_tensor(emb), labels))
    server = plan.server(max_batch=args.max_batch, max_wait=0.05,
                         accuracy_fn=acc_fn)
    trace = traces.poisson(args.queries, args.rate, seed=1)
    responses = server.replay(trace)
    for r in responses[:3]:
        print(f"request {r.request_id}: latency {r.latency:.3f}s "
              f"(queue {r.queue_delay:.3f}s, batch of {r.batch_size})  "
              f"wire {r.wire_bytes / 1e3:.1f} KB  "
              f"accuracy {r.accuracy:.4f}  [{r.backend}]")
    s = server.summarize(responses)
    print(f"trace of {s['requests']}: makespan {s['makespan_s']:.2f}s  "
          f"throughput {s['throughput_rps']:.2f}/s  "
          f"p95 latency {s['latency_p95_s']:.3f}s  "
          f"mean batch {s['mean_batch']:.2f}  "
          f"overlap saved {s['overlap_saved_s']:.2f}s")

    session = server.session
    cloud = session.query(executor="cloud")
    # Pin the fog side of the Fig. 3 comparison to a fog backend even when
    # the demo itself was pointed at the cloud executor.
    fog_exec = "sim" if args.executor == "cloud" else args.executor
    fog = session.query(executor=fog_exec)
    print(f"cloud-vs-fog (Fig. 3): cloud {cloud.latency:.3f}s vs "
          f"fog {fog.latency:.3f}s [{fog_exec}] "
          f"({cloud.latency / fog.latency:.2f}x speedup)")

    t = simulation.measured_exec_times(plan.cluster, session.placement)
    plan.cluster.nodes[int(np.argmax(t))].background_load = 2.5
    print("scheduler action after overload:", session.adapt(lam=1.2))
    print(f"latency after adaptation: {session.query().latency:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
