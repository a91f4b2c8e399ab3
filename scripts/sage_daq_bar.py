#!/usr/bin/env python3
"""SAGE on the mesh's DAQ halo wire, in both packages, against the float64
forward (CPU).

    python3 scripts/sage_daq_bar.py [--scale 1.0] [--kinds sage,gcn]
                                    [--batch 4]

On SIoT at ``--scale``, each kind ``[52, 64, 2]`` (the JAX package's
``gnn_init(PRNGKey(0))`` weights, carried to the port through numpy) is
served on ``executor="mesh-bsp"`` over the default cluster "1A+4B+1C"
(six fogs) with ``compressor="daq"`` and ``aggregation="pallas"``, the
only path whose halo rows cross the wire as 8-bit codes (on the segment-sum
path they cross as f32 in both packages). The JAX package runs in a
subprocess on six host devices, with ``repro.runtime.bsp._shard_map``
rebound as ``tests/test_torch_mesh.py`` does (jax 0.9 renamed
``check_rep``), its Pallas kernels in interpret mode; the port runs its
plain versions on the CPU. Both serve one query and a batch of
``--batch`` (phase 3b's noise: ``default_rng(7)``, scale 0.1) on the
features the JAX session collected, and each output is held to the port's
float64 single-program forward of the same features: the max abs error
over the reference's DAQ bar, 5e-2 * max(max|want|, 1)
(``tests/test_aggregation.py:81``). Equal ratios in both packages put any
excess over the bar on the quantizer, not on the port.

Prints one line per kind, package and example, and one JSON line. This is
a one-off measurement, not a test; it imports both packages.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CLUSTER = "1A+4B+1C"
FOGS = 6
DIMS_HIDDEN, DIMS_OUT = 64, 2
DAQ_BAR = 5e-2                          # tests/test_aggregation.py:81

REFERENCE = textwrap.dedent("""
    import sys, time
    import jax
    import numpy as np
    import repro.runtime.bsp as bsp

    _shard_map = bsp._shard_map

    def _shard_map_compat(f, *args, check_rep=None, **kwargs):
        if check_rep is not None:
            kwargs["check_vma"] = False
        return _shard_map(f, *args, **kwargs)

    bsp._shard_map = _shard_map_compat

    from repro.api import Engine
    from repro.gnn import datasets, models

    out_path, scale, kinds, batch, cluster, hidden, dim_out = sys.argv[1:]
    scale, batch = float(scale), int(batch)
    g = datasets.load("siot", scale=scale, seed=0)
    out = {}
    for kind in kinds.split(","):
        t0 = time.perf_counter()
        params = models.gnn_init(jax.random.PRNGKey(0), kind,
                                 [g.feature_dim, int(hidden), int(dim_out)])
        for i, p in enumerate(params):
            for k, v in p.items():
                out[f"{kind}/param/{i}/{k}"] = np.asarray(v)
        sess = Engine((params, kind), cluster=cluster, compressor="daq",
                      executor="mesh-bsp", aggregation="pallas"
                      ).compile(g).session()
        feats = sess.collect()
        out[f"{kind}/feats"] = feats
        out[f"{kind}/query"] = sess.execute(feats)
        rng = np.random.default_rng(7)
        stack = np.stack([sess.collect(g.features + rng.normal(
            scale=0.1, size=g.features.shape)) for _ in range(batch)])
        out[f"{kind}/stack"] = stack
        out[f"{kind}/batch"] = np.stack(sess.execute_many(stack))
        out[f"{kind}/seconds"] = np.asarray(time.perf_counter() - t0)
        print(kind, "done in", out[f"{kind}/seconds"], flush=True)
    np.savez(out_path, **out)
    print("OK")
""")


def run_reference(path: Path, scale: float, kinds: str, batch: int) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={FOGS}",
               PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(path), str(scale), kinds,
         str(batch), CLUSTER, str(DIMS_HIDDEN), str(DIMS_OUT)],
        env=env, capture_output=True, text=True, check=False)
    if proc.returncode != 0 or "OK" not in proc.stdout:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-4000:])
        raise SystemExit(f"the JAX package's run failed "
                         f"(exit {proc.returncode})")
    print(f"JAX package: {time.perf_counter() - t0:.1f} s "
          f"({proc.stdout.strip().splitlines()[:-1]})", flush=True)
    with np.load(path) as ref:
        return dict(ref)


def bar_errors(got: np.ndarray, want: np.ndarray) -> dict:
    d = np.abs(got.astype(np.float64) - want)
    bar = DAQ_BAR * max(float(np.abs(want).max()), 1.0)
    return {"max_abs": float(d.max()), "bar": bar,
            "ratio": float(d.max()) / bar, "beyond_bar": int((d > bar).sum()),
            "p99_abs": float(np.quantile(d, 0.99))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--kinds", default="sage,gcn")
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.api import Engine
    from repro_torch.gnn import datasets, models
    from repro_torch.gnn.layers import EdgeList

    with tempfile.TemporaryDirectory() as tmp:
        ref = run_reference(Path(tmp) / "reference.npz", args.scale,
                            args.kinds, args.batch)
    g = datasets.load("siot", scale=args.scale, seed=0)
    edges = EdgeList.from_graph(g)
    print(f"SIoT scale {args.scale}: |V|={g.num_vertices} "
          f"|E|={g.num_edges}; {CLUSTER}, mesh-bsp, DAQ halo wire",
          flush=True)
    record = {"scale": args.scale, "cluster": CLUSTER, "batch": args.batch,
              "kinds": {}}
    for kind in args.kinds.split(","):
        layers = {}
        for key, value in ref.items():
            if key.startswith(f"{kind}/param/"):
                _, _, i, name = key.split("/")
                layers.setdefault(int(i), {})[name] = value
        params = [layers[i] for i in sorted(layers)]
        t0 = time.perf_counter()
        sess = Engine((models.params_from_numpy(params), kind),
                      cluster=CLUSTER, compressor="daq", executor="mesh-bsp",
                      aggregation="pallas", device="cpu").compile(g).session()
        feats, stack = ref[f"{kind}/feats"], ref[f"{kind}/stack"]
        if not np.array_equal(sess.collect(), feats):
            raise SystemExit(f"{kind}: the port's DAQ collect differs from "
                             f"the JAX package's")
        port = {"query": sess.execute(feats),
                "batch": np.stack(sess.execute_many(stack))}
        port_s = time.perf_counter() - t0
        p64 = [{k: torch.as_tensor(v, dtype=torch.float64)
                for k, v in p.items()} for p in params]

        def exact(f_in):
            with torch.no_grad():
                return models.gnn_apply(p64, kind, torch.as_tensor(
                    f_in, dtype=torch.float64), edges).numpy()
        examples = [("query", feats, "query", None)] + [
            (f"batch[{b}]", stack[b], "batch", b) for b in range(len(stack))]
        rows = []
        for name, f_in, key, b in examples:
            want = exact(f_in)
            got_ref = ref[f"{kind}/{key}"] if b is None else \
                ref[f"{kind}/{key}"][b]
            got_port = port[key] if b is None else port[key][b]
            row = {"example": name,
                   "jax": bar_errors(got_ref, want),
                   "port": bar_errors(got_port, want),
                   "port_vs_jax_max_abs": float(np.abs(
                       got_port.astype(np.float64) - got_ref).max())}
            rows.append(row)
            print(f"  {kind} {name:9s} ratio to the bar: JAX "
                  f"{row['jax']['ratio']:.4f} (max {row['jax']['max_abs']:.4g},"
                  f" {row['jax']['beyond_bar']} beyond)  port "
                  f"{row['port']['ratio']:.4f} (max "
                  f"{row['port']['max_abs']:.4g}, "
                  f"{row['port']['beyond_bar']} beyond)  port vs JAX max "
                  f"{row['port_vs_jax_max_abs']:.3g}", flush=True)
        record["kinds"][kind] = {
            "jax_seconds": float(ref[f"{kind}/seconds"]),
            "port_seconds": port_s, "examples": rows,
            "max_ratio_jax": max(r["jax"]["ratio"] for r in rows),
            "max_ratio_port": max(r["port"]["ratio"] for r in rows)}
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
