#!/usr/bin/env python3
"""How far a frontier query's dirty rows reach on full-scale SIoT (CPU).

    python3 scripts/frontier_reach.py

Host arithmetic only (``core.frontier`` over the graph; no card, no
model): for seeded sets of changed sensors it prints the dirty rows of a
2-layer GNN's frontier (layer 1, layer 2) and how many 128-row blocks
they touch, the quantities that decide whether a cached query takes the
frontier path under the 25 % budget and how much of a block kernel's
launch it skips.

  1. n sensors drawn uniformly, n in 1 / 4 / 16 / 64 / 256, five draws
     each (``default_rng(0)``), then the layer-2 ball of single sensors
     (every 7th vertex) as percentiles;
  2. from the same generator, n in 16 / 64 / 256 drawn from the vertices
     of in-degree at most 0 / 1 / 2 / 4, four draws each;
  3. ``default_rng(6)``: n in 8 / 16 / 64 / 256 leaf sensors (in-degree at
     most 1), rows and row blocks per layer.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import frontier  # noqa: E402
from repro_torch.gnn import datasets  # noqa: E402

LAYERS = 2
BLOCK = 128
NO_EXTRA = np.empty((0, 2), np.int64)


def reach(g, seeds):
    return frontier.expand_frontier(g, np.unique(seeds), NO_EXTRA, LAYERS)


def main() -> int:
    g = datasets.load("siot", 1.0, seed=0)
    v = g.num_vertices
    deg = np.bincount(g.receivers, minlength=v)
    print(f"siot |V|={v} |E|={g.num_edges} in-degree percentiles "
          f"10/25/50/75/90: {np.percentile(deg, [10, 25, 50, 75, 90])}; "
          f"{-(-v // BLOCK)} row blocks; budget {v // 4} rows")
    rng = np.random.default_rng(0)
    for n in (1, 4, 16, 64, 256):
        sizes = [tuple(len(r) for r in reach(g, rng.choice(v, n,
                                                           replace=False)))
                 for _ in range(5)]
        print(f"uniform n={n}: (layer 1, layer 2) rows {sizes}")
    single = [len(reach(g, [u])[-1]) for u in range(0, v, 7)]
    print(f"single sensor layer-2 rows, percentiles 5/25/50/75/95: "
          f"{np.percentile(single, [5, 25, 50, 75, 95])}")
    for max_deg in (0, 1, 2, 4):
        pool = np.flatnonzero(deg <= max_deg)
        for n in (16, 64, 256):
            sizes = [tuple(len(r) for r in reach(
                g, rng.choice(pool, n, replace=False))) for _ in range(4)]
            print(f"in-degree <= {max_deg} ({len(pool)} sensors) n={n}: "
                  f"rows {sizes}")
    rng = np.random.default_rng(6)
    leaf = np.flatnonzero(deg <= 1)
    for n in (8, 16, 64, 256):
        rows = reach(g, rng.choice(leaf, n, replace=False))
        print(f"leaf n={n}: rows {[len(r) for r in rows]}, row blocks "
              f"{[len(np.unique(r // BLOCK)) for r in rows]} of "
              f"{-(-v // BLOCK)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
