#!/usr/bin/env python3
"""Phase 2 of ``chip_smoke.py`` for one group of kernels, for a given tree,
so that two trees can be timed in turns on one card.

    python3 scripts/phase2_kernels.py [TREE] [--flash | --segment | --dequant]

TREE (default: this repository) is the root of a checkout that holds
``chip_smoke.py`` and ``src/repro_torch`` (for example the parent commit
unpacked with ``git archive`` under the git-ignored ``build/``). Builds
that tree's kernels and prints the ``ptxas`` report of the source in
question and, as the last line, one JSON object of per-case times and
errors:

* default: the tree's ``kernel_cases`` (``block_spmm(_batched)``) and
  ``dequant_cases`` (``dequant_spmm(_batched)``) on full-scale SIoT and the
  6-fog mesh, with every check they hold;
* ``--flash``: the tree's ``flash_cases`` (``flash_attention``, bf16 and
  f32), with every check they hold;
* ``--segment``: ``Session.execute`` with ``aggregation="segment_sum"`` for
  GCN, SAGE and GAT on the ``sim`` and ``mesh-bsp`` executors on full-scale
  SIoT (host clock ending in the copy back; median of 20 after a warm-up),
  through the public API only, so any tree of the port can run it;
* ``--dequant``: ``daq_dequant.dequant`` on the three tables of the
  ``dequantize`` drive, each unpadded and padded to the reference's
  256 x 128 tiling, and on a streaming 131,072 x 128 uint8 table (device
  time by CUDA events, median of 50; each bitwise the plain version),
  through the public API only, so any tree of the port can run it.

Run ``parent, change, change, parent`` in one call to compare two versions.
Needs a CUDA card.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("tree", nargs="?",
                default=str(Path(__file__).resolve().parents[1]))
group = ap.add_mutually_exclusive_group()
group.add_argument("--flash", action="store_true")
group.add_argument("--segment", action="store_true")
group.add_argument("--dequant", action="store_true")
args = ap.parse_args()
root = Path(args.tree).resolve()
sys.path.insert(0, str(root / "src"))
sys.path.insert(0, str(root))
import numpy as np  # noqa: E402
import torch  # noqa: E402

KEYS = ("case", "F", "B", "codes", "dtype", "S", "dh", "window", "q_offset",
        "ms", "library_ms", "plain_ms", "bound_ms", "max_abs_err",
        "tol_ratio")


def segment_times(Engine, models, g) -> list:
    """Execute times of the segment-sum path, every kind and executor."""
    out = []
    for executor in ("sim", "mesh-bsp"):
        for kind in ("gcn", "sage", "gat"):
            params = models.gnn_init(torch.Generator(device="cuda")
                                     .manual_seed(0), kind,
                                     [g.feature_dim, 64, 2])
            knobs = {"compressor": "daq"} if executor == "mesh-bsp" else {}
            sess = Engine((params, kind), executor=executor,
                          aggregation="segment_sum", device="cuda",
                          **knobs).compile(g).session()
            feats = sess.collect()
            sess.execute(feats)
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                sess.execute(feats)
                times.append((time.perf_counter() - t0) * 1e3)
            stack = np.stack([feats] * 8)
            sess.execute_many(stack)
            t0 = time.perf_counter()
            sess.execute_many(stack)
            out.append({"executor": executor, "kind": kind,
                        "execute_ms": statistics.median(times),
                        "batch8_ms": (time.perf_counter() - t0) * 1e3})
            print(f"  {executor} {kind}: execute {out[-1]['execute_ms']:.3f}"
                  f" ms, batch of 8 {out[-1]['batch8_ms']:.2f} ms",
                  flush=True)
    return out


#: The streaming table of ``--dequant`` (rows, features) and its seed.
STREAM_TABLE, STREAM_SEED = (131_072, 128), 17


def dequant_times(cs, dq, ref, tables) -> list:
    """Device times of the tree's ``dequant`` on each table, unpadded and
    padded, and on the streaming table; each result bitwise the plain
    version."""
    rng = np.random.default_rng(STREAM_SEED)
    v, f = STREAM_TABLE
    stream = (rng.integers(0, 256, (v, f)).astype(np.uint8),
              rng.uniform(0.01, 1, v).astype(np.float32),
              rng.normal(size=v).astype(np.float32))
    runs = [(name, codes, sc, mn, pad) for name, codes, sc, mn, _ in tables
            for pad in (False, True)] + [("streaming", *stream, False)]
    out = []
    for name, codes, sc, mn, pad in runs:
        v, f = codes.shape
        vp, fp = (-(-v // 256) * 256, -(-f // 128) * 128) if pad else (v, f)
        cp = np.zeros((vp, fp), codes.dtype)
        cp[:v, :f] = codes
        c = torch.as_tensor(cp).cuda()
        s_, m_ = (torch.as_tensor(np.pad(x, (0, vp - v))).cuda()
                  for x in (sc, mn))

        def call():
            return dq.dequant(c, s_, m_, v_tile=vp, f_tile=fp)
        if not torch.equal(call(), ref.dequant_ref(c, s_, m_)):
            raise AssertionError(f"dequant {name}: not the plain version")
        ms = cs.time_ms(call, reps=50)
        nbytes = vp * fp * (c.element_size() + 4) + vp * 8
        out.append({"case": name, "V": vp, "F": fp, "padded": pad,
                    "codes": str(c.dtype).removeprefix("torch."), "ms": ms,
                    "gb_per_s": nbytes / ms / 1e6})
        print(f"  dequant {name} [{vp}, {fp}]: {ms:.4f} ms "
              f"({out[-1]['gb_per_s']:.0f} GB/s)", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("phase2_kernels: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.api import Engine
    from repro_torch.gnn import datasets, models
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import daq_dequant as dq
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.runtime import bsp

    if not Path(ga.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ga.__file__}, not the tree {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"tree {root}: built {build.build()}", flush=True)
    source = ("flash_attention" if args.flash else
              "segment_sum" if args.segment else "block_spmm")
    report = Path(str(build.library_path(source)) + ".log")
    for line in report.read_text().splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print("  ptxas", line.strip())
    if args.flash:
        from repro_torch.kernels import flash_attention as fa
        res = cs.flash_cases(fa, ref)
    elif args.segment:
        g = datasets.load("siot", 1.0, seed=0)
        res = {"segment_sum_path": segment_times(Engine, models, g)}
    elif args.dequant:
        from repro_torch.core import compression
        g = datasets.load("siot", 1.0, seed=0)
        res = {"dequant": dequant_times(
            cs, dq, ref, cs.dequant_tables(g, compression, datasets))}
    else:
        g = datasets.load("siot", 1.0, seed=0)
        csr = ops.block_csr_for(g, device="cuda")
        plan, _ = cs.mesh_plan(Engine, models, g, "gcn")
        pg = plan.partitioned
        local, halo = bsp._folded_csrs(pg, plan.device)
        res = cs.kernel_cases(ga, ref, csr, g, local)
        res.update(cs.dequant_cases(ga, dq, ref, bsp, halo,
                                    pg.n * pg.boundary_slots))
    print(json.dumps({
        "tree": str(root), "device": torch.cuda.get_device_name(0),
        "cases": {name: rec if args.segment or args.dequant else
                  [{k: c[k] for k in KEYS if k in c} for c in rec["cases"]]
                  for name, rec in res.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
