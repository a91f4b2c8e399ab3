#!/usr/bin/env python3
"""Phase 2 of ``chip_smoke.py`` for one group of kernels, for a given tree,
so that two trees can be timed in turns on one card.

    python3 scripts/phase2_kernels.py [TREE] [--flash | --segment | --mesh
                                              | --dequant | --serve
                                              | --activations | --scan-bwd]

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
* ``--mesh``: ``Session.execute`` of the folded ``mesh-bsp`` executor
  (no process group) for GCN and SAGE on full-scale SIoT: the DAQ and the
  f32 halo wire of ``aggregation="pallas"`` and ``aggregation=
  "segment_sum"``, timed as ``--segment``, through the public API only, so
  any tree of the port can run it;
* ``--dequant``: ``daq_dequant.dequant`` on the three tables of the
  ``dequantize`` drive, each unpadded and padded to the reference's
  256 x 128 tiling, and on a streaming 131,072 x 128 uint8 table (device
  time by CUDA events, median of 50; each bitwise the plain version),
  through the public API only, so any tree of the port can run it;
* ``--serve``: ``launch.serve.serve`` of qwen1.5-0.5b at full width with
  the flash kernel and ``chip_smoke.SERVE``'s traffic, four times (the
  first a warm-up): tokens/s and the median decode ms a step of each
  run; then phase 3e's bf16 prefill (B = 2, S = 4096, the served copy)
  six times, the first a warm-up (host clock ending in a sync). Through
  the public API only, so any tree of the port can run it.
* ``--activations``: the same serve and prefill in one process, the
  MLP's activation switched in turns between JAX's formula written op by
  op (``models.layers.silu``, the port's since it serves the non-dense
  configs) and PyTorch's fused ``F.silu`` (``ABBA`` order, ``ROUNDS``
  rounds, after a warm-up of each): what the op-by-op form costs the
  dense path, apart from the noise between processes. Needs a tree
  whose ``models.layers`` has ``silu``.
* ``--scan-bwd``: the tree's ``recurrence_bwd_cases`` (``selective_scan_bwd``
  and ``rglru_scan_bwd``: each case against the float64 plain backward,
  bitwise run to run, timed), after the two backward kernels' SASS sizes
  (``sass_blocks``); a few minutes where the whole ``chip_smoke.py`` takes
  twelve. Needs a tree whose ``kernels.recurrence`` has the scans'
  backward (``_selective_bwd``, ``_rglru_bwd``).

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
group.add_argument("--mesh", action="store_true")
group.add_argument("--dequant", action="store_true")
group.add_argument("--serve", action="store_true")
group.add_argument("--activations", action="store_true")
group.add_argument("--scan-bwd", action="store_true")
args = ap.parse_args()
root = Path(args.tree).resolve()
sys.path.insert(0, str(root / "src"))
sys.path.insert(0, str(root))
import numpy as np  # noqa: E402
import torch  # noqa: E402

KEYS = ("case", "F", "B", "codes", "dtype", "S", "dh", "window", "q_offset",
        "width", "ms", "library_ms", "plain_ms", "bound_ms", "max_abs_err",
        "tol_ratio", "bitwise")


def execute_times(sess, **rec) -> dict:
    """``rec`` with the session's median execute ms of 20 (after a
    warm-up; host clock ending in the copy back) and one batch of 8."""
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
    rec.update(execute_ms=statistics.median(times),
               batch8_ms=(time.perf_counter() - t0) * 1e3)
    print(f"  {' '.join(str(v) for v in rec.values() if isinstance(v, str))}"
          f": execute {rec['execute_ms']:.3f} ms, batch of 8 "
          f"{rec['batch8_ms']:.2f} ms", flush=True)
    return rec


def gnn_params(models, g, kind: str):
    return models.gnn_init(torch.Generator(device="cuda").manual_seed(0),
                           kind, [g.feature_dim, 64, 2])


def segment_times(Engine, models, g) -> list:
    """Execute times of the segment-sum path, every kind and executor."""
    out = []
    for executor in ("sim", "mesh-bsp"):
        for kind in ("gcn", "sage", "gat"):
            knobs = {"compressor": "daq"} if executor == "mesh-bsp" else {}
            sess = Engine((gnn_params(models, g, kind), kind),
                          executor=executor, aggregation="segment_sum",
                          device="cuda", **knobs).compile(g).session()
            out.append(execute_times(sess, executor=executor, kind=kind))
    return out


def mesh_times(Engine, models, g) -> list:
    """Execute times of the folded mesh: GCN and SAGE, each on the DAQ
    wire, the f32 wire and the segment sum."""
    out = []
    for kind in ("gcn", "sage"):
        plan = Engine((gnn_params(models, g, kind), kind),
                      executor="mesh-bsp", aggregation="pallas",
                      compressor="daq", device="cuda").compile(g)
        for wire, knobs in (("daq", {}), ("f32", {"compressor": "none"}),
                            ("segment", {"aggregation": "segment_sum"})):
            out.append(execute_times(plan.session(**knobs), kind=kind,
                                     wire=wire))
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


def qwen_serve(cs):
    """qwen1.5-0.5b at full width (flash) from seeded weights, and two
    callables: one serve of SERVE's traffic, returning tokens/s and the
    median decode ms a step; one bf16 prefill of B = PREFILL_B, S =
    PREFILL_S through the served copy, returning its ms."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch import serve as sv
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(registry.get(cs.ARCH), attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen)
    served = tf.cast_params(params, cfg)
    toks = torch.randint(0, cfg.vocab_size, (cs.PREFILL_B, cs.PREFILL_S),
                         generator=gen, device="cuda")

    def serve():
        res = sv.serve(cfg, device="cuda", params=params, log=None,
                       **cs.SERVE)
        return {"tokens_per_s": res["tokens_per_s"],
                "decode_ms_per_step_median": statistics.median(
                    b["decode_ms"] / b["decode_steps"]
                    for b in res["batches"][1:])}

    def prefill():
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tf.prefill(served, cfg, toks)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    return serve, prefill


def serve_times(cs) -> dict:
    """Four serves and six long prefills; the first of each a warm-up."""
    serve, prefill = qwen_serve(cs)
    out = {"serve": [], "prefill_ms": []}
    for run in range(4):
        out["serve"].append({"run": run, **serve()})
        print(f"  serve run {run}: {out['serve'][-1]['tokens_per_s']:.1f} "
              f"tok/s, decode "
              f"{out['serve'][-1]['decode_ms_per_step_median']:.2f} ms a "
              f"step", flush=True)
    out["prefill_ms"] = [prefill() for _ in range(6)]
    print(f"  prefill B={cs.PREFILL_B} S={cs.PREFILL_S} bf16: "
          f"{out['prefill_ms']} ms", flush=True)
    return out


#: Rounds of the activation A/B; each runs both variants, ABBA.
ROUNDS = 8


def activation_times(cs) -> dict:
    """``--activations``: per variant, ROUNDS serves and 2 ROUNDS long
    prefills in turns, after a warm-up of each; the medians and every
    reading."""
    import torch.nn.functional as F
    from repro_torch.models import layers
    variants = {"jax": dict(layers._ACTIVATIONS),
                "fused": {"silu": F.silu,
                          "gelu": lambda x: F.gelu(x, approximate="tanh")}}
    serve, prefill = qwen_serve(cs)
    out = {v: {"decode_ms_per_step": [], "tokens_per_s": [],
               "prefill_ms": []} for v in variants}
    for r in range(ROUNDS + 1):
        order = ("jax", "fused") if r % 2 else ("fused", "jax")
        for v in order:
            layers._ACTIVATIONS.update(variants[v])
            sr = serve()
            pr = [prefill(), prefill()]
            if r == 0:
                continue   # the warm-up
            out[v]["decode_ms_per_step"].append(
                sr["decode_ms_per_step_median"])
            out[v]["tokens_per_s"].append(sr["tokens_per_s"])
            out[v]["prefill_ms"].extend(pr)
    layers._ACTIVATIONS.update(variants["jax"])
    for v, rec in out.items():
        rec["median"] = {k: statistics.median(x) for k, x in rec.items()}
        print(f"  {v:5s}: decode {rec['median']['decode_ms_per_step']:.3f} "
              f"ms a step, {rec['median']['tokens_per_s']:.1f} tok/s, "
              f"prefill {rec['median']['prefill_ms']:.3f} ms (medians of "
              f"{ROUNDS} / {ROUNDS} / {2 * ROUNDS})", flush=True)
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
              "segment_sum" if args.segment else
              "recurrence" if args.scan_bwd else "block_spmm")
    report = Path(str(build.library_path(source)) + ".log")
    for line in report.read_text().splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print("  ptxas", line.strip())
    if args.serve:
        res = {"serve": serve_times(cs)}
    elif args.activations:
        res = {"activations": activation_times(cs)}
    elif args.scan_bwd:
        import subprocess
        from repro_torch.kernels import recurrence as rc
        cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build.library_path("recurrence"))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for kernel in ("selective_scan_bwd_kernel", "rglru_scan_bwd_kernel"):
            total, (block, exps), (eblock, eexps) = cs.sass_blocks(sass,
                                                                   kernel)
            print(f"  {kernel} SASS: {total} instructions; longest "
                  f"straight-line block {block} ({exps} MUFU.EX2), longest "
                  f"with an exp {eblock} ({eexps} MUFU.EX2)", flush=True)
        res = cs.recurrence_bwd_cases(rc, ref)
    elif args.flash:
        from repro_torch.kernels import flash_attention as fa
        res = cs.flash_cases(fa, ref)
    elif args.segment:
        g = datasets.load("siot", 1.0, seed=0)
        res = {"segment_sum_path": segment_times(Engine, models, g)}
    elif args.mesh:
        g = datasets.load("siot", 1.0, seed=0)
        res = {"mesh_path": mesh_times(Engine, models, g)}
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
        "cases": {name: rec if args.segment or args.mesh or args.dequant
                  or args.serve or args.activations
                  else [{k: c[k] for k in KEYS if k in c}
                        for c in rec["cases"]]
                  for name, rec in res.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
