#!/usr/bin/env python3
"""Where a served query's time goes on a CUDA card (the port's main path).

    python3 scripts/profile_query.py [--executor sim|mesh-bsp] [--queries 10]
                                     [--out PATH]
    python3 scripts/profile_query.py --transformer [--out PATH]

Serves full-scale SIoT through ``repro_torch``'s
``Engine(..., executor=EXECUTOR, aggregation="pallas", device="cuda")``
(``--executor``: ``sim``, the default, or ``mesh-bsp``, the 6-fog mesh
with the DAQ halo wire) for GCN and SAGE [52, 64, 2] and reports, per
model, from a ``torch.profiler``
trace of ``--queries`` back-to-back ``execute`` calls and of one
``execute_many`` over 8 feature sets: device busy time (kernels, copies and
fills from the trace, as a union of intervals), the window's host-clock
length, the device's idle share, and device time by kernel name. The
host-clock split of a query into collect / execute / account is
``chip_smoke.py``'s.

With ``--transformer`` it traces the transformer serving path instead:
qwen1.5-0.5b at full width with ``attn_impl="flash"`` (random seeded
weights, served in bf16): one ``transformer.prefill`` of B = 2, S = 4096,
and one served batch as ``repro_torch.launch.serve`` runs it (a prefill of
4 prompts of 16 tokens, then 15 greedy decode steps). Beside the numbers
above it reports the flash kernel's device time and its share of the
window and of the device's busy time.

Prints one JSON object per model and writes them all to ``--out``
(default ``results/profile_query.json``). Needs a CUDA card.
"""
import argparse
import json
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(prof):
    """(start_us, end_us, category, name) of every device event in a trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e["ts"], e["ts"] + e["dur"], e["cat"], e["name"])
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_us(intervals) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e, *_ in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_window(fn, match: str = "") -> dict:
    """Run ``fn`` under the profiler; device busy vs host-clock window.
    With ``match``, also the device time of the kernels whose name holds
    it and their share of the window and of the busy time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    iv = device_intervals(prof)
    if not iv:
        raise RuntimeError("the profiler recorded no device event")
    busy = busy_us(iv)
    by_name = defaultdict(float)
    for s, e, cat, name in iv:
        by_name[f"{cat}:{name[:60]}"] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"window_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "kernel_launches": sum(cat == "kernel" for _, _, cat, _ in iv),
           "device_ms_by_name": {k: v / 1e3 for k, v in top}}
    if match:
        hit = busy_us([x for x in iv if match in x[3]])
        out.update({f"{match}_ms": hit / 1e3,
                    f"{match}_share_of_window": hit / wall_us,
                    f"{match}_share_of_busy": hit / busy})
    return out


def profile_transformer() -> list:
    """The transformer records: a long prefill and one served batch."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import serve as sv
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(registry.get("qwen1.5-0.5b"),
                              attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.cast_params(tf.init_params(cfg, gen), cfg)
    long_toks = torch.randint(0, cfg.vocab_size, (2, 4096), generator=gen,
                              device="cuda")
    reqs = sv.make_requests(cfg, 4, 16)
    plen = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), plen), np.int32)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt
    toks = torch.as_tensor(toks, device="cuda")

    def prefill_long():
        tf.prefill(params, cfg, long_toks)

    def serve_batch():   # serve.py's per-batch loop
        logits, caches = tf.prefill(params, cfg, toks, cache_len=plen + 16)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out = [tok]
        for step in range(15):
            logits, caches = tf.decode_step(params, cfg, caches, tok,
                                            plen + step)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            out.append(tok)
        torch.cat(out, dim=1).cpu()

    recs = []
    with torch.inference_mode():
        for name, fn in (("prefill_B2_S4096", prefill_long),
                         ("serve_batch_B4", serve_batch)):
            fn()                                        # warm-up
            rec = {"arch": cfg.name, "case": name,
                   **profile_window(fn, match="flash_kernel")}
            recs.append(rec)
            print(json.dumps(rec), flush=True)
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--executor", choices=("sim", "mesh-bsp"),
                    default="sim")
    ap.add_argument("--queries", type=int, default=10)
    ap.add_argument("--transformer", action="store_true",
                    help="trace the transformer serving path instead")
    ap.add_argument("--out", default=str(ROOT / "results" /
                                         "profile_query.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_query: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.api import Engine
    from repro_torch.gnn import datasets, models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.transformer:
        out.write_text(json.dumps({
            "device": torch.cuda.get_device_name(0),
            "records": profile_transformer()}, indent=1))
        return 0
    g = datasets.load("siot", 1.0, seed=0)
    report = {"device": torch.cuda.get_device_name(0),
              "executor": args.executor, "models": []}
    for kind in ("gcn", "sage"):
        params = models.gnn_init(torch.Generator(device="cuda").manual_seed(0),
                                 kind, [g.feature_dim, 64, 2])
        sess = Engine((params, kind), executor=args.executor,
                      aggregation="pallas", device="cuda").compile(g).session()
        sess.query()                                   # warm-up
        feats = sess.collect()
        stack = np.stack([feats] * 8)
        sess.execute_many(stack)                       # warm-up
        rec = {"kind": kind, "executor": args.executor,
               "execute": profile_window(lambda: [
                   sess.execute(feats) for _ in range(args.queries)]),
               "execute_many_8": profile_window(
                   lambda: sess.execute_many(stack))}
        rec["execute"]["per_query_ms"] = (rec["execute"]["window_ms"]
                                          / args.queries)
        report["models"].append(rec)
        print(json.dumps(rec), flush=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
