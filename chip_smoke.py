#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

  1. build    nvcc-compiles every CUDA source of ``repro_torch.kernels``
              (sm_90a) into ``build/repro_torch/`` and prints the time.
  2. kernels  holds ``block_spmm`` and ``block_spmm_batched`` against their
              plain PyTorch versions on the card, evaluated in float64 on the
              same inputs (rtol 1e-5 / atol 1e-4), at the main path's shapes
              (full-scale SIoT, F = 52 and 64, B = 8) plus one rectangular
              and one F = 200 case; checks that every batched example is
              bitwise the serial kernel; times kernel, plain version (float32)
              and ``torch.sparse.mm`` with CUDA events.
  3. main     serves GCN and SAGE [52, 64, 2] through
              ``Engine(..., executor="sim", aggregation="pallas",
              device="cuda")`` on full-scale SIoT: a few ``query()`` calls
              and one ``execute_many`` over 8 collected feature sets, with the
              launch counters set to 0 just before and read just after;
              checks K launches per query and per batch, batched == serial
              bitwise, and the embeddings against the float64 forward on the
              card (rtol 1e-4 / atol 1e-5), reporting beside it how far
              ``aggregation="segment_sum"`` lies. Afterwards a small graph is
              served on the card and on the CPU and compared.
  4. report   one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name
              and power limit, and as the last line
              ``{"ok": true, "device": {...}}``.

Without a CUDA card, or without the repository's ``src/`` beside it, the
script exits non-zero before printing any result.
"""
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth
# and the f32 rate of the CUDA cores (the kernels use no tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4   # tests/test_kernels.py
EMB_RTOL, EMB_ATOL = 1e-4, 1e-5         # tests/test_aggregation.py
DIMS_HIDDEN, DIMS_OUT = 64, 2
BATCH = 8
QUERIES = 3

SOURCE = "src/repro_torch/kernels/csrc/block_spmm.cu"
REPLACES = {
    "block_spmm": "src/repro/kernels/gather_aggregate.py:194",
    "block_spmm_batched": "src/repro/kernels/gather_aggregate.py:149",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Max abs error, max rel error (over entries at least 1e-3 of the
    largest magnitude) and the worst |err| / (atol + rtol |want|), which
    is at most 1 where the comparison passes."""
    diff = (got.double() - want.double()).abs()
    mag = want.double().abs()
    big = mag >= 1e-3 * float(mag.max())
    return {
        "max_abs_err": float(diff.max()),
        "max_rel_err": float((diff[big] / mag[big]).max()) if big.any()
        else 0.0,
        "tol_ratio": float((diff / (KERNEL_ATOL + KERNEL_RTOL * mag)).max()),
    }


def bound(real_tiles: int, nonzeros: int, vb: int, m: int, src_rows: int,
          f: int, batch: int) -> tuple:
    """Least time (ms) for one call, the larger of two floors: every input
    byte read once (the real tiles only: padding tiles are skipped) and
    every output byte written once, at the HBM rate; and the multiply-adds
    the function needs, one per nonzero tile entry per feature per example
    (products with a zero entry are not needed), at the f32 CUDA-core
    peak."""
    nbytes = (real_tiles * 128 * 128 * 4 + vb * m * 8
              + batch * (src_rows + vb * 128) * f * 4)
    flops = 2.0 * nonzeros * f * batch
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def adjacency(senders, receivers, rows: int, cols: int, weights=None):
    """The same A as the block-CSR operands, as a torch CSR matrix."""
    idx = torch.as_tensor(np.stack([receivers, senders]).astype(np.int64))
    val = torch.as_tensor(np.ones(len(senders), np.float32)
                          if weights is None else weights)
    coo = torch.sparse_coo_tensor(idx, val, (rows, cols),
                                  check_invariants=True).coalesce()
    with warnings.catch_warnings():   # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        return coo.to_sparse_csr().cuda()


def check_close(name, got, want, rtol, atol):
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = float((got - want).abs().max())
        raise AssertionError(f"{name}: max abs err {err} beyond "
                             f"rtol {rtol} / atol {atol}")


def kernel_cases(ga, ref, csr, g):
    """Phase 2. Returns {kernel: {"cases": [...], main-path sums...}}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    vb, m = csr.blocks.shape[:2]
    real = int(csr.mask.sum())
    nonzeros = int((csr.blocks != 0).sum())
    padded = csr.padded_v
    a_siot = adjacency(g.senders, g.receivers, padded, padded)
    # One rectangular operand set, the shape of a shard's halo table:
    # 2048 output rows reading a 9000-row source.
    rng = np.random.default_rng(1)
    rs = rng.integers(0, 9000, 60000).astype(np.int32)
    rr = rng.integers(0, 2048, 60000).astype(np.int32)
    rb, rc, rm, rpv = ga.build_block_csr(rs, rr, 2048)
    rect = tuple(torch.as_tensor(x).cuda() for x in (rb, rc, rm))
    rect_src = -(-9000 // 128) * 128
    a_rect = adjacency(rs, rr, rpv, rect_src)
    rect_real = int(rm.sum())

    operands = {"siot": ((csr.blocks, csr.cols, csr.mask), padded, a_siot,
                         real, nonzeros, vb, m),
                "rect": (rect, rect_src, a_rect, rect_real,
                         int(np.count_nonzero(rb)), rb.shape[0],
                         rb.shape[1])}
    cases = [("siot", 52, True), ("siot", 64, True), ("rect", 64, False),
             ("siot", 200, False)]
    out = {"block_spmm": {"cases": []}, "block_spmm_batched": {"cases": []}}
    for where, f, main in cases:
        ops_, src_rows, a_lib, n_real, nnz, cvb, cm = operands[where]
        for name, batch in (("block_spmm", 1), ("block_spmm_batched", BATCH)):
            shape = (src_rows, f) if batch == 1 else (batch, src_rows, f)
            h = torch.randn(shape, generator=gen, device="cuda")
            kern = getattr(ga, name)
            plain = (ref.block_spmm_ref if batch == 1
                     else ref.block_spmm_batched_ref)
            got = kern(*ops_, h)
            # The yardstick is the plain version in float64 on the same
            # inputs: it carries no f32 rounding of its own, so the check
            # sees the kernel's error alone. The f32 plain version's error
            # against it is reported beside the kernel's.
            want = plain(ops_[0].double(), ops_[1], ops_[2].double(),
                         h.double())
            err = errors(got, want)
            err["plain_f32_max_abs_err"] = errors(plain(*ops_, h), want)[
                "max_abs_err"]
            check_close(f"{name} {where} F={f}", got.double(), want,
                        KERNEL_RTOL, KERNEL_ATOL)
            if batch > 1:
                for b in range(batch):   # per example == serial, bitwise
                    if not torch.equal(got[b], ga.block_spmm(*ops_, h[b])):
                        raise AssertionError(
                            f"{name} {where} F={f}: example {b} differs "
                            f"from block_spmm")
            # Library yardstick: one sparse product over the [S, B*F] panel
            # that holds the same inputs (the layout change is not timed).
            lib_in = h.permute(1, 0, 2).reshape(src_rows, batch * f) \
                if batch > 1 else h
            lib = lambda: torch.sparse.mm(a_lib, lib_in)  # noqa: E731
            lib_out = lib().reshape(-1, batch, f).permute(1, 0, 2) \
                if batch > 1 else lib()
            check_close(f"torch.sparse.mm {where} F={f}", lib_out.double(),
                        want, KERNEL_RTOL, KERNEL_ATOL)
            k_ms = time_ms(lambda: kern(*ops_, h), reps=20)
            p_ms = time_ms(lambda: plain(*ops_, h), reps=3, warmup=1)
            l_ms = time_ms(lib, reps=20)
            b_ms, b_by = bound(n_real, nnz, cvb, cm, src_rows, f, batch)
            rec = {"case": where, "F": f, "B": batch,
                   "src_rows": src_rows, "out_rows": cvb * 128,
                   "real_tiles": n_real, "tile_slots": cvb * cm,
                   "tile_nonzeros": nnz,
                   "main_path": main, **err, "ms": k_ms, "plain_ms": p_ms,
                   "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by}
            out[name]["cases"].append(rec)
            log(f"  {name:19s} {where:4s} F={f:3d} B={batch} "
                f"err {err['max_abs_err']:.3g} kernel {k_ms:.4f} ms  "
                f"plain {p_ms:.4f} ms  sparse.mm {l_ms:.4f} ms  "
                f"bound {b_ms:.4f} ms ({b_by})")
            del h, got, want, lib_in, lib_out
    return out


def serve(Engine, models, g, kind: str, ga):
    """Phase 3 for one model kind. Returns timings and checks everything."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.gnn_init(gen, kind, [g.feature_dim, DIMS_HIDDEN,
                                         DIMS_OUT])
    k = len(params)
    t0 = time.perf_counter()
    plan = Engine((params, kind), executor="sim", aggregation="pallas",
                  device="cuda").compile(g)
    compile_s = time.perf_counter() - t0
    sess = plan.session()

    def counts():
        return ga.block_spmm.launches, ga.block_spmm_batched.launches

    query_s = []
    for _ in range(QUERIES):
        before = counts()
        t0 = time.perf_counter()
        res = sess.query()
        query_s.append(time.perf_counter() - t0)
        after = counts()
        if after != (before[0] + k, before[1]):
            raise AssertionError(f"{kind}: a query launched "
                                 f"{after[0] - before[0]} block_spmm and "
                                 f"{after[1] - before[1]} batched kernels, "
                                 f"expected {k} and 0")
        if res.embeddings.shape != (g.num_vertices, DIMS_OUT) or \
                not np.isfinite(res.embeddings).all():
            raise AssertionError(f"{kind}: bad embeddings "
                                 f"{res.embeddings.shape}")

    # Stage breakdown of a query (medians over QUERIES): host collect, card
    # execute (ending in the copy back to the host), host account.
    stages = {"collect_ms": [], "execute_ms": [], "account_ms": []}
    for _ in range(QUERIES):
        t0 = time.perf_counter()
        feats = sess.collect()
        t1 = time.perf_counter()
        emb = sess.execute(feats)
        t2 = time.perf_counter()
        sess.account()
        t3 = time.perf_counter()
        for name, s in zip(stages, ((t1 - t0), (t2 - t1), (t3 - t2))):
            stages[name].append(s * 1e3)

    rng = np.random.default_rng(7)
    stack = np.stack([sess.collect(g.features + rng.normal(
        scale=0.1, size=g.features.shape)) for _ in range(BATCH)])
    before = counts()
    t4 = time.perf_counter()
    many = sess.execute_many(stack)
    batch_s = time.perf_counter() - t4
    after = counts()
    if after != (before[0], before[1] + k):
        raise AssertionError(f"{kind}: a batch launched "
                             f"{after[0] - before[0]} block_spmm and "
                             f"{after[1] - before[1]} batched kernels, "
                             f"expected 0 and {k}")
    t5 = time.perf_counter()
    serial = [sess.execute(stack[b]) for b in range(BATCH)]
    serial_s = time.perf_counter() - t5
    for b in range(BATCH):
        if not np.array_equal(many[b], serial[b]):
            raise AssertionError(f"{kind}: batched example {b} is not "
                                 f"bitwise the serial execute")

    # Embeddings against the same forward in float64 on the card (the
    # port's segment-sum layers on float64 parameters and features): a fixed
    # yardstick with no float32 rounding, and the kernel path is
    # deterministic, so this check gives the same verdict on every run.
    # Reported beside it, gating nothing: aggregation="segment_sum" in
    # float32, summed with atomics in a run-dependent order. On SAGE's
    # unit-normalised 2-wide output any two float32 orders move a few
    # entries by ~1e-5, as much as the bar: rows whose pre-normalisation
    # norm is small amplify any rounding.
    p64 = [{n: v.double() for n, v in p.items()} for p in plan.model.params]
    seg = plan.session(aggregation="segment_sum")
    checks = {}
    for name, f_in, got in (("query", feats, emb),
                            ("batch[3]", stack[3], many[3])):
        with torch.no_grad():
            h64 = torch.as_tensor(f_in, dtype=torch.float64, device="cuda")
            exact = models.gnn_apply(p64, kind, h64, plan.edges).cpu().numpy()
        checks[name] = {"pallas_vs_f64": emb_errors(got, exact),
                        "pallas_vs_segment_sum": emb_errors(
                            got, seg.execute(f_in))}
        log(f"  {kind} {name}: " + "  ".join(
            f"{c} max {v['max_abs']:.3g} ratio {v['tol_ratio']:.3g} "
            f"beyond {v['beyond_bar']}" for c, v in checks[name].items()))
    for name in checks:
        if checks[name]["pallas_vs_f64"]["beyond_bar"]:
            raise AssertionError(f"{kind} {name}: pallas vs the float64 "
                                 f"forward beyond rtol {EMB_RTOL} / atol "
                                 f"{EMB_ATOL}")
    return {"kind": kind, "layers": k, "compile_s": compile_s,
            "first_query_ms": query_s[0] * 1e3,
            "query_ms": statistics.median(query_s[1:]) * 1e3,
            **{name: statistics.median(v) for name, v in stages.items()},
            "batch_ms": batch_s * 1e3, "serial_batch_ms": serial_s * 1e3,
            "batch_size": BATCH, "embedding_checks": checks}


def emb_errors(got: np.ndarray, want: np.ndarray) -> dict:
    """Max abs difference, worst |d| / (atol + rtol |want|) and the number
    of entries beyond the embedding bar."""
    d = np.abs(got.astype(np.float64) - want)
    ratio = d / (EMB_ATOL + EMB_RTOL * np.abs(want))
    return {"max_abs": float(d.max()), "tol_ratio": float(ratio.max()),
            "beyond_bar": int((ratio > 1).sum())}


def small_reference(Engine, models, datasets):
    """A small graph served on the card and on the CPU must agree."""
    g = datasets.load("siot", 0.05, seed=0)
    for kind in ("gcn", "sage"):
        params = models.gnn_init(torch.Generator().manual_seed(1), kind,
                                 [g.feature_dim, 16, 8])
        embs = [Engine((params, kind), aggregation="pallas", device=dev,
                       compressor="none").compile(g).session().query()
                .embeddings for dev in ("cuda", "cpu")]
        np.testing.assert_allclose(embs[0], embs[1], rtol=EMB_RTOL,
                                   atol=EMB_ATOL,
                                   err_msg=f"{kind}: card vs CPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.api import Engine
    from repro_torch.gnn import datasets, models
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import gather_aggregate as ga

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.cuda.get_device_name(0)
    log(f"device: {device} x{torch.cuda.device_count()}  torch "
        f"{torch.__version__}  CUDA {torch.version.cuda}")

    log("phase 1: build")
    t0 = time.perf_counter()
    built = build.build()
    log(f"  built {sorted(built) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in build.SOURCES:
        report = Path(str(build.library_path(name)) + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels vs plain versions")
    t0 = time.perf_counter()
    g = datasets.load("siot", 1.0, seed=0)
    csr = ops.block_csr_for(g, device="cuda")
    vb, m = csr.blocks.shape[:2]
    real = int(csr.mask.sum())
    log(f"  siot |V|={g.num_vertices} |E|={g.num_edges} F={g.feature_dim}: "
        f"VB={vb} M={m}, {real} real tiles of {vb * m} slots, "
        f"density {g.num_edges / (real * 128 * 128):.4%} "
        f"(host set-up {time.perf_counter() - t0:.2f} s)")
    results = kernel_cases(ga, ref, csr, g)

    log("phase 3: main path")
    ga.block_spmm.launches = 0
    ga.block_spmm_batched.launches = 0
    served = [serve(Engine, models, g, kind, ga)
              for kind in ("gcn", "sage")]
    launches = {"block_spmm": ga.block_spmm.launches,
                "block_spmm_batched": ga.block_spmm_batched.launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 f"path")
    for s in served:
        log(f"  {s['kind']}: compile {s['compile_s']:.2f} s, query "
            f"{s['query_ms']:.1f} ms (first {s['first_query_ms']:.1f}; "
            f"collect {s['collect_ms']:.1f} / execute "
            f"{s['execute_ms']:.1f} / account {s['account_ms']:.1f}), "
            f"batch of {BATCH} {s['batch_ms']:.1f} ms vs serial "
            f"{s['serial_batch_ms']:.1f} ms")
    log(f"  launches on the main path: {launches}")
    small_reference(Engine, models, datasets)
    log("  small graph: card == CPU within tolerance")

    kernels = []
    for name, rec in results.items():
        main = [c for c in rec["cases"] if c["main_path"]]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            # Main-path numbers: one call per layer shape (F = 52, 64),
            # summed, i.e. the aggregation work of one query / one batch.
            "max_abs_err": max(c["max_abs_err"] for c in rec["cases"]),
            "ms": sum(c["ms"] for c in main),
            "plain_ms": sum(c["plain_ms"] for c in main),
            "bound_ms": sum(c["bound_ms"] for c in main),
            "bound_by": main[-1]["bound_by"],
            "library_ms": sum(c["library_ms"] for c in main),
            "cases": rec["cases"]})
    print(json.dumps({"main_path": served}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
