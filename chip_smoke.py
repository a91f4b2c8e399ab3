#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

  1. build    nvcc-compiles every CUDA source of ``repro_torch.kernels``
              (sm_90a) into ``build/repro_torch/`` and prints the time, the
              ``ptxas`` report and the number of ``HGMMA`` (wgmma) and
              ``UTMALDG`` (TMA load) instructions in the flash library's
              SASS (``cuobjdump -sass``; none fails the run).
  2. kernels  holds each kernel against its plain PyTorch version on the
              card, evaluated in float64 on the same inputs (rtol 1e-5 /
              atol 1e-4), at the main paths' shapes, and checks that every
              batched example is bitwise the serial kernel; times kernel,
              plain version (float32) and a library yardstick with CUDA
              events (behind a spin kernel, so that they time the card and
              not the wrapper's host work, which is timed apart):
                block_spmm(_batched): full-scale SIoT (the single-program
                path) and the mesh's folded local operand, F = 52 and 64,
                B = 1 and 8, plus one rectangular and one F = 200 case,
                over each operand's ``compact_block_csr`` rows (the time to
                build them is printed beside the Engine compile time), and
                also held to the rows plain version in float64; on CUDA
                without ``rows`` the wrappers must raise; yardstick
                ``torch.sparse.mm``;
                dequant_spmm(_batched): the mesh's folded halo operand over
                its 16,128-row table with uint8 wire codes, F = 52 and 64,
                B = 1 and 8, plus one uint16 and one rectangular case, over
                the same compacted rows; held to the dense plain version
                and to the rows plain version in float64 (which agree to
                1e-12); on CUDA without ``rows`` the wrappers must raise;
                also bitwise ``block_spmm`` over the plain dequantized
                table. Both walk the compacted rows, so that check holds
                the dequantizing loader to the f32 one; no dense tile
                kernel is left to witness on the card that the compacted
                walk gives the dense tile body's floats (the CPU tests hold
                the rows plain version to the dense one in float64);
                yardstick ``codes.float() * s + m`` then
                ``torch.sparse.mm`` (two calls);
                flash_attention (plain version in float64 per head; f32
                at rtol 1e-5 / atol 1e-4, bf16 within one bf16 rounding:
                rtol 2**-8 + 1e-5 / atol 1e-4): qwen1.5-0.5b prefill B = 2,
                H = 16, dh = 64, S = T = 4096 in bf16 and f32, its serve
                shape (B = 4, S = 16), starcoder2's GQA (H = 24, KV = 2,
                dh = 128, S = 2048), a dh = 32 case, a window = 4096 case
                at S = 8192 and a q_offset case (S = 1024 against T =
                4096), the last two in f32 and in bf16 (every bf16 head dim
                and mask branch of the wgmma kernel); yardstick
                ``F.scaled_dot_product_attention``;
                segment_sum: the fused gather-and-sum at the layers'
                inputs: full-scale SIoT's edge list over its table (F = 52
                and 64, the sim path's widths), GAT's self-looped list
                (weighted messages at F = 64 and 2, and the F = 1
                denominators) and the mesh's folded halo list, held to the
                float64 plain version and bitwise to the old composition
                (messages gathered, masked and weighted, then summed); two
                launches bitwise equal; reported: how far the card lies
                from the CPU port (the same order, so 0 is expected), for
                the kernel and for ``layers.aggregate_sum``; the old
                composition's time, the longest segment summed alone and
                one launch over one empty segment (the launch floor of
                these timings); yardsticks ``index_add_`` on the
                messages and ``torch.sparse.mm`` of the summed edges as a
                CSR matrix, the faster as the library time;
                dequant: the uint8 and uint16 groups of ``daq_pack`` on
                full-scale SIoT features (also against ``daq_unpack``'s
                float64) and benchmarks/run.py's 128-feature shape, each
                as ``ops.dequantize_features`` sends it (unpadded) and
                padded to the reference's 256 x 128 tiling, plus a
                streaming 131,072 x 128 uint8 table, all bitwise the plain
                version; yardstick ``codes.float() * s + m``.
  3. main     serves GCN and SAGE [52, 64, 2] through
              ``Engine(..., executor="sim", aggregation="pallas",
              device="cuda")`` on full-scale SIoT: a few ``query()`` calls
              and one ``execute_many`` over 8 collected feature sets, with the
              launch counters set to 0 just before and read just after;
              checks K launches per query and per batch, batched == serial
              bitwise, and the embeddings against the float64 forward on the
              CPU (rtol 1e-4 / atol 1e-5). Then, driven on their own with
              the counters set to 0 again, GCN, SAGE and GAT on
              ``aggregation="segment_sum"``: two executes of the same input
              bitwise equal, an ``execute_many`` of 8 bitwise 8 serial
              executes, exactly K (GAT 2K) segment-sum launches an execute
              and 8 times that a batch, and the embeddings against the
              float64 forward on the CPU at the same bar (gating GCN and
              GAT, printed for SAGE), with their execute times.
  3b. mesh    serves the same models through ``Engine(...,
              executor="mesh-bsp", aggregation="pallas", compressor="daq",
              device="cuda")`` (6 fogs, the default cluster), counters again
              set to 0 just before: a few queries and one ``execute_many``
              of 8; checks K ``block_spmm`` + K ``dequant_spmm`` per query,
              K ``block_spmm_batched`` + K ``dequant_spmm_batched`` per
              batch, batched == serial bitwise, the embeddings within the
              reference's DAQ bar of the float64 forward (|d| <= 5e-2 *
              max(max|want|, 1); gating the kinds in DAQ_GATED_KINDS,
              printed for all), and one ``compressor="none"`` query (2K
              ``block_spmm``) at rtol 1e-4 / atol 1e-5; then, driven on
              their own, the segment-sum gates of phase 3 on the mesh
              (its halo rows cross as f32 there). Afterwards a small
              graph is served on the card and on the CPU, on both
              executors, and compared.
  3c. dequantize  ``ops.dequantize_features(..., device="cuda")`` on the
              same three code tables (one ``dequant`` launch each), held
              bitwise to the plain version.
  3d. serve   ``repro_torch.launch.serve.serve`` with qwen1.5-0.5b at full
              width (``attn_impl="flash"``, random seeded weights) and the
              reference's serve defaults: 24 requests of 16 tokens, pods
              1.0/1.6/2.4, batches of 4, "iep" placement; checks exactly
              24 flash launches per prefill (decode launches none).
  3e. prefill ``transformer.prefill`` at full width, B = 2, S = 4096:
              bf16 through the kernel (the served dtype, timed); an
              f32-activation copy through the kernel gated against the
              same prefill on the plain ``"chunked"`` path (last-token
              logits, rtol 1e-4 / atol 1e-4, TF32 off); reported, not
              gated: the bf16 logits' distance from it and how many of 8
              greedy tokens agree. Afterwards a reduced qwen1.5-0.5b is
              served on the card and on the CPU and compared.
  4. report   one ``{"kernels": [...]}`` JSON line (all seven kernels), the
              ``nvidia-smi`` name and power limit, and as the last line
              ``{"ok": true, "device": {...}}``. A kernel's top-level
              numbers sum its main-path cases on the path named in
              ``ROW_PATH`` (one call per layer shape: the aggregation work
              of one query or one batch; one attention layer of the
              S = 4096 prefill; one ``dequantize`` drive); ``launches``
              sums the counts of every path driven.

Without a CUDA card, or without the repository's ``src/`` beside it, the
script exits non-zero before printing any result.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# the f32 rate of the CUDA cores and the dense bf16 tensor-core rate (the
# floor of a bf16 attention, whatever this kernel uses).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4   # tests/test_kernels.py
EMB_RTOL, EMB_ATOL = 1e-4, 1e-5         # tests/test_aggregation.py
DAQ_BAR = 5e-2                          # tests/test_aggregation.py:81
#: Kinds whose mesh checks against the float64 forward gate the run. The
#: DAQ wire's bar gates GCN only: on SAGE's L2-normalised 2-wide output the
#: 8-bit halo error itself reaches the bar at full scale (ROADMAP Queue 3);
#: SAGE's numbers are printed beside it.
DAQ_GATED_KINDS = ("gcn",)
F32_WIRE_GATED_KINDS = ("gcn", "sage")
#: One bf16 rounding of the float64 result (half an ulp, relative) on top
#: of the f32 kernel bar: a bf16 output is the f32 result rounded once.
BF16_RTOL = 2.0 ** -8 + KERNEL_RTOL
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4     # tests/test_flash_attention.py:74
DIMS_HIDDEN, DIMS_OUT = 64, 2
BATCH = 8
QUERIES = 3
ARCH = "qwen1.5-0.5b"
#: The reference's serve defaults (src/repro/launch/serve.py:main).
SERVE = dict(requests=24, tokens=16, pods="1.0,1.6,2.4", batch_size=4,
             placement="iep")
PREFILL_B, PREFILL_S = 2, 4096
GREEDY = 8
#: Kinds held to segment-sum determinism on the card (GAT has no other
#: path), and the segment sums a layer of each launches (GAT: its softmax
#: denominators and its weighted messages).
SEGMENT_KINDS = ("gcn", "sage", "gat")
SEGMENT_SUMS = {"gcn": 1, "sage": 1, "gat": 2}
#: Kinds whose segment-sum embeddings (both executors) gate the run
#: against the float64 forward at the embedding bar. SAGE's are printed: its
#: unit-normalised 2-wide rows amplify any float32 rounding of a row with
#: a small norm to about the bar, so whether a float32 forward passes
#: depends on the weights drawn (the pallas path's SAGE gate in phase 3
#: holds at its seed).
SEGMENT_F64_GATED_KINDS = ("gcn", "gat")

CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"block_spmm": CSRC + "block_spmm.cu",
           "block_spmm_batched": CSRC + "block_spmm.cu",
           "dequant_spmm": CSRC + "block_spmm.cu",
           "dequant_spmm_batched": CSRC + "block_spmm.cu",
           "dequant": CSRC + "block_spmm.cu",
           "flash_attention": CSRC + "flash_attention.cu",
           "segment_sum": CSRC + "segment_sum.cu"}
REPLACES = {
    "block_spmm": "src/repro/kernels/gather_aggregate.py:194",
    "block_spmm_batched": "src/repro/kernels/gather_aggregate.py:149",
    "dequant_spmm": "src/repro/kernels/daq_dequant.py:85",
    "dequant_spmm_batched": "src/repro/kernels/daq_dequant.py:149",
    "dequant": "src/repro/kernels/daq_dequant.py:38",
    "flash_attention": "src/repro/kernels/flash_attention.py:67",
    # Not a Pallas kernel: the XLA segment sum of the reference's layers.
    "segment_sum": "src/repro/gnn/layers.py:67",
}
#: The path whose main-path cases make a kernel's top-level numbers.
ROW_PATH = {"block_spmm": "sim", "block_spmm_batched": "sim",
            "dequant_spmm": "mesh", "dequant_spmm_batched": "mesh",
            "dequant": "dequantize", "flash_attention": "prefill",
            "segment_sum": "sim"}
#: The mesh path's four block kernels, in the order its counts are read.
MESH_KERNELS = ("block_spmm", "block_spmm_batched", "dequant_spmm",
                "dequant_spmm_batched")
#: The kernels each driven path must launch.
PATH_KERNELS = {"sim": ("block_spmm", "block_spmm_batched"),
                "sim-segment": ("segment_sum",),
                "mesh": MESH_KERNELS,
                "mesh-segment": ("segment_sum",),
                "dequantize": ("dequant",),
                "serve": ("flash_attention",),
                "prefill": ("flash_attention",)}


def log(msg: str) -> None:
    print(msg, flush=True)


#: Cycles of the spin kernel queued before each timed call (about 0.5 ms):
#: the card is still busy with it while the host enqueues the call, so the
#: events around the call time the card, not the host's wrapper work.
SPIN_CYCLES = 1_000_000


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call
    (each call queued behind a spin kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def errors(got: torch.Tensor, want: torch.Tensor, rtol: float = KERNEL_RTOL,
           atol: float = KERNEL_ATOL) -> dict:
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
        "tol_ratio": float((diff / (atol + rtol * mag)).max()),
    }


def host_us(fn, calls: int = 50) -> float:
    """Host time of one call of ``fn`` in microseconds (the wrapper's checks
    and the launch), over ``calls`` calls that the card keeps up with."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bound(nonzeros: int, vb: int, m: int, src_rows: int, f: int, batch: int,
          code_bytes: int = 4, row_bytes: int = 0) -> tuple:
    """Least time (ms) for one call of a block-CSR product, the larger of
    two floors: every byte the function needs read once and every output
    byte written once, at the HBM rate; and one multiply-add per nonzero
    per feature per example, at the f32 CUDA-core peak. The adjacency
    needs 8 bytes per nonzero tile entry (its value and source index;
    products with a zero entry are not needed) and the slots' columns and
    mask; the source table ``code_bytes`` per entry plus ``row_bytes`` of
    row parameters per row; both counted for this call's operand."""
    nbytes = (nonzeros * 8 + vb * m * 8
              + batch * (src_rows * (f * code_bytes + row_bytes)
                         + vb * 128 * f * 4))
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


def tile_adjacency(blocks, cols, mask, src_rows: int):
    """A block-CSR operand's A as a torch CSR matrix on the card."""
    real = (mask != 0)[:, :, None, None] & (blocks != 0)
    i, t, r, k = real.nonzero(as_tuple=True)
    idx = torch.stack([i * 128 + r, cols[i, t].long() * 128 + k])
    coo = torch.sparse_coo_tensor(idx, blocks[i, t, r, k],
                                  (blocks.shape[0] * 128, src_rows)
                                  ).coalesce()
    with warnings.catch_warnings():   # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        return coo.to_sparse_csr()


def operand_stats(blocks, mask) -> tuple:
    """(real tiles, nonzero tile entries, VB, M) of a block-CSR operand."""
    return (int(mask.sum()), int((blocks != 0).sum()), blocks.shape[0],
            blocks.shape[1])


def compaction_ms(ga, op, rows, built_by: str, built_s: float) -> dict:
    """Time ``compact_block_csr`` on a full-scale operand (median of 3, on
    the card), check it rebuilds the operand's cached rows, and print it
    beside the time of the build that made the operand."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = ga.compact_block_csr(op.blocks, op.cols, op.mask)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for field in ("row_ptr", "seg_ptr", "seg_w", "src", "val", "warp_rows",
                  "split"):
        if not torch.equal(getattr(again, field), getattr(rows, field)):
            raise AssertionError(f"compact_block_csr is not deterministic: "
                                 f"{field}")
    rec = {"ms": statistics.median(times), "nonzeros": rows.nnz,
           "segments": rows.n_seg, "split_rows": len(rows.split),
           "tiles": list(rows.tiles), "built_by": built_by,
           "built_s": built_s}
    log(f"  compact_block_csr {list(rows.tiles)}: {rec['ms']:.2f} ms "
        f"({rows.nnz} nonzeros, {rows.n_seg} segments, {len(rows.split)} "
        f"rows split over a CTA); {built_by} {built_s:.2f} s")
    return rec


def check_close(name, got, want, rtol, atol):
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = float((got - want).abs().max())
        raise AssertionError(f"{name}: max abs err {err} beyond "
                             f"rtol {rtol} / atol {atol}")


def kernel_cases(ga, ref, csr, g, local):
    """Phase 2, block kernels. ``local`` is the mesh's folded local
    operand. Returns {kernel: {"cases": [...]}}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
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
    mesh_ops = (local.blocks, local.cols, local.mask)

    # Each operand with its rows and largest column block, as the main
    # path passes them (without max_col a wrapper reads block_cols back
    # from the card for its bounds check, a sync in every timed call).
    operands = {
        "siot": ((csr.blocks, csr.cols, csr.mask), csr.rows, csr.max_col,
                 padded, a_siot, operand_stats(csr.blocks, csr.mask)),
        "rect": (rect, ga.compact_block_csr(*rect), int(rc.max()), rect_src,
                 a_rect, operand_stats(*rect[::2])),
        "mesh_local": (mesh_ops, local.rows, local.max_col, local.src_rows,
                       tile_adjacency(*mesh_ops, local.src_rows),
                       operand_stats(local.blocks, local.mask))}
    # On a CUDA tensor the wrappers need the compacted operand: no fallback.
    for name in ("block_spmm", "block_spmm_batched"):
        h = torch.zeros((1,) * (name != "block_spmm") + (padded, 8),
                        device="cuda")
        try:
            getattr(ga, name)(csr.blocks, csr.cols, csr.mask, h)
        except ValueError as e:
            if "compact_block_csr" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran on CUDA without rows")
    cases = [("siot", 52, "sim"), ("siot", 64, "sim"),
             ("mesh_local", 52, "mesh"), ("mesh_local", 64, "mesh"),
             ("rect", 64, None), ("siot", 200, None)]
    out = {"block_spmm": {"cases": []}, "block_spmm_batched": {"cases": []}}
    for where, f, path in cases:
        ops_, rows, max_col, src_rows, a_lib, (n_real, nnz, cvb, cm) = \
            operands[where]
        if rows.nnz != nnz:
            raise AssertionError(f"{where}: {rows.nnz} compacted entries, "
                                 f"{nnz} nonzero tile entries")
        for name, batch in (("block_spmm", 1), ("block_spmm_batched", BATCH)):
            shape = (src_rows, f) if batch == 1 else (batch, src_rows, f)
            h = torch.randn(shape, generator=gen, device="cuda")
            kern = getattr(ga, name)
            plain = (ref.block_spmm_ref if batch == 1
                     else ref.block_spmm_batched_ref)
            rows_plain = (ref.block_spmm_rows_ref if batch == 1
                          else ref.block_spmm_rows_batched_ref)

            def call():
                return kern(*ops_, h, rows=rows, max_col=max_col)
            got = call()
            # The yardstick is the plain version in float64 on the same
            # inputs: it carries no f32 rounding of its own, so the check
            # sees the kernel's error alone. The kernel is held to the
            # dense plain version over the tiles and to the plain version
            # over the compacted rows; the f32 plain versions' errors
            # against it are reported beside the kernel's.
            want = plain(ops_[0].double(), ops_[1], ops_[2].double(),
                         h.double())
            want_rows = rows_plain(rows, h.double())
            err = errors(got, want)
            err["rows_f64_max_abs_err"] = errors(got, want_rows)[
                "max_abs_err"]
            err["plain_f32_max_abs_err"] = errors(plain(*ops_, h), want)[
                "max_abs_err"]
            err["rows_plain_f32_max_abs_err"] = errors(
                rows_plain(rows, h), want)["max_abs_err"]
            check_close(f"{name} {where} F={f}", got.double(), want,
                        KERNEL_RTOL, KERNEL_ATOL)
            check_close(f"{name} {where} F={f} vs rows", got.double(),
                        want_rows, KERNEL_RTOL, KERNEL_ATOL)
            if batch > 1:
                for b in range(batch):   # per example == serial, bitwise
                    if not torch.equal(got[b], ga.block_spmm(
                            *ops_, h[b], rows=rows, max_col=max_col)):
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
            k_ms = time_ms(call, reps=30)
            p_ms = time_ms(lambda: rows_plain(rows, h), reps=5, warmup=1)
            l_ms = time_ms(lib, reps=30)
            b_ms, b_by = bound(nnz, cvb, cm, src_rows, f, batch)
            rec = {"case": where, "F": f, "B": batch,
                   "src_rows": src_rows, "out_rows": cvb * 128,
                   "real_tiles": n_real, "tile_slots": cvb * cm,
                   "tile_nonzeros": nnz, "segments": rows.n_seg,
                   "split_rows": len(rows.split),
                   "path": path, **err, "ms": k_ms, "plain_ms": p_ms,
                   "library_ms": l_ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "host_us": host_us(call),
                   "library_host_us": host_us(lib)}
            out[name]["cases"].append(rec)
            log(f"  {name:19s} {where:10s} F={f:3d} B={batch} "
                f"err {err['max_abs_err']:.3g} kernel {k_ms:.4f} ms  "
                f"plain {p_ms:.4f} ms  sparse.mm "
                f"{l_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  host "
                f"{rec['host_us']:.1f} us (sparse.mm "
                f"{rec['library_host_us']:.1f})")
            del h, got, want, want_rows, lib_in, lib_out
    return out


def wire_codes(bsp, gen, rng, batch: int, rows: int, real_rows: int,
               f: int, dtype):
    """Codes and row parameters as the halo wire makes them: uint8 from
    ``_wire_quantize`` of random rows, or uint16 codes (made on the host)
    with per-row parameters spanning about [-1, 1]; rows past
    ``real_rows`` are zero padding (code 0, scale 0, min 0)."""
    pad = (0, rows - real_rows)
    if dtype == torch.uint8:
        codes, sc, mn = bsp._wire_quantize(torch.randn(
            (batch, real_rows, f), generator=gen, device="cuda"))
        return (torch.nn.functional.pad(codes, (0, 0) + pad),
                torch.nn.functional.pad(sc, pad),
                torch.nn.functional.pad(mn, pad))
    codes = np.zeros((batch, rows, f), np.uint16)
    codes[:, :real_rows] = rng.integers(0, 65536, (batch, real_rows, f))
    sc, mn = np.zeros((2, batch, rows), np.float32)
    sc[:, :real_rows] = rng.uniform(0.5, 1.5, (batch, real_rows)) / 65535
    mn[:, :real_rows] = -rng.uniform(0.0, 1.0, (batch, real_rows))
    return tuple(torch.as_tensor(x).cuda() for x in (codes, sc, mn))


def dequant_cases(ga, dq, ref, bsp, halo, halo_real_rows: int):
    """Phase 2, DAQ kernels. ``halo`` is the mesh's folded halo operand,
    ``halo_real_rows`` the rows of its table before block padding (n*B).
    Returns {kernel: {"cases": [...]}}."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(3)
    rs = rng.integers(0, 9000, 60000).astype(np.int32)
    rr = rng.integers(0, 2048, 60000).astype(np.int32)
    rect = tuple(torch.as_tensor(x).cuda()
                 for x in ga.build_block_csr(rs, rr, 2048)[:3])
    rect_src = -(-9000 // 128) * 128
    halo_ops = (halo.blocks, halo.cols, halo.mask)
    operands = {
        "mesh_halo": (halo_ops, halo.rows, halo.max_col, halo.src_rows,
                      halo_real_rows,
                      tile_adjacency(*halo_ops, halo.src_rows),
                      operand_stats(halo.blocks, halo.mask)),
        "rect": (rect, ga.compact_block_csr(*rect), int(rect[1].max()),
                 rect_src, 9000, adjacency(rs, rr, 2048, rect_src),
                 operand_stats(*rect[::2]))}
    # On a CUDA tensor the wrappers need the compacted operand: no fallback.
    for name in ("dequant_spmm", "dequant_spmm_batched"):
        lead = (1,) * (name != "dequant_spmm")
        c = torch.zeros(lead + (halo.src_rows, 8), dtype=torch.uint8,
                        device="cuda")
        s_ = torch.zeros(lead + (halo.src_rows,), device="cuda")
        try:
            getattr(dq, name)(*halo_ops, c, s_, s_, max_col=halo.max_col)
        except ValueError as e:
            if "compact_block_csr" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran on CUDA without rows")
    cases = [("mesh_halo", 52, torch.uint8, "mesh"),
             ("mesh_halo", 64, torch.uint8, "mesh"),
             ("mesh_halo", 64, torch.uint16, None),
             ("rect", 64, torch.uint8, None)]
    out = {"dequant_spmm": {"cases": []},
           "dequant_spmm_batched": {"cases": []}}
    for where, f, dtype, path in cases:
        (ops_, rows, max_col, src_rows, real_rows, a_lib,
         (n_real, nnz, cvb, cm)) = operands[where]
        if rows.nnz != nnz:
            raise AssertionError(f"{where}: {rows.nnz} compacted entries, "
                                 f"{nnz} nonzero tile entries")
        for name, batch in (("dequant_spmm", 1),
                            ("dequant_spmm_batched", BATCH)):
            codes, sc, mn = wire_codes(bsp, gen, rng, batch, src_rows,
                                       real_rows, f, dtype)
            if batch == 1:
                codes, sc, mn = codes[0], sc[0], mn[0]
            kern = getattr(dq, name)
            plain = (ref.dequant_spmm_ref if batch == 1
                     else ref.dequant_spmm_batched_ref)
            rows_plain = (ref.dequant_spmm_rows_ref if batch == 1
                          else ref.dequant_spmm_rows_batched_ref)

            def call():
                return kern(*ops_, codes, sc, mn, rows=rows, max_col=max_col)
            got = call()
            # float64 yardsticks: the very f32 dequantized table, summed in
            # float64 over the dense tiles (float64 blocks promote the plain
            # version) and over the compacted rows; the two agree to 1e-12.
            want = plain(ops_[0].double(), ops_[1], ops_[2].double(), codes,
                         sc, mn)
            want_rows = rows_plain(rows, codes, sc, mn, dtype=torch.float64)
            check_close(f"{name} {where} F={f}: dense vs rows plain",
                        want_rows, want, 1e-12, 1e-12)
            err = errors(got, want)
            err["rows_f64_max_abs_err"] = errors(got, want_rows)[
                "max_abs_err"]
            err["plain_f32_max_abs_err"] = errors(
                plain(*ops_, codes, sc, mn), want)["max_abs_err"]
            err["rows_plain_f32_max_abs_err"] = errors(
                rows_plain(rows, codes, sc, mn), want)["max_abs_err"]
            check_close(f"{name} {where} F={f} {dtype}", got.double(), want,
                        KERNEL_RTOL, KERNEL_ATOL)
            check_close(f"{name} {where} F={f} {dtype} vs rows",
                        got.double(), want_rows, KERNEL_RTOL, KERNEL_ATOL)
            stack = (codes, sc, mn) if batch > 1 else tuple(
                x[None] for x in (codes, sc, mn))
            for b in range(batch):
                c, s_, m_ = (x[b] for x in stack)
                serial = dq.dequant_spmm(*ops_, c, s_, m_, rows=rows,
                                         max_col=max_col)
                if batch > 1 and not torch.equal(got[b], serial):
                    raise AssertionError(f"{name} {where} F={f}: example {b}"
                                         f" differs from dequant_spmm")
                # Both kernels walk the same compacted rows: the values the
                # dequantizing loader builds in registers are bitwise the
                # plain dequantized table, so the chain gives block_spmm's
                # floats over that table.
                table = ref.dequant_ref(c, s_, m_)
                if not torch.equal(serial, ga.block_spmm(
                        *ops_, table, rows=rows, max_col=max_col)):
                    raise AssertionError(f"dequant_spmm {where} F={f}: not "
                                         f"bitwise block_spmm over the plain"
                                         f" dequantized table")

            # Library yardstick, two calls: dequantize, then one sparse
            # product over the [S, B*F] panel (layout change not timed).
            def lib():
                h = codes.float() * sc[..., None] + mn[..., None]
                if batch > 1:
                    h = h.permute(1, 0, 2).reshape(src_rows, batch * f)
                return torch.sparse.mm(a_lib, h)
            lib_out = lib().reshape(-1, batch, f).permute(1, 0, 2) \
                if batch > 1 else lib()
            check_close(f"library {where} F={f}", lib_out.double(), want,
                        KERNEL_RTOL, KERNEL_ATOL)
            k_ms = time_ms(call, reps=30)
            p_ms = time_ms(lambda: rows_plain(rows, codes, sc, mn), reps=5,
                           warmup=1)
            dense_ms = time_ms(lambda: plain(*ops_, codes, sc, mn), reps=3,
                               warmup=1)
            l_ms = time_ms(lib, reps=30)
            b_ms, b_by = bound(nnz, cvb, cm, src_rows, f, batch,
                               code_bytes=codes.element_size(), row_bytes=8)
            rec = {"case": where, "F": f, "B": batch,
                   "codes": str(dtype).removeprefix("torch."),
                   "src_rows": src_rows, "out_rows": cvb * 128,
                   "real_tiles": n_real, "tile_slots": cvb * cm,
                   "tile_nonzeros": nnz, "segments": rows.n_seg,
                   "split_rows": len(rows.split),
                   "path": path, **err, "ms": k_ms, "plain_ms": p_ms,
                   "dense_plain_ms": dense_ms,
                   "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "host_us": host_us(call),
                   "library_host_us": host_us(lib)}
            out[name]["cases"].append(rec)
            log(f"  {name:21s} {where:9s} F={f:3d} B={batch} "
                f"{rec['codes']:6s} err {err['max_abs_err']:.3g} kernel "
                f"{k_ms:.4f} ms  plain {p_ms:.4f} ms (dense {dense_ms:.4f})"
                f"  library {l_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
                f"host {rec['host_us']:.1f} us (library "
                f"{rec['library_host_us']:.1f})")
            del codes, sc, mn, got, want, want_rows, lib_out
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

    # Embeddings against the same forward in float64 on the CPU (the
    # port's layers on float64 parameters and features): a fixed yardstick
    # with no float32 rounding that launches no kernel, and the kernel path
    # is deterministic, so this check gives the same verdict on every run.
    exact = f64_forward(models, plan, kind)
    checks = {name: {"pallas_vs_f64": emb_errors(got, exact(f_in))}
              for name, f_in, got in (("query", feats, emb),
                                      ("batch[3]", stack[3], many[3]))}
    for name, c in checks.items():
        c = c["pallas_vs_f64"]
        log(f"  {kind} {name}: pallas vs f64 max {c['max_abs']:.3g} ratio "
            f"{c['tol_ratio']:.3g} beyond {c['beyond_bar']}")
        if c["beyond_bar"]:
            raise AssertionError(f"{kind} {name}: pallas vs the float64 "
                                 f"forward beyond rtol {EMB_RTOL} / atol "
                                 f"{EMB_ATOL}")
    return {"kind": kind, "layers": k, "compile_s": compile_s,
            "first_query_ms": query_s[0] * 1e3,
            "query_ms": statistics.median(query_s[1:]) * 1e3,
            **{name: statistics.median(v) for name, v in stages.items()},
            "batch_ms": batch_s * 1e3, "serial_batch_ms": serial_s * 1e3,
            "batch_size": BATCH, "embedding_checks": checks}


def f64_forward(models, plan, kind: str):
    """f_in -> the float64 forward of ``plan``'s model on ``f_in``, on the
    CPU (parameters, features and edge list copied there), so the
    yardstick launches no kernel of the port."""
    edges = type(plan.edges)(*(t.cpu() if torch.is_tensor(t) else t
                               for t in plan.edges))
    p64 = [{n: v.detach().cpu().double() for n, v in p.items()}
           for p in plan.model.params]

    def exact(f_in) -> np.ndarray:
        with torch.no_grad():
            h64 = torch.as_tensor(f_in, dtype=torch.float64)
            return models.gnn_apply(p64, kind, h64, edges).numpy()
    return exact


def segment_gates(Engine, models, g, kind: str, executor: str, sg) -> dict:
    """Phases 3 and 3b, ``aggregation="segment_sum"`` for one kind on one
    executor (seeded weights; on the mesh the halo rows cross as f32, since
    the DAQ halo wire runs only on the kernel path): two executes of the
    same features must be bitwise equal, and an ``execute_many`` of BATCH
    bitwise BATCH serial executes; an execute launches the segment-sum
    kernel SEGMENT_SUMS[kind] times a layer, a batch BATCH times that
    (``sg`` is the kernel's module). The embeddings are held to the
    float64 forward on the CPU at the embedding bar, gating the kinds in
    SEGMENT_F64_GATED_KINDS and printed for all. Returns the execute times
    (host clock, ending in the copy back) and the checks."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.gnn_init(gen, kind, [g.feature_dim, DIMS_HIDDEN,
                                         DIMS_OUT])
    plan = Engine((params, kind), executor=executor,
                  aggregation="segment_sum", device="cuda").compile(g)
    sess = plan.session()
    per_execute = plan.model.num_layers * SEGMENT_SUMS[kind]
    what = f"{kind} {executor} segment_sum"

    def launched(fn, want, call):
        before = sg.segment_sum.launches
        out = fn()
        if sg.segment_sum.launches - before != want:
            raise AssertionError(f"{what}: {call} launched "
                                 f"{sg.segment_sum.launches - before} "
                                 f"segment sums, expected {want}")
        return out

    feats = sess.collect()
    first = launched(lambda: sess.execute(feats), per_execute, "an execute")
    if first.shape != (g.num_vertices, DIMS_OUT) or \
            not np.isfinite(first).all():
        raise AssertionError(f"{what}: bad embeddings {first.shape}")
    execute_ms = []
    for _ in range(QUERIES):
        t0 = time.perf_counter()
        again = sess.execute(feats)
        execute_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(again, first):
            raise AssertionError(f"{what}: two executes of the same input "
                                 f"differ (max {np.abs(again - first).max()})")
    rng = np.random.default_rng(7)
    stack = np.stack([sess.collect(g.features + rng.normal(
        scale=0.1, size=g.features.shape)) for _ in range(BATCH)])
    t0 = time.perf_counter()
    many = launched(lambda: sess.execute_many(stack), BATCH * per_execute,
                    f"a batch of {BATCH}")
    batch_ms = (time.perf_counter() - t0) * 1e3
    for b in range(BATCH):
        if not np.array_equal(many[b], sess.execute(stack[b])):
            raise AssertionError(f"{what}: batched example {b} is not "
                                 f"bitwise the serial execute")
    exact = f64_forward(models, plan, kind)
    checks = {}
    for name, f_in, got in (("query", feats, first),
                            ("batch[3]", stack[3], many[3])):
        c = checks[name] = emb_errors(got, exact(f_in))
        log(f"  {what} {name}: vs f64 max {c['max_abs']:.3g} ratio "
            f"{c['tol_ratio']:.3g} beyond {c['beyond_bar']}")
        if kind in SEGMENT_F64_GATED_KINDS and c["beyond_bar"]:
            raise AssertionError(f"{what} {name}: vs the float64 forward "
                                 f"beyond rtol {EMB_RTOL} / atol "
                                 f"{EMB_ATOL}")
    rec = {"kind": kind, "executor": executor,
           "execute_ms": statistics.median(execute_ms),
           "batch_ms": batch_ms, "batch_size": BATCH,
           "launches_per_execute": per_execute, "embedding_checks": checks}
    log(f"  {what}: two executes equal, batch of {BATCH} == serial "
        f"(bitwise), {per_execute} launches an execute; execute "
        f"{rec['execute_ms']:.2f} ms, batch {batch_ms:.2f} ms")
    return rec


def mesh_plan(Engine, models, g, kind: str):
    """The mesh path's plan for ``kind`` (seeded weights) and its compile
    seconds."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.gnn_init(gen, kind, [g.feature_dim, DIMS_HIDDEN,
                                         DIMS_OUT])
    t0 = time.perf_counter()
    plan = Engine((params, kind), executor="mesh-bsp", aggregation="pallas",
                  compressor="daq", device="cuda").compile(g)
    return plan, time.perf_counter() - t0


def daq_errors(got: np.ndarray, want: np.ndarray) -> dict:
    """Max abs difference against the reference's DAQ bar,
    5e-2 * max(max|want|, 1), and the entries beyond it."""
    d = np.abs(got.astype(np.float64) - want)
    bar = DAQ_BAR * max(float(np.abs(want).max()), 1.0)
    return {"max_abs": float(d.max()), "bar": bar,
            "ratio": float(d.max()) / bar, "beyond_bar": int((d > bar).sum()),
            "p99_abs": float(np.quantile(d, 0.99))}


def serve_mesh(models, g, kind: str, plan, compile_s: float, kernels):
    """Phase 3b for one model kind. ``kernels`` are the four wrappers in
    the order of MESH_KERNELS. Returns timings and checks everything."""
    k = plan.model.num_layers
    sess = plan.session()

    def counts():
        return np.array([fn.launches for fn in kernels])

    def expect(before, want, what):
        got = counts() - before
        if list(got) != list(want):
            raise AssertionError(f"{kind} mesh: {what} launched "
                                 f"{dict(zip(MESH_KERNELS, got.tolist()))}, "
                                 f"expected {dict(zip(MESH_KERNELS, want))}")

    query_s = []
    for _ in range(QUERIES):
        before = counts()
        t0 = time.perf_counter()
        res = sess.query()
        query_s.append(time.perf_counter() - t0)
        expect(before, [k, 0, k, 0], "a query")
        if res.embeddings.shape != (g.num_vertices, DIMS_OUT) or \
                not np.isfinite(res.embeddings).all():
            raise AssertionError(f"{kind} mesh: bad embeddings "
                                 f"{res.embeddings.shape}")
    stages = {"collect_ms": [], "execute_ms": [], "account_ms": []}
    for _ in range(QUERIES):
        t0 = time.perf_counter()
        feats = sess.collect()
        t1 = time.perf_counter()
        emb = sess.execute(feats)
        t2 = time.perf_counter()
        sess.account()
        t3 = time.perf_counter()
        for name, sec in zip(stages, ((t1 - t0), (t2 - t1), (t3 - t2))):
            stages[name].append(sec * 1e3)

    rng = np.random.default_rng(7)
    stack = np.stack([sess.collect(g.features + rng.normal(
        scale=0.1, size=g.features.shape)) for _ in range(BATCH)])
    before = counts()
    t4 = time.perf_counter()
    many = sess.execute_many(stack)
    batch_s = time.perf_counter() - t4
    expect(before, [0, k, 0, k], "a batch")
    t5 = time.perf_counter()
    serial = [sess.execute(stack[b]) for b in range(BATCH)]
    serial_s = time.perf_counter() - t5
    for b in range(BATCH):
        if not np.array_equal(many[b], serial[b]):
            raise AssertionError(f"{kind} mesh: batched example {b} is not "
                                 f"bitwise the serial execute")

    # The DAQ wire against the float64 single-program forward (on the CPU)
    # of the same collected features, to the reference's DAQ bar; then one f32-wire
    # query (compressor "none": raw features, f32 halo rows) against the
    # float64 forward at the embedding bar.
    exact = f64_forward(models, plan, kind)
    checks = {"query": daq_errors(emb, exact(feats)),
              "batch[3]": daq_errors(many[3], exact(stack[3]))}
    for name, c in checks.items():
        log(f"  {kind} mesh {name}: daq wire vs f64 max {c['max_abs']:.3g} "
            f"(bar {c['bar']:.3g}, ratio {c['ratio']:.3g}, "
            f"{c['beyond_bar']} entries beyond, p99 {c['p99_abs']:.3g})")
    f32 = plan.session(compressor="none")
    before = counts()
    t6 = time.perf_counter()
    res32 = f32.query()
    f32_query_s = time.perf_counter() - t6
    expect(before, [2 * k, 0, 0, 0], "a compressor='none' query")
    checks["f32_wire"] = emb_errors(res32.embeddings,
                                    exact(g.features.astype(np.float32)))
    c = checks["f32_wire"]
    log(f"  {kind} mesh f32 wire vs f64: max {c['max_abs']:.3g} ratio "
        f"{c['tol_ratio']:.3g} beyond {c['beyond_bar']}")
    pg = sess.partitioned()
    return {"kind": kind, "layers": k, "compile_s": compile_s,
            "fogs": pg.n, "slots": pg.slots,
            "boundary_slots": pg.boundary_slots,
            "first_query_ms": query_s[0] * 1e3,
            "query_ms": statistics.median(query_s[1:]) * 1e3,
            **{name: statistics.median(v) for name, v in stages.items()},
            "batch_ms": batch_s * 1e3, "serial_batch_ms": serial_s * 1e3,
            "batch_size": BATCH, "f32_query_ms": f32_query_s * 1e3,
            "exchange_bytes_daq": res.exchange_bytes,
            "exchange_bytes_f32": res32.exchange_bytes,
            "latency_s": res.latency, "embedding_checks": checks}


def emb_errors(got: np.ndarray, want: np.ndarray) -> dict:
    """Max abs difference, worst |d| / (atol + rtol |want|) and the number
    of entries beyond the embedding bar."""
    d = np.abs(got.astype(np.float64) - want)
    ratio = d / (EMB_ATOL + EMB_RTOL * np.abs(want))
    return {"max_abs": float(d.max()), "tol_ratio": float(ratio.max()),
            "beyond_bar": int((ratio > 1).sum())}


def small_reference(Engine, models, datasets):
    """A small graph served on the card and on the CPU must agree: on the
    single-program path, and on the mesh with the f32 and the DAQ wire
    (the DAQ wire to the reference's DAQ bar: a code may land one step
    apart where the two devices round differently)."""
    g = datasets.load("siot", 0.05, seed=0)
    for kind in ("gcn", "sage"):
        params = models.gnn_init(torch.Generator().manual_seed(1), kind,
                                 [g.feature_dim, 16, 8])
        for executor, comp in (("sim", "none"), ("mesh-bsp", "none"),
                               ("mesh-bsp", "daq")):
            embs = [Engine((params, kind), aggregation="pallas", device=dev,
                           executor=executor, compressor=comp).compile(g)
                    .session().query().embeddings for dev in ("cuda", "cpu")]
            what = f"{kind} {executor} {comp}: card vs CPU"
            if comp == "daq":
                c = daq_errors(embs[0], embs[1].astype(np.float64))
                if c["ratio"] > 1:
                    raise AssertionError(f"{what} {c}")
            else:
                np.testing.assert_allclose(embs[0], embs[1], rtol=EMB_RTOL,
                                           atol=EMB_ATOL, err_msg=what)


def visible_pairs(s: int, t: int, causal: bool, window: int,
                  q_offset: int) -> int:
    """(query, key) pairs the mask keeps for one head: key < T, with
    ``causal`` key <= q_pos, with ``window`` key > q_pos - window."""
    q_pos = q_offset + np.arange(s, dtype=np.int64)
    hi = np.minimum(q_pos, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(s,
                                                                   np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound(pairs: int, b: int, s: int, t: int, h: int, kv: int,
                dh: int, dtype) -> tuple:
    """Least time (ms) of one attention call, the larger of two floors: q,
    k, v read once and o written once at the HBM rate; 4 * dh operations
    per kept (query, key) pair per query head (q.k and p.v, a multiply and
    an add each) at the peak of the input type (bf16 tensor cores, or f32
    CUDA cores)."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * (2 * b * s * h * dh + 2 * b * t * kv * dh)
    ops = 4.0 * dh * pairs * b * h
    peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
        else PEAK_F32_FLOP_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


#: (name, layout, B, S, T, H, KV, dh, dtype, window, q_offset, path):
#: "model" layout [B, S, H, dh] through gqa_flash (causal), "folded"
#: [B*H, S, dh] through flash_attention. ``path`` names the driven path
#: whose calls the case reproduces.
FLASH_CASES = [
    ("qwen prefill", "model", PREFILL_B, PREFILL_S, PREFILL_S, 16, 16, 64,
     torch.bfloat16, 0, 0, "prefill"),
    ("qwen prefill f32", "model", PREFILL_B, PREFILL_S, PREFILL_S, 16, 16,
     64, torch.float32, 0, 0, None),
    ("qwen serve", "model", 4, 16, 16, 16, 16, 64, torch.bfloat16, 0, 0,
     "serve"),
    ("starcoder2 gqa", "model", 2, 2048, 2048, 24, 2, 128, torch.bfloat16,
     0, 0, None),
    ("qwen window", "model", 1, 8192, 8192, 16, 16, 64, torch.float32, 4096,
     0, None),
    ("q_offset", "folded", 1, 1024, 4096, 16, 16, 64, torch.float32, 0,
     3072, None),
    ("dh32", "model", 2, 2048, 2048, 16, 16, 32, torch.bfloat16, 0, 0,
     None),
    ("qwen window", "model", 1, 8192, 8192, 16, 16, 64, torch.bfloat16,
     4096, 0, None),
    ("q_offset", "folded", 1, 1024, 4096, 16, 16, 64, torch.bfloat16, 0,
     3072, None),
]


def flash_cases(fa, ref) -> dict:
    """Phase 2, flash attention. Returns {"flash_attention": {"cases"}}."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"flash_attention": {"cases": []}}
    for (name, layout, b, s, t, h, kv, dh, dtype, window, q_offset,
         path) in FLASH_CASES:
        q = torch.randn((b, s, h, dh), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, t, kv, dh), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((b, t, kv, dh), generator=gen,
                        device="cuda").to(dtype)
        group = h // kv
        if layout == "model":
            def kern():
                return fa.gqa_flash(q, k, v, window=window)

            def plain():
                return ref.gqa_flash_ref(q, k, v, window=window)
        else:   # [B*H, S, dh]: the folded layout of flash_attention
            qf, kf, vf = (x.transpose(1, 2).reshape(-1, x.shape[1], dh)
                          .contiguous() for x in (q, k, v))

            def kern():
                return fa.flash_attention(qf, kf, vf, window=window,
                                          q_offset=q_offset).reshape(
                    b, h, s, dh).transpose(1, 2)

            def plain():
                return ref.flash_attention_ref(
                    qf, kf, vf, window=window, q_offset=q_offset).reshape(
                    b, h, s, dh).transpose(1, 2)
        got = kern()
        # float64 yardstick per (example, head), so the [S, T] float64
        # score table of one head is the largest temporary.
        want = torch.empty((b, s, h, dh), dtype=torch.float64, device="cuda")
        for bi in range(b):
            for hi in range(h):
                kh = hi // group
                want[bi, :, hi] = ref.flash_attention_ref(
                    q[bi, :, hi][None].double(), k[bi, :, kh][None].double(),
                    v[bi, :, kh][None].double(), window=window,
                    q_offset=q_offset)[0]
        rtol = BF16_RTOL if dtype == torch.bfloat16 else KERNEL_RTOL
        err = errors(got, want, rtol, KERNEL_ATOL)
        err["plain_f32_max_abs_err"] = errors(plain(), want)["max_abs_err"]
        if not torch.isfinite(got).all() or err["tol_ratio"] > 1:
            raise AssertionError(f"flash_attention {name}: max abs err "
                                 f"{err['max_abs_err']} beyond rtol {rtol} "
                                 f"/ atol {KERNEL_ATOL} (ratio "
                                 f"{err['tol_ratio']:.3g})")
        # Library yardstick: one SDPA call on [B, H, S, dh] copies (the
        # layout change is not timed), the mask as a boolean [S, T] where
        # it is not plain causal.
        ql, kl, vl = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        q_pos = q_offset + torch.arange(s, device="cuda")[:, None]
        k_pos = torch.arange(t, device="cuda")[None, :]
        mask = None
        if window or q_offset or s != t:
            mask = (k_pos <= q_pos) & ((k_pos > q_pos - window) if window
                                       else True)

        def lib():
            return F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, is_causal=mask is None,
                enable_gqa=group > 1)
        lib_err = errors(lib().transpose(1, 2), want, rtol, KERNEL_ATOL)
        reps = 10 if s * t >= 1 << 22 else 50
        k_ms = time_ms(kern, reps=reps)
        p_ms = time_ms(plain, reps=3, warmup=1)
        l_ms = time_ms(lib, reps=reps)
        pairs = visible_pairs(s, t, True, window, q_offset)
        b_ms, b_by = flash_bound(pairs, b, s, t, h, kv, dh, dtype)
        rec = {"case": name, "layout": layout, "B": b, "S": s, "T": t,
               "H": h, "KV": kv, "dh": dh,
               "dtype": str(dtype).removeprefix("torch."), "window": window,
               "q_offset": q_offset, "kept_pairs_per_head": pairs,
               "path": path, **err, "library_max_abs_err":
               lib_err["max_abs_err"], "ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by}
        out["flash_attention"]["cases"].append(rec)
        log(f"  flash_attention {name:17s} {rec['dtype']:8s} err "
            f"{err['max_abs_err']:.3g} (ratio {err['tol_ratio']:.3g}; sdpa "
            f"{lib_err['max_abs_err']:.3g}) kernel {k_ms:.4f} ms  plain "
            f"{p_ms:.4f} ms  sdpa {l_ms:.4f} ms  bound {b_ms:.4f} ms "
            f"({b_by})")
        del q, k, v, got, want, ql, kl, vl
        torch.cuda.empty_cache()
    return out


def segment_bound(rows_read: int, f: int, summed: int, v: int,
                  weighted: bool) -> tuple:
    """Least time (ms) of one fused gather-and-sum, the larger of two
    floors: the bytes the function must move at the HBM rate (each
    distinct source row read once, 4 F bytes; idx once, and order and w
    too when weighted, 4 bytes an entry each; the offsets and the output
    once), and its operations at the f32 CUDA-core peak (one add, and one
    product when weighted, per summed entry and feature)."""
    nbytes = 4 * (rows_read * f + summed * (3 if weighted else 1)
                  + (v + 1) + v * f)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = summed * f * (2 if weighted else 1) / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def segment_cases(sg, ref, layers, bsp, g, pg) -> dict:
    """Phase 2, the fixed-order gather-and-sum at the layers' inputs: on
    full-scale SIoT's edge list over the [V, F] table (aggregate_sum, F =
    52 and 64, the sim path's widths), on GAT's self-looped list (its
    weighted messages at F = 64 and at the last layer's F = 2, and its
    F = 1 softmax denominators, one term per edge) and on the mesh's
    folded halo list over the [n*P | n*B] table (``pg``); and, for the
    kernel's other row layouts (a generic ring stride for the hub's CTAs,
    float2 and scalar lane groups), SIoT's list at F = 7 and 8, weighted
    and not. Beside each fused call, for the record, the same call without
    the long-segment CTAs (every segment on a lane group: what the CTAs
    earn), the old composition (messages gathered over every edge, masked
    and weighted, then the kernel) and two library calls: ``index_add_``
    on those messages and ``torch.sparse.mm`` of the summed edges as a CSR
    matrix over the table. Returns {"segment_sum": {"cases": [...]}}."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    edges = layers.EdgeList.from_graph(g, device="cuda")
    looped = edges.self_looped
    halo = bsp._edges(pg, torch.device("cuda"), "halo", "gcn")
    halo_rows = pg.n * (pg.slots + pg.boundary_slots)
    # (name, edges, F, source rows (None: one term per edge), weighted,
    # path)
    cases = [("siot", edges, 52, g.num_vertices, False, "sim"),
             ("siot", edges, 64, g.num_vertices, False, "sim"),
             ("siot gat", looped, 64, g.num_vertices, True, None),
             ("siot gat", looped, 2, g.num_vertices, True, None),
             ("siot gat denom", looped, 1, None, False, None),
             ("mesh halo", halo, 64, halo_rows, False, None),
             ("siot", edges, 7, g.num_vertices, False, None),
             ("siot", edges, 7, g.num_vertices, True, None),
             ("siot", edges, 8, g.num_vertices, False, None),
             ("siot", edges, 8, g.num_vertices, True, None)]
    out = {"segment_sum": {"cases": []}}
    for name, el, f, rows, weighted, path in cases:
        e, v = el.receivers.shape[0], el.num_vertices
        per_edge = rows is None
        idx = el.order if per_edge else el.gather
        x = torch.randn((e,) if per_edge else (rows, f), generator=gen,
                        device="cuda")
        if per_edge:   # denominators: exp terms, 0 on masked edges
            x = x.abs() * el.mask
        w = None
        if weighted:   # softmax coefficients, 0 on masked edges
            w = torch.rand(e, generator=gen, device="cuda") * el.mask
        recv = el.receivers.long()
        longs = el.long_segments(f)

        def call():
            return sg.segment_sum(x, el.order, el.offsets, idx=idx, w=w,
                                  long=longs)

        def lanes_only():
            return sg.segment_sum(x, el.order, el.offsets, idx=idx, w=w)

        def plain():
            return ref.gather_segment_sum_ref(x, idx, el.offsets,
                                              order=el.order, w=w)

        def messages():
            if per_edge:
                return x
            m = x.index_select(0, el.senders.long()) * el.mask[:, None]
            return m if w is None else m * w[:, None]

        def composition():
            return sg.segment_sum(messages(), el.order, el.offsets,
                                  long=longs)
        msgs = messages()

        def index_add():
            return msgs.new_zeros((v,) + tuple(msgs.shape[1:])).index_add_(
                0, recv, msgs)
        vals = (torch.ones(el.order.shape[0], device="cuda") if w is None
                else w.index_select(0, el.order.long()))
        a_csr = torch.sparse_csr_tensor(
            el.offsets.long(), idx.long(), vals,
            size=(v, e if per_edge else rows))
        x2 = x[:, None] if per_edge else x

        def sparse_mm():
            return torch.sparse.mm(a_csr, x2)
        got = call()
        if not torch.equal(got, call()):
            raise AssertionError(f"segment_sum {name} F={f}: two launches "
                                 f"differ")
        if not torch.equal(got, lanes_only()):
            raise AssertionError(f"segment_sum {name} F={f}: the sum "
                                 f"without long-segment CTAs differs")
        if not torch.equal(got, composition()):
            raise AssertionError(f"segment_sum {name} F={f}: the fused sum "
                                 f"is not the gather + mask + sum "
                                 f"composition bitwise")
        want = ref.gather_segment_sum_ref(
            x.double(), idx, el.offsets, order=el.order,
            w=None if w is None else w.double())
        err = errors(got, want)
        err["plain_f32_max_abs_err"] = errors(plain(), want)["max_abs_err"]
        host = sg.segment_sum(x.cpu(), el.order.cpu(), el.offsets.cpu(),
                              idx=idx.cpu(),
                              w=None if w is None else w.cpu())
        err["card_vs_cpu_max_abs"] = float((got.cpu() - host).abs().max())
        check_close(f"segment_sum {name} F={f}", got.double(), want,
                    KERNEL_RTOL, KERNEL_ATOL)
        check_close(f"index_add_ {name} F={f}", index_add().double(), want,
                    KERNEL_RTOL, KERNEL_ATOL)
        check_close(f"sparse.mm {name} F={f}",
                    sparse_mm().reshape(got.shape).double(), want,
                    KERNEL_RTOL, KERNEL_ATOL)
        # The longest segment summed alone (its CTAs, the launch): the
        # fixed-order chain the whole call waits for.
        counts = el.offsets[1:] - el.offsets[:-1]
        top = int(torch.argmax(counts))
        lo, hi = int(el.offsets[top]), int(el.offsets[top + 1])
        one = torch.tensor([0, hi - lo], dtype=torch.int32, device="cuda")
        h_idx, h_ord = idx[lo:hi].contiguous(), el.order[lo:hi].contiguous()
        h_long = sg.LongSegments(one, f)

        def longest():
            return sg.segment_sum(x, h_ord, one, idx=h_idx, w=w,
                                  long=h_long)
        if not torch.equal(longest()[0], got[top]):
            raise AssertionError(f"segment_sum {name} F={f}: the longest "
                                 f"segment alone differs")
        k_ms = time_ms(call, reps=30)
        h_ms = time_ms(longest, reps=30)
        n_ms = time_ms(lanes_only, reps=30)
        p_ms = time_ms(plain, reps=10)
        c_ms = time_ms(composition, reps=30)
        i_ms = time_ms(index_add, reps=30)
        s_ms = time_ms(sparse_mm, reps=30)
        # The work this data needs: the summed (unmasked) entries and the
        # distinct source rows they read.
        summed = el.order.shape[0]
        rows_read = int(torch.unique(idx).numel())
        b_ms, b_by = segment_bound(rows_read, f, summed, v, weighted)
        rec = {"case": name, "F": f, "E": e, "summed": summed, "V": v,
               "source_rows": rows_read, "weighted": weighted,
               "longest_segment": hi - lo, "longest_segment_ms": h_ms,
               "long_segments": int(longs.ids.numel()),
               "long_threshold": longs.threshold, "path": path, **err,
               "ms": k_ms, "no_long_ctas_ms": n_ms, "plain_ms": p_ms,
               "composition_ms": c_ms,
               "index_add_ms": i_ms, "sparse_mm_ms": s_ms,
               "library_ms": min(i_ms, s_ms),
               "library": "index_add_" if i_ms <= s_ms else "sparse.mm",
               "bound_ms": b_ms, "bound_by": b_by}
        out["segment_sum"]["cases"].append(rec)
        log(f"  segment_sum {name:14s} F={f:2d} E={e} err "
            f"{err['max_abs_err']:.3g} (card vs CPU port "
            f"{err['card_vs_cpu_max_abs']:.3g}) fused {k_ms:.4f} ms  "
            f"without long CTAs {n_ms:.4f} ms  "
            f"composition {c_ms:.4f} ms  plain {p_ms:.4f} ms  index_add_ "
            f"{i_ms:.4f} ms  sparse.mm {s_ms:.4f} ms  bound {b_ms:.4f} ms "
            f"({b_by}); longest segment ({hi - lo} entries) alone "
            f"{h_ms:.4f} ms; {rec['long_segments']} segments over the "
            f"long threshold ({longs.threshold})")
        del x, w, msgs, a_csr, got, want, host
    # The launch floor of this timing: one launch over one empty segment.
    none = torch.zeros(2, dtype=torch.int32, device="cuda")
    table = torch.zeros((1, 64), device="cuda")
    floor = time_ms(lambda: sg.segment_sum(table, none[:0], none), reps=30)
    out["segment_sum"]["empty_launch_ms"] = floor
    log(f"  segment_sum over one empty segment (the launch floor of these "
        f"timings): {floor:.4f} ms")
    # The layer's sum on the card against the CPU port: same edge order,
    # adds without FMA, so 0 is expected (reported, not gated).
    h = torch.as_tensor(g.features, dtype=torch.float32)
    card = layers.aggregate_sum(h.cuda(), edges).cpu()
    host = layers.aggregate_sum(h, layers.EdgeList.from_graph(g))
    d = float((card - host).abs().max())
    out["segment_sum"]["aggregate_sum_card_vs_cpu_max_abs"] = d
    same = "bitwise equal" if torch.equal(card, host) else "not bitwise"
    log(f"  aggregate_sum on full SIoT (F={g.feature_dim}): card vs CPU port "
        f"max abs {d} ({same})")
    return out


#: The streaming dequant table: rows x features of uint8 codes (about 84
#: MB moved: 16.8 MB of codes in, 67 MB of f32 out), seeded.
STREAM_TABLE, STREAM_SEED = (131_072, 128), 17


def dequant_tables(g, compression, datasets) -> list:
    """(name, codes, f32 scales, f32 mins, float64 yardstick or None):
    the uint8 and uint16 groups of ``daq_pack`` on the graph's features
    (their float64 ``daq_unpack`` rows as yardstick) and the 128-feature
    table of benchmarks/run.py's kernel_microbench."""
    packed = compression.daq_pack(g.features, g.degrees, lossless=False)
    unpacked = compression.daq_unpack(packed)
    out = []
    for nbits in (8, 16):
        ids, q, mins, scales = packed.groups[nbits]
        out.append((f"siot daq {nbits}-bit", q, scales.astype(np.float32),
                    mins.astype(np.float32), unpacked[ids]))
    y = datasets.load("yelp", scale=0.1, seed=0)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 255, (y.num_vertices, 128)).astype(np.uint8)
    sc = rng.uniform(0.01, 1, y.num_vertices).astype(np.float32)
    mn = rng.normal(size=y.num_vertices).astype(np.float32)
    out.append(("kernel_microbench", codes, sc, mn, None))
    return out


def streaming_table() -> tuple:
    """The streaming case's (codes, scales, mins), seeded."""
    rng = np.random.default_rng(STREAM_SEED)
    v, f = STREAM_TABLE
    return (rng.integers(0, 256, (v, f)).astype(np.uint8),
            rng.uniform(0.01, 1, v).astype(np.float32),
            rng.normal(size=v).astype(np.float32))


def dequant_kernel_cases(dq, ref, tables) -> dict:
    """Phase 2, the standalone dequant kernel on each table as
    ``ops.dequantize_features`` sends it (unpadded: the ``dequantize``
    path's cases), padded to the reference's 256 x 128 tiling (the layout
    the caller used to send, kept for comparison), and on one streaming
    table that separates the launch floor from the streaming rate. Each is
    bitwise its plain version."""
    out = {"dequant": {"cases": []}}
    runs = [(name, codes, sc, mn, exact, pad)
            for name, codes, sc, mn, exact in tables
            for pad in (True, False)]
    runs.append(("streaming", *streaming_table(), None, False))
    for name, codes, sc, mn, exact, pad in runs:
        v, f = codes.shape
        vp, fp = (-(-v // 256) * 256, -(-f // 128) * 128) if pad else (v, f)
        cp = np.zeros((vp, fp), codes.dtype)
        cp[:v, :f] = codes
        c = torch.as_tensor(cp).cuda()
        s_, m_ = (torch.as_tensor(np.pad(x, (0, vp - v))).cuda()
                  for x in (sc, mn))

        def call():
            return dq.dequant(c, s_, m_, v_tile=vp, f_tile=fp)
        got = call()
        plain = ref.dequant_ref(c, s_, m_)
        if not torch.equal(got, plain):
            raise AssertionError(f"dequant {name} [{vp}, {fp}]: not "
                                 f"bitwise the plain version")
        want = (c.double() * s_.double()[:, None] + m_.double()[:, None])
        err = errors(got, want)
        if exact is not None:
            # The wire's float64 rows: f32 scale / min and two f32
            # roundings against the float64 unpack.
            err_unpack = errors(got[:v, :f], torch.as_tensor(exact).cuda())
            err["unpack_f64_max_abs_err"] = err_unpack["max_abs_err"]
            err["unpack_f64_tol_ratio"] = err_unpack["tol_ratio"]
            check_close(f"dequant {name} vs daq_unpack",
                        got[:v, :f].double(), torch.as_tensor(exact).cuda(),
                        KERNEL_RTOL, KERNEL_ATOL)
        check_close(f"dequant {name}", got.double(), want, KERNEL_RTOL,
                    KERNEL_ATOL)

        def lib():
            return c.float() * s_[:, None] + m_[:, None]
        k_ms = time_ms(call, reps=50)
        p_ms = time_ms(lambda: ref.dequant_ref(c, s_, m_), reps=50)
        l_ms = time_ms(lib, reps=50)
        nbytes = vp * fp * (c.element_size() + 4) + vp * 8
        b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        rec = {"case": name, "V": vp, "F": fp, "padded": pad,
               "codes": str(c.dtype).removeprefix("torch."),
               "path": None if pad or name == "streaming" else "dequantize",
               **err, "ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": b_ms, "bound_by": "bytes",
               "bytes": nbytes, "gb_per_s": nbytes / k_ms / 1e6}
        out["dequant"]["cases"].append(rec)
        log(f"  dequant {name:19s} [{vp}, {fp}] {rec['codes']:6s} err "
            f"{err['max_abs_err']:.3g} kernel {k_ms:.4f} ms "
            f"({rec['gb_per_s']:.0f} GB/s)  plain {p_ms:.4f} ms  library "
            f"{l_ms:.4f} ms  bound {b_ms:.4f} ms")
        del c, s_, m_, got, plain, want
    return out


def dequantize_path(ops, ref, tables) -> list:
    """Phase 3c: ``ops.dequantize_features`` on the card, bitwise the plain
    dequantization of the same codes."""
    out = []
    for name, codes, sc, mn, _ in tables:
        t0 = time.perf_counter()
        got = ops.dequantize_features(codes, sc, mn, device="cuda")
        host_ms = (time.perf_counter() - t0) * 1e3
        want = ref.dequant_ref(*(torch.as_tensor(x) for x in (codes, sc,
                                                               mn))).numpy()
        if got.shape != codes.shape or not np.array_equal(got, want):
            raise AssertionError(f"dequantize_features {name}: not the "
                                 f"plain dequantization")
        out.append({"table": name, "shape": list(codes.shape),
                    "host_ms": host_ms})
        log(f"  dequantize_features {name}: {list(codes.shape)} "
            f"{codes.dtype} in {host_ms:.2f} ms (host clock, H2D + D2H)")
    return out


def serve_path(sv, fa, cfg) -> dict:
    """Phase 3d: transformer serving (``launch.serve``) at full width."""
    launches0 = fa.flash_attention.launches
    res = sv.serve(cfg, device="cuda", log=log, **SERVE)
    n_batches = len(res["batches"])
    got = fa.flash_attention.launches - launches0
    if got != cfg.num_layers * n_batches:
        raise AssertionError(f"serve launched {got} flash kernels for "
                             f"{n_batches} prefills, expected "
                             f"{cfg.num_layers} per prefill")
    for r in res["requests"]:
        if len(r.done) != SERVE["tokens"] or not all(
                0 <= t < cfg.vocab_size for t in r.done):
            raise AssertionError(f"request {r.rid}: bad tokens {r.done}")
    b = res["batches"]
    steady = b[1:] or b
    summary = {
        "arch": cfg.name, "batches": n_batches,
        "tokens": res["tokens"], "wall_s": res["wall_s"],
        "tokens_per_s": res["tokens_per_s"],
        "bottleneck_ratio": res["bottleneck_ratio"],
        "flash_launches": got,
        "first_prefill_ms": b[0]["prefill_ms"],
        "prefill_ms_median": statistics.median(x["prefill_ms"]
                                               for x in steady),
        "decode_ms_median": statistics.median(x["decode_ms"] for x in steady),
        "decode_ms_per_step_median": statistics.median(
            x["decode_ms"] / x["decode_steps"] for x in steady),
        "batch_timings": b}
    log(f"  serve: {summary['tokens']} tokens in {summary['wall_s']:.2f} s "
        f"({summary['tokens_per_s']:.1f} tok/s), prefill "
        f"{summary['prefill_ms_median']:.2f} ms / decode "
        f"{summary['decode_ms_median']:.2f} ms per batch (median after the "
        f"first; first prefill {summary['first_prefill_ms']:.1f} ms), "
        f"{got} flash launches, bottleneck/mean "
        f"{summary['bottleneck_ratio']:.3f}")
    return summary


def greedy(tf, params, cfg, logits, caches, pos: int, n: int):
    """``n`` greedy tokens [B, n] from prefill logits and caches."""
    toks = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    for step in range(n):
        toks.append(tok)
        if step + 1 < n:
            logits, caches = tf.decode_step(params, cfg, caches, tok,
                                            pos + step)
            tok = torch.argmax(logits[:, -1:], dim=-1)
    return torch.cat(toks, dim=1)


def long_prefill(tf, fa, cfg) -> dict:
    """Phase 3e: ``prefill`` at full width, B = 2, S = 4096."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tf.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                         generator=gen, device="cuda")
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    cfg32c = dataclasses.replace(cfg32, attn_impl="chunked")
    served = tf.cast_params(params, cfg)
    cache_len = PREFILL_S + GREEDY

    def timed(p, c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tf.prefill(p, c, toks, cache_len=cache_len)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        launches0 = fa.flash_attention.launches
        (l16, c16), first_ms = timed(served, cfg)
        del c16
        (l16, c16), bf16_ms = timed(served, cfg)
        (l32, c32), f32_ms = timed(params, cfg32)
        flash_calls = fa.flash_attention.launches - launches0
        (l32c, c32c), chunked_ms = timed(params, cfg32c)
        chunked_calls = fa.flash_attention.launches - launches0 - flash_calls
        if flash_calls != 3 * cfg.num_layers or chunked_calls:
            raise AssertionError(f"3 flash prefills launched {flash_calls} "
                                 f"kernels, the chunked one {chunked_calls}")
        if l16.shape != (PREFILL_B, 1, cfg.vocab_size) or \
                not torch.isfinite(l16).all() or not torch.isfinite(l32).all():
            raise AssertionError(f"bad prefill logits {tuple(l16.shape)}")
        gate = errors(l32, l32c, LOGIT_RTOL, LOGIT_ATOL)
        bf16_vs = errors(l16.float(), l32c, LOGIT_RTOL, LOGIT_ATOL)
        g16 = greedy(tf, served, cfg, l16, c16, PREFILL_S, GREEDY)
        del c16
        g32 = greedy(tf, params, cfg32c, l32c, c32c, PREFILL_S, GREEDY)
        del c32, c32c
    agree = int((g16 == g32).sum())
    res = {"B": PREFILL_B, "S": PREFILL_S, "flash_launches": flash_calls,
           "first_bf16_ms": first_ms, "bf16_flash_ms": bf16_ms,
           "f32_flash_ms": f32_ms, "f32_chunked_ms": chunked_ms,
           "f32_flash_vs_chunked": gate, "bf16_flash_vs_f32_chunked":
           bf16_vs, "greedy_tokens_agree": agree,
           "greedy_tokens": g16.numel(), "logit_max_abs": float(
               l32c.abs().max())}
    log(f"  prefill B={PREFILL_B} S={PREFILL_S}: bf16 flash {bf16_ms:.1f} "
        f"ms (first {first_ms:.1f}), f32 flash {f32_ms:.1f} ms, f32 chunked "
        f"{chunked_ms:.1f} ms; f32 flash vs chunked logits max "
        f"{gate['max_abs_err']:.3g} (ratio {gate['tol_ratio']:.3g} of rtol "
        f"{LOGIT_RTOL} / atol {LOGIT_ATOL}); bf16 vs f32 max "
        f"{bf16_vs['max_abs_err']:.3g} (|logit| up to "
        f"{res['logit_max_abs']:.3g}), greedy tokens agree {agree} / "
        f"{g16.numel()}")
    if gate["tol_ratio"] > 1:
        raise AssertionError(f"f32 flash prefill vs chunked: {gate}")
    del params, served
    torch.cuda.empty_cache()
    return res


def small_serve_reference(sv, tf, registry) -> dict:
    """A reduced qwen1.5-0.5b served through the kernel on the card and
    through the plain version on the CPU, same weights: prefill logits of
    one batch within rtol 1e-4 / atol 1e-4; greedy tokens reported."""
    cfg = dataclasses.replace(registry.reduced(registry.get(ARCH)),
                              attn_impl="flash")
    params = tf.init_params(cfg, torch.Generator().manual_seed(2))
    on_card = to_device(params, "cuda")
    runs = {dev: sv.serve(cfg, requests=6, tokens=6, batch_size=2,
                          device=dev, params=p, log=None)
            for dev, p in (("cuda", on_card), ("cpu", params))}
    agree = sum(a == b for ra, rb in zip(runs["cuda"]["requests"],
                                         runs["cpu"]["requests"])
                for a, b in zip(ra.done, rb.done))
    toks = torch.as_tensor(sv.make_requests(cfg, 2, 6)[0].prompt[None])
    with torch.inference_mode():
        lc, _ = tf.prefill(on_card, cfg, toks.cuda())
        lh, _ = tf.prefill(params, cfg, toks)
    np.testing.assert_allclose(lc.cpu().numpy(), lh.numpy(), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL, err_msg="reduced prefill: "
                               "card vs CPU")
    total = sum(len(r.done) for r in runs["cpu"]["requests"])
    log(f"  reduced serve: card vs CPU prefill logits within rtol "
        f"{LOGIT_RTOL} / atol {LOGIT_ATOL}; greedy tokens agree {agree} / "
        f"{total}")
    return {"greedy_tokens_agree": agree, "greedy_tokens": total}


def to_device(tree, device):
    """A copy of a parameter dictionary on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.api import Engine
    from repro_torch.configs import registry
    from repro_torch.core import compression
    from repro_torch.gnn import datasets, layers, models
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import daq_dequant as dq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.kernels import segment_sum as sg
    from repro_torch.launch import serve as sv
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import bsp

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
    # The bf16 flash kernel must run on the tensor cores, fed by TMA.
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    hgmma, utmaldg = sass.count("HGMMA"), sass.count("UTMALDG")
    log(f"  flash_attention SASS: {hgmma} HGMMA, {utmaldg} UTMALDG")
    if not hgmma or not utmaldg:
        raise AssertionError("the flash library has no wgmma or no TMA load")

    log("phase 2: kernels vs plain versions")
    t0 = time.perf_counter()
    g = datasets.load("siot", 1.0, seed=0)
    t1 = time.perf_counter()
    csr = ops.block_csr_for(g, device="cuda")
    torch.cuda.synchronize()
    block_csr_s = time.perf_counter() - t1
    vb, m = csr.blocks.shape[:2]
    real = int(csr.mask.sum())
    log(f"  siot |V|={g.num_vertices} |E|={g.num_edges} F={g.feature_dim}: "
        f"VB={vb} M={m}, {real} real tiles of {vb * m} slots, "
        f"density {g.num_edges / (real * 128 * 128):.4%} "
        f"(host set-up {time.perf_counter() - t0:.2f} s)")
    gcn_mesh, gcn_compile_s = mesh_plan(Engine, models, g, "gcn")
    pg = gcn_mesh.partitioned
    local, halo = bsp._folded_csrs(pg, gcn_mesh.device)
    cut = int((pg.part_of[g.senders] != pg.part_of[g.receivers]).sum())
    log(f"  mesh: {pg.n} fogs, P={pg.slots} slots, {pg.boundary_slots} "
        f"boundary slots per fog ({pg.n * pg.boundary_slots} halo rows), "
        f"{cut} of {g.num_edges} edges cross fogs; local "
        f"{tuple(pg.local_csr.blocks.shape[:3])} {int(local.mask.sum())} "
        f"real tiles of {local.mask.numel()}, halo "
        f"{tuple(pg.halo_csr.blocks.shape[:3])} {int(halo.mask.sum())} real "
        f"tiles of {halo.mask.numel()} (compile {gcn_compile_s:.2f} s)")
    compaction = {
        "siot": compaction_ms(ga, csr, csr.rows, "BlockCsr build",
                              block_csr_s),
        "mesh_local": compaction_ms(ga, local, local.rows, "mesh compile",
                                    gcn_compile_s),
        "mesh_halo": compaction_ms(ga, halo, halo.rows, "mesh compile",
                                   gcn_compile_s)}
    results = kernel_cases(ga, ref, csr, g, local)
    results.update(dequant_cases(ga, dq, ref, bsp, halo,
                                 pg.n * pg.boundary_slots))
    del local, halo
    results.update(segment_cases(sg, ref, layers, bsp, g, pg))
    tables = dequant_tables(g, compression, datasets)
    results.update(dequant_kernel_cases(dq, ref, tables))
    results.update(flash_cases(fa, ref))

    wrappers = {"block_spmm": ga.block_spmm,
                "block_spmm_batched": ga.block_spmm_batched,
                "dequant_spmm": dq.dequant_spmm,
                "dequant_spmm_batched": dq.dequant_spmm_batched,
                "dequant": dq.dequant,
                "flash_attention": fa.flash_attention,
                "segment_sum": sg.segment_sum}
    kernels = [wrappers[n] for n in REPLACES]
    launches = {}

    def drive(path, fn):
        """Drive one path with every count set to 0 just before it, read
        just after; each kernel of the path must have launched."""
        for kern in kernels:
            kern.launches = 0
        out = fn()
        counts = {n: kern.launches for n, kern in zip(REPLACES, kernels)}
        for name in PATH_KERNELS[path]:
            if counts[name] == 0:
                raise AssertionError(f"{name} was never launched on the "
                                     f"{path} path")
        launches[path] = counts
        log(f"  launches on the {path} path: {counts}")
        return out

    log("phase 3: main path (single program)")
    served = drive("sim", lambda: [serve(Engine, models, g, kind, ga)
                                   for kind in ("gcn", "sage")])
    seg_sim = drive("sim-segment", lambda: [
        segment_gates(Engine, models, g, kind, "sim", sg)
        for kind in SEGMENT_KINDS])
    for s in served:
        log(f"  {s['kind']}: compile {s['compile_s']:.2f} s, query "
            f"{s['query_ms']:.1f} ms (first {s['first_query_ms']:.1f}; "
            f"collect {s['collect_ms']:.1f} / execute "
            f"{s['execute_ms']:.1f} / account {s['account_ms']:.1f}), "
            f"batch of {BATCH} {s['batch_ms']:.1f} ms vs serial "
            f"{s['serial_batch_ms']:.1f} ms")

    log("phase 3b: mesh path (mesh-bsp, DAQ halo wire)")

    mesh_kernels = [wrappers[n] for n in MESH_KERNELS]

    def mesh_kinds():
        out = [serve_mesh(models, g, "gcn", gcn_mesh, gcn_compile_s,
                          mesh_kernels)]
        out.append(serve_mesh(models, g, "sage",
                              *mesh_plan(Engine, models, g, "sage"),
                              mesh_kernels))
        return out
    meshed = drive("mesh", mesh_kinds)
    seg_mesh = drive("mesh-segment", lambda: [
        segment_gates(Engine, models, g, kind, "mesh-bsp", sg)
        for kind in SEGMENT_KINDS])
    del gcn_mesh, pg
    for s in meshed:
        log(f"  {s['kind']} mesh: {s['fogs']} fogs, compile "
            f"{s['compile_s']:.2f} s, query {s['query_ms']:.1f} ms (first "
            f"{s['first_query_ms']:.1f}; collect {s['collect_ms']:.1f} / "
            f"execute {s['execute_ms']:.1f} / account "
            f"{s['account_ms']:.1f}), batch of {BATCH} {s['batch_ms']:.1f}"
            f" ms vs serial {s['serial_batch_ms']:.1f} ms; exchange bytes "
            f"per sync: daq {s['exchange_bytes_daq']} / f32 "
            f"{s['exchange_bytes_f32']}")
    failed = []
    for s in meshed:
        c = s["embedding_checks"]
        if s["kind"] in F32_WIRE_GATED_KINDS and c["f32_wire"]["beyond_bar"]:
            failed.append(f"{s['kind']} f32 wire vs the float64 forward "
                          f"beyond rtol {EMB_RTOL} / atol {EMB_ATOL}: "
                          f"{c['f32_wire']}")
        for name in ("query", "batch[3]"):
            if s["kind"] in DAQ_GATED_KINDS and c[name]["ratio"] > 1:
                failed.append(f"{s['kind']} {name} DAQ wire beyond the "
                              f"reference's bar: {c[name]}")
    if failed:
        print(json.dumps({"main_path": served, "mesh_path": meshed}),
              flush=True)
        raise AssertionError("; ".join(failed))
    small_reference(Engine, models, datasets)
    log("  small graph: card == CPU within tolerance, both executors")

    log("phase 3c: dequantize path (ops.dequantize_features)")
    dequantized = drive("dequantize",
                        lambda: dequantize_path(ops, ref, tables))
    del g, csr
    ops._BLOCK_CSR_CACHE.clear()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(registry.get(ARCH), attn_impl="flash")
    log(f"phase 3d: serve path ({cfg.name} at full width: "
        f"{cfg.param_count() / 1e9:.3f} B parameters, flash attention)")
    served_lm = drive("serve", lambda: serve_path(sv, fa, cfg))
    log(f"phase 3e: long prefill (B={PREFILL_B}, S={PREFILL_S})")
    prefilled = drive("prefill", lambda: long_prefill(tf, fa, cfg))
    reduced = small_serve_reference(sv, tf, registry)

    kernel_rows = []
    for name, rec in results.items():
        main_cases = [c for c in rec["cases"] if c["path"] == ROW_PATH[name]]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": max(c["max_abs_err"] for c in rec["cases"]),
            "ms": sum(c["ms"] for c in main_cases),
            "plain_ms": sum(c["plain_ms"] for c in main_cases),
            "bound_ms": sum(c["bound_ms"] for c in main_cases),
            "bound_by": main_cases[-1]["bound_by"],
            "library_ms": sum(c["library_ms"] for c in main_cases),
            **{k: v for k, v in rec.items() if k != "cases"},
            "cases": rec["cases"]})
    print(json.dumps({"compaction": compaction,
                      "main_path": served, "mesh_path": meshed,
                      "segment_sum_path": {"sim": seg_sim,
                                           "mesh": seg_mesh},
                      "dequantize_path": dequantized,
                      "serve_path": served_lm, "prefill_path": prefilled,
                      "reduced_serve": reduced}), flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
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
