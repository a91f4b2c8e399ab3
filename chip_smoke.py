#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

  1. build    nvcc-compiles every CUDA source of ``repro_torch.kernels``
              (sm_90a) into ``build/repro_torch/`` and prints the time, the
              ``ptxas`` report and the number of ``HGMMA`` (wgmma) and
              ``UTMALDG`` (TMA load) instructions in the flash library's
              SASS (``cuobjdump -sass``; none fails the run), and the
              scans' instructions and their longest straight-line blocks
              (``sass_blocks``).
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
                and mask branch of the wgmma kernel), and recurrentgemma-9b's
                local attention at its long prefill (B = 1, S = 4096, H =
                16, KV = 1, dh = 256, window 2048) in bf16 and f32;
                yardstick ``F.scaled_dot_product_attention``;
                selective_scan and rglru_scan (against the f32 step loop
                at rtol 1e-4 / atol 1e-5 with the last state bitwise, and
                the float64 one reported): falcon-mamba-7b's di = 8192 with
                16 states and recurrentgemma-9b's w = 4096, each at a
                served decode step (B = 4, S = 1), a served prefill (B = 4,
                S = 16) and at B = 1, S = 4096, then at ragged edges (B =
                2, S = 37; widths 4,000 / 8,000 and 4,001 / 8,001); no
                library call computes a scan (library_ms null);
                selective_scan_bwd and rglru_scan_bwd (the scans'
                backward kernels, one launch and the partials' fixed-order
                sums) against the plain reverse step loop in float64 on the
                same inputs, every output at rtol 1e-4 / atol 1e-5 *
                max(1, max|want|), two launches bitwise equal: at phase
                3k's training shapes (falcon-mamba B = 2, S = 2048;
                recurrentgemma's micro-batch B = 1, S = 3072), at B = 1,
                S = 4096, at B = 2, S = 37 with 8,001 / 4,001 channels
                and a nonzero gradient of the last state, and at B = 3,
                S = 5 (one partial chunk, fewer than the kernels' ring
                stages); no library call computes either (library_ms
                null);
                segment_sum: the fused gather-and-sum at the layers'
                inputs: full-scale SIoT's edge list over its table (F = 52
                and 64, the sim path's widths), GAT's self-looped list
                (weighted messages at F = 64 and 2, and the F = 1
                denominators), the mesh's folded halo list and the PeMS
                window's list at ASTGCN-lite's one-launch width (F = 36 =
                T_in * F, path "astgcn"), held to the
                float64 plain version and bitwise to the old composition
                (messages gathered, masked and weighted, then summed); two
                launches bitwise equal; reported: how far the card lies
                from the CPU port (the same order, so 0 is expected), for
                the kernel and for ``layers.aggregate_sum``; the old
                composition's time, the longest segment summed alone and
                one launch over one empty segment (the launch floor of
                these timings); yardsticks ``index_add_`` on the
                messages and ``torch.sparse.mm`` of the summed edges as a
                CSR matrix, the faster as the library time; and the
                backward at the training path's gradient widths: the
                same sum over SIoT's transposed orders (``EdgeList.
                transposed``; F = 64 for GCN's and SAGE's layer 2, GAT's
                weighted F = 64 and 2, its F = 1 denominators) and over
                PeMS's at F = 36 (ASTGCN-lite's spatial sum), held to
                the float64 plain version, two launches bitwise equal,
                autograd's launch bitwise the direct one, timed beside
                ``index_add_`` into the source rows and ``torch.sparse.mm``
                of the transposed adjacency; GAT's plain w-gradient
                (the per-entry dot, no kernel) at F = 64; and the
                per-head weighted sum (``headed_sum_kernel``) on the
                folded RMAT-40k layout of stage_rows below, at the
                multi-head GAT's 4 x 256 and 6 x 121: bitwise the plain
                version and a second launch, one launch a call in both
                ``launches`` and ``headed_launches``, timed beside the
                plain version (``headed_cases`` of the row);
                edge_softmax (GAT's softmax, scores to coefficients) on the
                same folded RMAT-40k layout's self-looped halo list, H =
                1 (GAT's) and H = 4 and 6 (the multi-head cell's): bitwise
                the plain chain on the card (its denominators the segment
                sum's) over every entry of the order and a second launch,
                one launch a call and no segment sum; timed beside its
                bytes bound, that chain (``plain_ms``) and the chain with
                library sums (``torch.segment_reduce``: ``library_ms``),
                and the chain's ``scatter_reduce`` max alone;
                dequant: the uint8 and uint16 groups of ``daq_pack`` on
                full-scale SIoT features (also against ``daq_unpack``'s
                float64) and benchmarks/run.py's 128-feature shape, each
                as ``ops.dequantize_features`` sends it (unpadded) and
                padded to the reference's 256 x 128 tiling, plus a
                streaming 131,072 x 128 uint8 table, all bitwise the plain
                version; yardstick ``codes.float() * s + m``;
                row subsets (``gather_aggregate.row_subset``, the launches
                of a frontier query): kernels 1-4 at F = 64 over the
                128-row blocks of the layer-1 frontier of 64 seeded leaf
                sensors, on SIoT and the mesh's local and halo operands, B
                = 1 and 8: the listed rows bitwise the full launch's, the
                others 0, held to the rows plain version in float64 and
                timed beside the full launch;
                stage_rows (the batched mesh path's staging gather) at the
                benchmark's two folded shapes, B = 8: GAT's RMAT-40k (F =
                32) on six fogs cut by capability-weighted ``bgp`` (no
                plan compiled; a P near the cell's) and the mesh's SIoT
                layout (F = 52), and F = 7 at B = 3 (the scalar path): bitwise the
                plain version and the host scatter it replaced, one launch
                a call; timed beside the plain version, a library
                ``index_select`` and the replaced host scatter + H2D (host
                clock). On every path of phases 3-3k its launches must
                equal the path's batched mesh calls (``STAGED_CALLS``,
                counted on ``bsp``), and the mesh and mesh-segment paths
                must make some; not tallied on phase 3l's ranks.
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
              executes, exactly K segment-sum launches an execute (GAT:
              its weighted messages) and K edge-softmax launches (GAT only)
              and 8 times those a batch, and the embeddings against the
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
  3l. mesh over ranks  (run right after 3b) the same mesh with one fog
              per process: six gloo ranks on the card
              (``runtime.dist.spawn``; NCCL refuses two ranks on one
              device, and gloo stages each CUDA tensor of an
              ``all_gather`` through host memory, the wire between the
              fogs), each serving GCN and SAGE on its own shard through
              ``Engine(...).compile(g).session()``: QUERIES DAQ-wire
              queries, QUERIES executes, one ``execute_many`` of 8, one
              ``compressor="none"`` query and one
              ``aggregation="segment_sum"`` query (GAT: the last only,
              its sums stay on the segment sum), with the counts set to
              0 just before and read just after on every rank (path
              ``mesh-dist``, summed over the ranks). Gates: every rank's
              output bitwise the same calls folded in this process; per
              rank exactly K ``block_spmm`` + K ``dequant_spmm`` a DAQ
              query or execute, K + K of the batched forms a batch, 2K
              ``block_spmm`` an f32 query, K segment sums (GAT: and K
              edge softmaxes) a segment query; each BSP sync's bytes on
              the wire (``runtime.dist.WIRE``) the layer's
              ``exchange_bytes``, the first a query's
              ``exchange_bytes``; a four-fog plan on the six-rank group
              refused by world size. Printed per rank and kind: median
              query and execute ms, the ``all_gather`` ms a layer. Then,
              on the same ranks, the faults part (path
              ``mesh-dist-faults``, counts set to 0 just before and read
              just after on every rank): GCN on the DAQ wire and SAGE in
              f32 fail ``fog2(B)`` over through ``Session.failover`` in
              either mode (its rank then holds no shard) and serve a
              first execute, a query, an execute and an ``execute_many``
              of 8 on the five survivors, GAT on the segment sum a query
              after a repair, then each is rebound to the whole plan for a
              query; one structural ``Session.update``; the seeded chaos
              ``Server`` replay of a ``halo_async`` GCN plan
              (``tests/test_torch_faults.py``'s schedule, over six
              nodes). Gates: every rank's outputs,
              rank 2's too, bitwise the folded run's, latencies and tags
              included; per member K ``block_spmm`` + K ``dequant_spmm`` a
              DAQ call, K + K batched a batch, 2K ``block_spmm`` an f32
              call, K segment sums and K edge softmaxes a GAT query,
              rank 2 none on the
              survivors' calls; each sync's bytes
              the survivor plan's ``exchange_bytes``. Printed per rank:
              ``fail_nodes`` ms in both modes, the first execute after it,
              the ``all_gather`` ms a sync, the chaos replay's seconds,
              and the least host memory available while the ranks ran.
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
  3f. server  request-level serving at full SIoT, GCN and SAGE [52, 64,
              2] on the kernel path with the DAQ codec, every replay driven
              with the counts set to 0 just before it and read just after:
              ``server`` (``sim``) and ``server-mesh`` (``mesh-bsp``, halo
              exchange, DAQ halo wire): ``plan.server(max_batch=8)
              .replay(traces.poisson(32, rate=2 / the simulated single-query
              latency, seed=0))``; every response bitwise the serial
              ``Session.query``, K ``block_spmm`` (+ K ``dequant_spmm`` on
              the mesh) per batch of one and K of the batched kernels per
              batch of two or more, and a batch of two or more formed.
              ``server-slo`` (``sim``): an ``SLOPolicy`` with a tight class
              whose deadline lies between the cheapest degraded rung's and
              the native rung's host-only estimates; degraded responses
              bitwise a session with their rung's knobs, the segment sums
              the degraded batches imply, the degradation histogram
              printed. ``server-update`` (GCN, ``sim`` and the mesh): a
              ``traces.mixed`` stream with a feature-only delta (162
              vertices) and a structural one (160 added edges, 16 removed
              vertices), replayed in three parts; every response bitwise a
              fresh compile of the graph it saw (``sim``) or a layout built
              from scratch at the session's assignment (mesh); the updates'
              modes and dirty shards printed, with the host ms of each
              ``apply_delta`` and of the first execute after it.
  3g. frontier, stale, fleet  at full SIoT, GCN and SAGE [52, 64, 2] with
              the DAQ codec, every execute driven with the counts (and the
              block kernels' ``subset_launches``) set to 0 just before it:
              ``Session(activation_cache=True)`` on ``sim`` and ``mesh-bsp``
              (DAQ halo wire) on the kernel path and on
              ``aggregation="segment_sum"`` (GAT too on ``sim``, which must
              fall back), fed a stream whose queries each change n sensors
              of the one before, n in 16 / 64 / 256, drawn from the leaf
              sensors (in-degree <= 1) and then from all, and an
              ``execute_many`` of 8; every result bitwise a cache-less
              execute of the same features, the frontier path taken
              exactly when the cache's own plan admits one (25 % budget),
              at least one query a path on it, exact launches (one subset
              launch a layer and operand); dirty rows, row blocks and host
              ms against the full execute reported. Stale halos on
              ``mesh-bsp``: ``halo_async`` bound 0 bitwise ``halo`` (both
              aggregation paths), bound 2 serving the pattern 0, 1, 2, 0,
              1, each stale serve bitwise ``bsp_infer_stale`` over
              ``build_halo_tables`` of its fresh serve and unlike a fresh
              serve, an update forcing a fresh serve. The fleet:
              ``compile_fleet`` with two sites and the cloud, a
              ``FleetServer`` replay of a geo-tagged Poisson trace with the
              busiest site set down halfway: zero drops, every response
              bitwise its tier's session, exact launches, ``summarize``
              printed.
  3h. faults, verifier  at full SIoT, GCN and SAGE [52, 64, 2] on the
              phase-3 (``sim``) and phase-3b (``mesh-bsp``, DAQ halo wire)
              plans, ``exchange="halo_async"`` with bound 2, every plan of
              the phase (and of phases 3 and 3b) compiled with
              ``validate="strict"``: ``Engine.fail_nodes(plan,
              "fog2(B)")`` in ``mode="repair"`` and ``"recompile"`` (the
              fault checks on its ``FailoverAudit`` silent; a recompile
              plan's host layout ``==`` a fresh compile on the survivors
              and its execute bitwise that plan's; on ``sim`` a repair
              plan's execute bitwise the pre-crash one; on the mesh within
              the DAQ bar of the float64 forward, two executes equal, a
              batch of 8 bitwise 8 serial executes; each plan's launches
              of an execute and a batch those ``kernel_lint.
              launches_for_plan`` predicts; host ms of ``fail_nodes`` and
              of the first execute after it). Chaos through ``Server``: 32
              Poisson requests at phase 3f's rate on the mesh under a
              stale ride-through loss, a retried loss, a straggler on
              fog1(B), a crash of fog2(B) and its recover; the reference's
              seeded chaos property (tests/test_faults.py:370) on ``sim``
              (kernel path and segment sum) and ``single``: 0 drops,
              availability 1.0, every batch's launches exact and its
              outputs bitwise the fresh serve (or, stale, the replay) of
              the plan that served it, untagged responses bitwise the
              fault-free replay's, every response's tags those of a CPU
              replay of the same schedule (host work only). A recover
              after a structural update: the restored plan bitwise a fresh
              compile of the current graph. Phase 3g's fleet with a crash
              and recover in "north": 0 drops, responses bitwise their
              tiers' sessions. The verifier: ``verify_plan`` host ms on
              the four plans, every family silent, and a corrupted copy
              (a dropped halo row) refused. One ``{"fault_path": ...}``
              JSON line.
  3i. training, case study  GCN, SAGE and GAT [52, 64, 2] on full SIoT:
              the first step on the card (exactly TRAIN_LAUNCHES segment-
              sum launches, the backward ones counted apart, and K
              SOFTMAXES edge-softmax launches) with its
              loss and every gradient against the CPU float64 step (rtol
              1e-4 / atol 1e-5); ``train_node_classifier`` at the
              reference's defaults (120 steps, lr 5e-3) from a CUDA
              generator for 1 step and twice for 120, driven as path
              "train": exact launches a step, no call of the plain
              version, ms a step and the losses at steps 1 and 120, two
              runs bitwise equal (every kind). The trained GCN served
              through ``Engine(..., executor="sim", aggregation=
              "pallas")`` with the f32 and the DAQ codec: accuracy drop
              below 0.01 (paper Table IV) and the DAQ embeddings within
              the reference's 8-bit bar of the float64 forward; reported:
              the majority class's share and how many vertices' argmax
              the two codecs share. ``train_astgcn`` (300 steps) on the
              PeMS window from the example's host-drawn init, and the
              same run on the CPU as its witness: the card's final loss
              and ``forecast_errors`` within AST_RTOL of the CPU's; ms a
              step; the one-launch spatial sum over [V, 12 * 3] bitwise
              12 sums of width 3, and it and its autograd gradient
              against the float64 plain version at the kernel bar.
              ``repro_torch.api.demo.main([])`` exits 0 and prints what
              ``--device cpu`` prints: the trained loss within
              DEMO_LOSS_ATOL, each accuracy within one vertex, every
              other line equal. Backward launches are counted by path
              (set to 0 before each, like the launches): nonzero on
              "train", "astgcn" and "demo", 0 on every serving path. One
              ``{"train_path": ...}`` JSON line.
  3j. non-dense decoders  at full width through ``launch.serve.serve``
              with SERVE's traffic (24 requests of 16 tokens, three pods,
              batches of 4), each model its own driven path:
              falcon-mamba-7b (64 Mamba layers), recurrentgemma-9b (38
              layers: RG-LRU and dh-256 local attention, ``attn_impl=
              "flash"``) and deepseek-v3-671b cut to 4 of its 61 layers (3
              dense MLA, 1 MoE of 256 experts; the one depth cut). Per
              model: tokens/s, the median prefill ms and decode ms a step,
              launches exactly those the layer specs imply (a prefill two
              scans a recurrent layer and one flash kernel a local-
              attention layer, a decode step one scan a recurrent layer),
              and in f32 activations the prefill's last logits against a
              forward of its S tokens and the first decode step against a
              forward of S + 1 (deepseek-v3: S + 1 steps decoded from
              empty caches against a dropless forward), max |err| below
              the reference's 5e-3 (tests/test_arch_smoke.py:69).
              recurrentgemma-9b also prefills B = 1, S = 4096 in bf16
              (timed, driven apart). qwen1.5-0.5b decodes 32 steps through
              the int8 cache, held to its bf16 forward at the reference's
              relative bar 0.05. Reduced variants of the four non-dense
              configs are served on the card and on the CPU with the same
              weights (prefill logits within rtol 1e-4 / atol 1e-4). Each
              model is freed before the next. One ``{"nondense_path":
              ...}`` JSON line.
  3k. transformer training  at full width, each model freed before the
              next, driven as its own path: falcon-mamba-7b cut to 4 of
              64 layers (B = 2, S = 2048, one micro-batch) and
              recurrentgemma-9b cut to 3 of 38 (one period; B = 2, S =
              3072, two micro-batches), f32 parameters and bf16
              activations, ``make_train_step`` with remat and AdamW
              (warmup-cosine 3e-4, 2 of 4 steps), batches from
              ``SyntheticCorpus``; 4 steps with a checkpoint at step 2
              (``checkpoint.io``). Gates: restored into fresh parameters
              and state, steps 3-4 bitwise the uninterrupted run's
              parameters, moments and metrics; the first step's loss and
              gradients with remat bitwise those without; in f32
              activations at S = 256 the first step through the kernels
              against the same step through the scans' plain forward and
              backward (rtol 1e-4 / atol 1e-5 scaled per leaf); exact
              launches (forward scans 2 a recurrent layer and micro-batch
              under remat, backward kernels 1, one segment sum a
              micro-batch for the embedding's fixed-order gradient);
              finite losses. Printed: ms a step, training tokens/s, peak
              memory, the backward kernels' share of a step. Reduced
              falcon-mamba, recurrentgemma and deepseek-v3 take one step
              on the card and on the CPU from the same weights (loss and
              gradients at the same bar). ``train-cli``: ``python -m
              repro_torch.launch.train`` at the reference's defaults
              (granite-3-2b, 25m, 100 steps), in this process, then
              resumed to 120: "resumed from step 100", the loss down by
              0.3 (tests/test_substrate.py:82), 3 checkpoints kept. One
              ``{"lm_train_path": ...}`` JSON line.
  4. report   one ``{"kernels": [...]}`` JSON line (every kernel of
              REPLACES and the staging gather, the
              block kernels with their subset cases and subset launches
              by path, the segment sum with its backward launches by
              path; the scans' backward kernels on the training paths),
              the ``nvidia-smi`` name and power limit, and as the last line
              ``{"ok": true, "device": {...}}``. A kernel's top-level
              numbers sum its main-path cases on the path named in
              ``ROW_PATH`` (one call per layer shape: the aggregation work
              of one query or one batch; one attention layer of the
              S = 4096 prefill; one ``dequantize`` drive; a scan at a
              served decode step); ``launches``
              sums the counts of every path driven.

Without a CUDA card, or without the repository's ``src/`` beside it, the
script exits non-zero before printing any result.
"""
import contextlib
import copy
import dataclasses
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# the f32 rate of the CUDA cores and the dense bf16 tensor-core rate (the
# floor of a bf16 attention, whatever this kernel uses).
from repro_torch.launch.mesh import (  # noqa: E402
    H100_SXM_BF16_FLOP_PER_S as PEAK_BF16_FLOP_PER_S,
    H100_SXM_F32_FLOP_PER_S as PEAK_F32_FLOP_PER_S,
    H100_SXM_HBM_BYTES_PER_S as PEAK_BYTES_PER_S)

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4   # tests/test_kernels.py
#: The scans against their f32 plain versions: the reference's kernel bar
#: (tests/test_aggregation.py:51).
SCAN_RTOL, SCAN_ATOL = 1e-4, 1e-5
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
#: ASTGCN-lite's one-launch spatial sum on the PeMS window: T_in = 12
#: steps of F = 3 readings a sensor, one [V, 36] table.
PEMS_WIDTH = 12 * 3
BATCH = 8
QUERIES = 3
ARCH = "qwen1.5-0.5b"
#: The reference's serve defaults (src/repro/launch/serve.py:main).
SERVE = dict(requests=24, tokens=16, pods="1.0,1.6,2.4", batch_size=4,
             placement="iep")
PREFILL_B, PREFILL_S = 2, 4096
GREEDY = 8
#: Phase 3j: the non-dense decoders served at full width, each with its
#: depth cut (None: the full config). deepseek-v3-671b keeps its 3 dense
#: MLA layers and 1 MoE layer of its 61: all 61 need 1.3 TB, one card 80 GB.
NONDENSE = (("falcon-mamba-7b", "serve-falcon-mamba", None),
            ("recurrentgemma-9b", "serve-recurrentgemma", None),
            ("deepseek-v3-671b", "serve-deepseek-v3", 4))
#: recurrentgemma-9b's long prefill (bf16): B = 1, S = 4096, so the local
#: attention's window of 2048 and the dh-256 kernel do real work.
RG_PREFILL_S = 4096
#: The prefill / decode-vs-forward check in f32 activations: the
#: reference's own bar for decode against a forward (max |err| < 5e-3,
#: tests/test_arch_smoke.py:69), on full-width logits.
DECODE_VS_FORWARD_ATOL = 5e-3
#: The int8 KV cache against the bf16 forward: the reference's bar,
#: max |err| / max |logit| < 0.05 (tests/test_serving_variants.py:51).
QUANT_REL_BAR = 0.05
QUANT_STEPS = 32
#: Kinds held to segment-sum determinism on the card (GAT has no other
#: path), the segment sums a layer of each launches (GAT: its weighted
#: messages) and its edge-softmax launches a layer (GAT's softmax, its
#: denominators included, is one launch of ``kernels.edge_softmax``).
SEGMENT_KINDS = ("gcn", "sage", "gat")
SEGMENT_SUMS = {"gcn": 1, "sage": 1, "gat": 1}
SOFTMAXES = {"gcn": 0, "sage": 0, "gat": 1}
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
           "segment_sum": CSRC + "segment_sum.cu",
           "edge_softmax": CSRC + "segment_sum.cu",
           "selective_scan": CSRC + "recurrence.cu",
           "rglru_scan": CSRC + "recurrence.cu",
           "selective_scan_bwd": CSRC + "recurrence.cu",
           "rglru_scan_bwd": CSRC + "recurrence.cu"}
REPLACES = {
    "block_spmm": "src/repro/kernels/gather_aggregate.py:194",
    "block_spmm_batched": "src/repro/kernels/gather_aggregate.py:149",
    "dequant_spmm": "src/repro/kernels/daq_dequant.py:85",
    "dequant_spmm_batched": "src/repro/kernels/daq_dequant.py:149",
    "dequant": "src/repro/kernels/daq_dequant.py:38",
    "flash_attention": "src/repro/kernels/flash_attention.py:67",
    # Not a Pallas kernel: the XLA segment sum of the reference's layers.
    "segment_sum": "src/repro/gnn/layers.py:67",
    # Not a Pallas kernel: the segment max and softmax chain of the
    # reference's GAT layer.
    "edge_softmax": "src/repro/gnn/layers.py:125",
    # Not Pallas kernels: the reference's lax.scan time loops.
    "selective_scan": "src/repro/models/ssm.py:79",
    "rglru_scan": "src/repro/models/ssm.py:163",
    # Not kernels of the reference: the gradients XLA derives for its scans.
    "selective_scan_bwd": "the gradient XLA derives for "
                          "src/repro/models/ssm.py:79",
    "rglru_scan_bwd": "the gradient XLA derives for "
                      "src/repro/models/ssm.py:163",
}
#: The path whose main-path cases make a kernel's top-level numbers.
ROW_PATH = {"block_spmm": "sim", "block_spmm_batched": "sim",
            "dequant_spmm": "mesh", "dequant_spmm_batched": "mesh",
            "dequant": "dequantize", "flash_attention": "prefill",
            "segment_sum": "sim", "edge_softmax": "mesh",
            "selective_scan": "serve-falcon-mamba",
            "rglru_scan": "serve-recurrentgemma",
            "selective_scan_bwd": "train-falcon-mamba",
            "rglru_scan_bwd": "train-recurrentgemma"}
#: The mesh path's four block kernels, in the order its counts are read.
MESH_KERNELS = ("block_spmm", "block_spmm_batched", "dequant_spmm",
                "dequant_spmm_batched")
#: The kernels each driven path must launch.
PATH_KERNELS = {"sim": ("block_spmm", "block_spmm_batched"),
                "sim-segment": ("segment_sum", "edge_softmax"),
                "mesh": MESH_KERNELS,
                "mesh-segment": ("segment_sum", "edge_softmax"),
                "dequantize": ("dequant",),
                "server": ("block_spmm", "block_spmm_batched"),
                "server-mesh": MESH_KERNELS,
                # Phase 3l: every rank's kernel and segment-sum queries,
                # summed over the ranks.
                "mesh-dist": MESH_KERNELS + ("segment_sum", "edge_softmax"),
                # Phase 3l's faults part: the survivors' ranks (a crashed
                # fog's rank launches nothing), summed over the ranks.
                "mesh-dist-faults": MESH_KERNELS + ("segment_sum",
                                                    "edge_softmax"),
                "server-slo": ("segment_sum",),
                "server-update": ("block_spmm", "dequant_spmm"),
                "serve": ("flash_attention",),
                "prefill": ("flash_attention",),
                "frontier-sim": ("block_spmm", "block_spmm_batched"),
                "frontier-mesh": MESH_KERNELS,
                "frontier-sim-segment": ("segment_sum", "edge_softmax"),
                "frontier-mesh-segment": ("segment_sum",),
                "stale": ("block_spmm", "dequant_spmm", "segment_sum"),
                "fleet": ("block_spmm", "block_spmm_batched"),
                "failover": MESH_KERNELS,
                "chaos-mesh": ("block_spmm_batched", "dequant_spmm_batched"),
                "chaos-property": ("block_spmm", "segment_sum"),
                "recover-update": ("block_spmm_batched",
                                   "dequant_spmm_batched"),
                "fleet-faults": ("block_spmm",),
                "train": ("segment_sum", "edge_softmax"),
                "train-serve": ("block_spmm",),
                "astgcn": ("segment_sum",),
                "demo": ("segment_sum", "block_spmm"),
                "serve-falcon-mamba": ("selective_scan",),
                "serve-recurrentgemma": ("rglru_scan", "flash_attention"),
                "prefill-recurrentgemma": ("rglru_scan", "flash_attention"),
                # MLA attends through the chunked path under either
                # attn_impl, as in the reference, and the MoE's expert
                # products are batched matmuls: no hand-written kernel.
                "serve-deepseek-v3": (),
                # Training (phase 3k): the scans forward (and again under
                # remat), their backward kernels, and the embedding's
                # fixed-order gradient (a segment sum). The reference
                # trains through the chunked attention: no flash.
                "train-falcon-mamba": ("selective_scan", "selective_scan_bwd",
                                       "segment_sum"),
                "train-recurrentgemma": ("rglru_scan", "rglru_scan_bwd",
                                         "segment_sum"),
                "train-cli": ("segment_sum",)}
#: The block kernels whose wrappers also count their row-subset launches
#: (``subset_launches``), the launches of a frontier query.
SUBSET_KERNELS = MESH_KERNELS


def log(msg: str) -> None:
    print(msg, flush=True)


class host_memory_low:
    """The least memory the host had available (GiB, ``MemAvailable`` of
    ``/proc/meminfo``) from creation to ``stop()``, sampled by a thread."""

    def __init__(self, every_s: float = 0.2):
        self.low = self.read()
        self.done = threading.Event()
        self.thread = threading.Thread(target=self.sample, args=(every_s,),
                                       daemon=True)
        self.thread.start()

    @staticmethod
    def read() -> float:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 2 ** 20
        raise RuntimeError("/proc/meminfo has no MemAvailable")

    def sample(self, every_s: float) -> None:
        while not self.done.wait(every_s):
            self.low = min(self.low, self.read())

    def stop(self) -> float:
        self.done.set()
        self.thread.join()
        return min(self.low, self.read())


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


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


def sass_blocks(sass: str, kernel: str) -> tuple:
    """``kernel``'s instruction count in ``cuobjdump -sass`` output, and
    (length, MUFU.EX2 count) of its longest straight-line block and of its
    longest one that computes an exp (a block starts at a branch target and
    ends at a branch, call, exit or barrier): the selective scan's
    whole-chunk block (one exp an update); the RG-LRU's chain steps and
    gates (four exps a (t, channel))."""
    body = next((part for part in sass.split("Function : ")[1:]
                 if kernel in part.split("\n", 1)[0]), "")
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    targets = {int(t, 16) for _, text in ins
               for t in re.findall(r"(?:BRA|CALL\S*)\s+0x([0-9a-f]+)", text)}
    blocks, cur = [], []
    for addr, text in ins:
        if int(addr, 16) in targets:
            blocks, cur = blocks + [cur], []
        cur.append(text)
        if re.search(r"\b(BRA|EXIT|CALL|RET|BAR)\b", text):
            blocks, cur = blocks + [cur], []
    stats = [(len(b), sum("MUFU.EX2" in t for t in b)) for b in blocks + [cur]]
    return (len(ins), max(stats, default=(0, 0)),
            max((st for st in stats if st[1]), default=(0, 0)))


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


def gat_mesh_layout(datasets, bsp):
    """A folded layout of the benchmark's GAT cell's source shape, RMAT-40k
    (F = 32) on the six fogs 1A+4B+1C, and the seconds it took: ``bgp``
    cuts the graph in shares of the fogs' capabilities, which gives a slot
    count P near the cell's placement's without that placement's
    profiling of every fog (~19 s)."""
    from repro_torch.core import partition, simulation
    t0 = time.perf_counter()
    g = datasets.load("rmat-40k", 1.0, seed=0)
    caps = np.array([simulation.NODE_CAPABILITY[t] for t in
                     simulation.parse_cluster_spec("1A+4B+1C")])
    assignment = partition.bgp(g, len(caps), weights=caps / caps.sum())
    pg = bsp.build_partitioned(g, assignment, build_blocks=False)
    return pg, time.perf_counter() - t0


def stage_bound(batch: int, src_rows: int, rows: int, f: int) -> tuple:
    """Least time (ms) of one staging gather: the source stack read once,
    the map read once and the output written once, at the HBM rate (no
    arithmetic)."""
    nbytes = 4 * (batch * (src_rows + rows) * f + rows)
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def stage_rows_cases(sr, ref, bsp, layouts) -> dict:
    """Phase 2, the staging gather (``kernels.stage_rows``) at the folded
    layouts ``layouts`` ((name, PartitionedGraph, F) each: the shapes of
    the benchmark's GAT cell at F = 32 and its GCN cell at F = 52, B = 8), plus F = 7 at B
    = 3 (the scalar path) on the last: bitwise the plain version and the
    host form it replaced (``feature_stack``'s scatter, the H2D and the
    fold); one launch a call. Times: the kernel, the plain version (a
    ``cat`` and an ``index_select``), the library's ``index_select`` alone
    over a source with its zero row already appended, and the replaced
    host form on the host clock (ending in a sync)."""
    cases = []
    shapes = [(name, pg, f, BATCH) for name, pg, f in layouts]
    shapes.append((layouts[-1][0], layouts[-1][1], 7, 3))
    dev = torch.device("cuda")
    for name, pg, f, b in shapes:
        row_src = bsp._layout(pg, dev).row_src
        rng = np.random.default_rng(f * 100 + b)
        feats = rng.normal(size=(b, len(pg.part_of), f)).astype(np.float32)
        x = torch.as_tensor(feats, device=dev)
        before = sr.stage_rows.launches
        got = sr.stage_rows(x, row_src)
        if sr.stage_rows.launches != before + 1:
            raise AssertionError("stage_rows: not one launch a call")
        want = ref.stage_rows_ref(x, row_src)
        old = bsp._gathered_stack(torch.as_tensor(pg.feature_stack(feats),
                                                  device=dev))
        for what, other in (("plain version", want), ("host scatter", old)):
            if not torch.equal(got.view(torch.int32),
                               other.view(torch.int32)):
                raise AssertionError(f"stage_rows {name} F={f} B={b}: not "
                                     f"bitwise the {what}")
        padded = torch.cat([x, x.new_zeros((b, 1, f))], 1)
        idx = torch.where(row_src < 0, x.shape[1], row_src).long()
        reps = 50

        def host_form():
            h = bsp._gathered_stack(torch.as_tensor(pg.feature_stack(feats),
                                                    device=dev))
            torch.cuda.synchronize()
            return h
        host_form()
        t0 = time.perf_counter()
        for _ in range(5):
            host_form()
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        bound_ms, bound_by = stage_bound(b, x.shape[1], row_src.shape[0], f)
        rec = {"path": "mesh" if f != 7 else "scalar", "layout": name,
               "B": b, "F": f, "src_rows": int(x.shape[1]),
               "rows": int(row_src.shape[0]), "slots": pg.slots,
               "ms": time_ms(lambda: sr.stage_rows(x, row_src), reps),
               "plain_ms": time_ms(lambda: ref.stage_rows_ref(x, row_src),
                                   reps),
               "library_ms": time_ms(lambda: padded.index_select(1, idx),
                                     reps),
               "replaced_host_ms": host_ms,
               "host_us": host_us(lambda: sr.stage_rows(x, row_src)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": 0.0}
        rec["roofline_pct"] = 100.0 * bound_ms / rec["ms"]
        cases.append(rec)
        log(f"  stage_rows {name} B={b} F={f}: [{b}, {rec['src_rows']}, {f}]"
            f" -> [{b}, {rec['rows']}, {f}] {rec['ms']:.4f} ms (bound "
            f"{bound_ms:.4f}, {rec['roofline_pct']:.1f} %), plain "
            f"{rec['plain_ms']:.4f}, index_select {rec['library_ms']:.4f}, "
            f"the replaced host scatter + H2D {host_ms:.2f} ms; wrapper "
            f"{rec['host_us']:.1f} us")
    return {"stage_rows": {"cases": cases}}


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
                  validate="strict", device="cuda").compile(g)
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


def segment_launches(kind: str, n: int) -> dict:
    """The launches n layer-examples of ``kind`` make on the segment path:
    n SEGMENT_SUMS[kind] segment sums and n SOFTMAXES[kind] edge softmaxes
    (the kernels that launch at all)."""
    want = {"segment_sum": n * SEGMENT_SUMS[kind],
            "edge_softmax": n * SOFTMAXES[kind]}
    return {name: k for name, k in want.items() if k}


def segment_gates(Engine, models, g, kind: str, executor: str, sg,
                  es) -> dict:
    """Phases 3 and 3b, ``aggregation="segment_sum"`` for one kind on one
    executor (seeded weights; on the mesh the halo rows cross as f32, since
    the DAQ halo wire runs only on the kernel path): two executes of the
    same features must be bitwise equal, and an ``execute_many`` of BATCH
    bitwise BATCH serial executes; an execute launches the segment-sum
    kernel SEGMENT_SUMS[kind] times a layer and the edge softmax
    SOFTMAXES[kind] times, a batch BATCH times those (``sg`` and ``es``
    are the kernels' modules). The embeddings are held to the
    float64 forward on the CPU at the embedding bar, gating the kinds in
    SEGMENT_F64_GATED_KINDS and printed for all. Returns the execute times
    (host clock, ending in the copy back) and the checks."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.gnn_init(gen, kind, [g.feature_dim, DIMS_HIDDEN,
                                         DIMS_OUT])
    plan = Engine((params, kind), executor=executor,
                  aggregation="segment_sum", validate="strict",
                  device="cuda").compile(g)
    sess = plan.session()
    per_execute = segment_launches(kind, plan.model.num_layers)
    what = f"{kind} {executor} segment_sum"

    def counts():
        return {"segment_sum": sg.segment_sum.launches,
                "edge_softmax": es.edge_softmax.launches}

    def launched(fn, examples, call):
        before = counts()
        out = fn()
        got = {k: n - before[k] for k, n in counts().items()
               if n != before[k]}
        want = segment_launches(kind, plan.model.num_layers * examples)
        if got != want:
            raise AssertionError(f"{what}: {call} launched {got}, "
                                 f"expected {want}")
        return out

    feats = sess.collect()
    first = launched(lambda: sess.execute(feats), 1, "an execute")
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
    many = launched(lambda: sess.execute_many(stack), BATCH,
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
                  compressor="daq", validate="strict",
                  device="cuda").compile(g)
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
    # recurrentgemma-9b's local attention (MQA, dh 256, window 2048) at
    # phase 3j's B = 1, S = 4096 prefill.
    ("rg local prefill", "model", 1, RG_PREFILL_S, RG_PREFILL_S, 16, 1, 256,
     torch.bfloat16, 2048, 0, "prefill-recurrentgemma"),
    ("rg local prefill f32", "model", 1, RG_PREFILL_S, RG_PREFILL_S, 16, 1,
     256, torch.float32, 2048, 0, None),
    # The same layers at phase 3j's served prefill (B = 4, prompts
    # left-padded to 16): one partial key tile. The f32 case is the shape
    # of phase 3j's f32 decode-vs-forward check.
    ("rg local serve", "model", 4, 16, 16, 16, 1, 256, torch.bfloat16, 2048,
     0, "serve-recurrentgemma"),
    ("rg local serve f32", "model", 4, 16, 16, 16, 1, 256, torch.float32,
     2048, 0, None),
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


#: (name, B, S, width, path): the scans at a served batch's decode step (B =
#: 4, S = 1) and prefill (B = 4, prompts left-padded to 16), both phase 3j's
#: serve, and at one B = 1, S = 4096 sequence (the rglru_scan one is
#: recurrentgemma's long prefill in phase 3j); then ragged edges, S = 37 at
#: B = 2 (a partial last chunk of time, no chunk reading into the next
#: batch row), at 4,000 / 8,000 channels and at an odd width (a partial
#: last CTA of channels: 4,001 and 8,001 are multiples of neither 16 nor
#: 32, which 4,000 and 8,000 are).
SCAN_CASES = {"selective_scan": [("decode", 4, 1, 8192,
                                  "serve-falcon-mamba"),
                                 ("serve prefill", 4, 16, 8192,
                                  "serve-falcon-mamba"),
                                 ("prefill 4096", 1, 4096, 8192, None),
                                 ("ragged S", 2, 37, 8000, None),
                                 ("ragged S, di", 2, 37, 8001, None)],
              "rglru_scan": [("decode", 4, 1, 4096, "serve-recurrentgemma"),
                             ("serve prefill", 4, 16, 4096,
                              "serve-recurrentgemma"),
                             ("prefill 4096", 1, RG_PREFILL_S, 4096,
                              "prefill-recurrentgemma"),
                             ("ragged S", 2, 37, 4000, None),
                             ("ragged S, w", 2, 37, 4001, None)]}
#: Operations per (example, step, channel[, state]), an exp counted as one:
#: the selective scan's dt a, exp, da h, dt b, db x, add, h c, add for each
#: state; the RG-LRU's two gates (a product, exp, add, divide each), log_a,
#: exp, i x, 2 log_a, exp, 1 -, max, sqrt, a h, m gx, add.
SCAN_OPS = {"selective_scan": 8, "rglru_scan": 18}


def scan_bound(name: str, b: int, s: int, width: int, states: int) -> tuple:
    """Least time (ms) of one scan call, the larger of two floors: every
    input read once and every output written once (f32) at the HBM rate,
    and SCAN_OPS operations per element at the f32 rate."""
    if name == "selective_scan":   # dt, x, y; b, c; a; h0, h_last
        floats = (3 * b * s * width + 2 * b * s * states + width * states
                  + 2 * b * width * states)
        ops = SCAN_OPS[name] * b * s * width * states
    else:                          # xc, hs; three gate vectors; h0, h_last
        floats = 2 * b * s * width + 3 * width + 2 * b * width
        ops = SCAN_OPS[name] * b * s * width
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def scan_inputs(name: str, gen, b: int, s: int, width: int) -> tuple:
    """Inputs at ``width`` channels, drawn as the models' layers make them:
    falcon-mamba's 16 states, dt after softplus, a = -exp(log(1..16));
    recurrentgemma's gate scales (0.5) and lambda = 2 plus noise."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    if name == "selective_scan":
        di, st = width, 16
        a = -torch.arange(1, st + 1, device="cuda",
                          dtype=torch.float32).repeat(di, 1)
        return (F.softplus(randn(b, s, di) - 2.0), randn(b, s, st),
                randn(b, s, st), randn(b, s, di), a, randn(b, di, st))
    w = width
    return (randn(b, s, w), randn(w, scale=0.5), randn(w, scale=0.5),
            2.0 + randn(w, scale=0.1), randn(b, w))


def recurrence_cases(rc, ref) -> dict:
    """Phase 2, the recurrence scans: each kernel against its plain version
    (the f32 step loop) on the same inputs at the kernel bar rtol 1e-4 /
    atol 1e-5, with the last state bitwise, a gate (each chain runs its
    steps in time order, every operation rounded alike; y only at the bar:
    its sum over the states runs in another order in the plain version's
    einsum), and against the float64 plain version (reported); times of
    kernel and plain version. No single PyTorch call computes a first-order
    linear recurrence: library_ms is None."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for name, cases in SCAN_CASES.items():
        kern = getattr(rc, name)
        plain = getattr(ref, name + "_ref")
        out[name] = {"cases": []}
        for case, b, s, width, path in cases:
            args = scan_inputs(name, gen, b, s, width)
            got = kern(*args)
            want = plain(*args)
            want64 = plain(*(a.double() for a in args))
            err = errors(got[0], want[0], SCAN_RTOL, SCAN_ATOL)
            err_h = errors(got[1], want[1], SCAN_RTOL, SCAN_ATOL)
            if not all(torch.isfinite(g).all() for g in got) or \
                    max(err["tol_ratio"], err_h["tol_ratio"]) > 1:
                raise AssertionError(f"{name} {case}: {err} / last state "
                                     f"{err_h} beyond rtol {SCAN_RTOL} / "
                                     f"atol {SCAN_ATOL}")
            if not torch.equal(got[1], want[1]):
                raise AssertionError(f"{name} {case}: last state not bitwise "
                                     f"the plain step loop's ({err_h})")
            states = args[4].shape[-1] if name == "selective_scan" else 1
            b_ms, b_by = scan_bound(name, b, s, width, states)
            k_ms = time_ms(lambda: kern(*args), reps=20)
            p_ms = time_ms(lambda: plain(*args), reps=3, warmup=1)
            rec = {"case": name + " " + case, "B": b, "S": s,
                   "width": width, "states": states, "path": path, **err,
                   "last_state_max_abs_err": err_h["max_abs_err"],
                   "last_state_bitwise": bool(torch.equal(got[1], want[1])),
                   "f64_max_abs_err": errors(got[0], want64[0])[
                       "max_abs_err"],
                   "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by}
            out[name]["cases"].append(rec)
            log(f"  {name} {case:13s} B={b} S={s} width={width}: err "
                f"{err['max_abs_err']:.3g} (ratio {err['tol_ratio']:.3g}; "
                f"last state bitwise {rec['last_state_bitwise']}; float64 "
                f"{rec['f64_max_abs_err']:.3g}) kernel {k_ms:.4f} ms  plain "
                f"{p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
            del args, got, want, want64
    torch.cuda.empty_cache()
    return out


#: Phase 2's backward cases of the scans: (case, B, S, width, path, with
#: dh_last): the training paths' shapes (falcon-mamba's B = 2, S = 2048;
#: one of recurrentgemma's micro-batches, B = 1, S = LM_RG_S), the
#: forward's long case, a ragged one (a partial chunk, a partial CTA of
#: channels, a nonzero gradient of the last state) and a short one at
#: B = 3 (S = 5: one partial chunk, fewer than the kernels' ring stages,
#: and a partial cluster of CTAs at 8,001 channels).
SCAN_BWD_CASES = {"selective_scan_bwd": [
    ("train", 2, 2048, 8192, "train-falcon-mamba", False),
    ("prefill 4096", 1, 4096, 8192, None, True),
    ("ragged S, di", 2, 37, 8001, None, True),
    ("short", 3, 5, 8001, None, True)],
    "rglru_scan_bwd": [
    ("train micro-batch", 1, 3072, 4096, "train-recurrentgemma", False),
    ("prefill 4096", 1, 4096, 4096, None, True),
    ("ragged S, w", 2, 37, 4001, None, True),
    ("short", 3, 5, 4001, None, True)]}
#: Operations per (example, step, channel[, state]) of each backward, an
#: exp counted as one. Selective: the states recomputed (dt a, exp, da h,
#: dt b, db x, add: 6), then g += dy c (2), dy h and its sum over the
#: channels (2), g h_{t-1} da (2), g dt (1), g dt b and its sum over the
#: states (2), g x b + gh a and its sum (5), g dt x and its sum (2), gh dt
#: into da (2), g da (1): 25. RG-LRU: the gates recomputed (15 of the
#: forward's 18), the reverse chain (add, product, g h_{t-1}: 3), the
#: gate derivatives (d_m, d_gx, d_v 3, d_log_a 4, d_zr 4, d_zi 4, dxc 5)
#: and the three sums over time (6): 46.
SCAN_BWD_OPS = {"selective_scan_bwd": 25, "rglru_scan_bwd": 46}


def scan_bwd_bound(name: str, b: int, s: int, width: int,
                   states: int) -> tuple:
    """Least time (ms) of one backward call: each input read once and each
    output written once (f32) at the HBM rate, or SCAN_BWD_OPS operations
    per element at the f32 rate, whichever is larger."""
    if name == "selective_scan_bwd":
        # in: dt, x, dy; b, c; a; h0, dh_last. out: ddt, dx; db, dc; da; dh0
        floats = (5 * b * s * width + 4 * b * s * states
                  + 2 * width * states + 3 * b * width * states)
        ops = SCAN_BWD_OPS[name] * b * s * width * states
    else:
        # in: xc, hs, dhs; three gates; h0, dh_last. out: dxc; 3; dh0
        floats = 4 * b * s * width + 6 * width + 3 * b * width
        ops = SCAN_BWD_OPS[name] * b * s * width
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def recurrence_bwd_cases(rc, ref) -> dict:
    """Phase 2, the scans' backward kernels: one backward launch (and the
    partials' fixed-order sums) against the plain reverse step loop
    evaluated in float64 on the same inputs, every output at the kernel bar
    rtol 1e-4 / atol 1e-5 * max(1, max|want|); two launches bitwise equal;
    times of the backward and of the f32 plain version. No PyTorch call
    computes either gradient: library_ms is None."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for name, cases in SCAN_BWD_CASES.items():
        out[name] = {"cases": []}
        fwd = name.removesuffix("_bwd")
        for case, b, s, width, path, with_dh in cases:
            args = scan_inputs(fwd, gen, b, s, width)
            if fwd == "selective_scan":
                dy = torch.randn(args[0].shape, generator=gen, device="cuda")
                dh = (torch.randn(args[5].shape, generator=gen, device="cuda")
                      if with_dh else None)
                kern = lambda: rc._selective_bwd(*args, dy, dh)  # noqa: E731
                plain = ref.selective_scan_bwd_ref
                plain_args = (*args, dy, dh)
                outs = ("ddt", "db", "dc", "dx", "da", "dh0")
            else:
                hs, _ = rc._rglru_fwd(*args)
                dy = torch.randn(hs.shape, generator=gen, device="cuda")
                dh = (torch.randn(args[4].shape, generator=gen, device="cuda")
                      if with_dh else None)
                kern = lambda: rc._rglru_bwd(*args, hs, dy, dh)  # noqa: E731
                plain_args = (*args, hs, dy, dh)
                plain = ref.rglru_scan_bwd_ref
                outs = ("dxc", "dw_input_gate", "dw_rec_gate", "dlambda_p",
                        "dh0")
            got = kern()
            again = kern()
            bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
            d64 = [None if t is None else t.double() for t in plain_args]
            if fwd == "rglru_scan":   # the float64 forward's own states
                d64[5] = ref.rglru_scan_ref(*d64[:5])[0]
            want = plain(*d64)
            errs = {}
            for o, g, w in zip(outs, got, want):
                atol = SCAN_ATOL * max(1.0, float(w.abs().max()))
                errs[o] = errors(g, w, SCAN_RTOL, atol)
            worst = max(e["tol_ratio"] for e in errs.values())
            if not bitwise or worst > 1 or not all(
                    torch.isfinite(g).all() for g in got):
                raise AssertionError(f"{name} {case}: bitwise {bitwise}, "
                                     f"errors {errs}")
            del again, want, d64
            states = args[4].shape[-1] if fwd == "selective_scan" else 1
            b_ms, b_by = scan_bwd_bound(name, b, s, width, states)
            k_ms = time_ms(kern, reps=10)
            p_ms = time_ms(lambda: plain(*plain_args), reps=2, warmup=1)
            rec = {"case": name + " " + case, "B": b, "S": s, "width": width,
                   "states": states, "path": path, "dh_last": with_dh,
                   "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                   "tol_ratio": worst, "errors": errs, "bitwise": bitwise,
                   "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by}
            out[name]["cases"].append(rec)
            log(f"  {name} {case:17s} B={b} S={s} width={width}: worst "
                f"ratio {worst:.3g} (max err {rec['max_abs_err']:.3g}), "
                f"bitwise run to run {bitwise}; backward {k_ms:.4f} ms  "
                f"plain {p_ms:.2f} ms  bound {b_ms:.4f} ms ({b_by})  "
                f"library: none")
            del args, got, dy, dh, plain_args
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


def segment_cases(sg, ref, layers, bsp, g, pg, pems) -> dict:
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
             ("pems", pems, PEMS_WIDTH, pems.num_vertices, False, "astgcn"),
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


#: (heads, head width D) of the per-head sums of gat-ppi-rmat40k's layers:
#: the hidden layers' 4 x 256 and the last layer's 6 x 121.
HEADED_SHAPES = ((4, 256), (6, 121))


def headed_bound(rows_read: int, f: int, summed: int, v: int,
                 heads: int) -> tuple:
    """Least time (ms) of one per-head weighted sum, as ``segment_bound``
    with H weights an entry in place of one."""
    nbytes = 4 * (rows_read * f + summed * (2 + heads) + (v + 1) + v * f)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * summed * f / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def headed_sum_cases(sg, ref, bsp, pg) -> list:
    """Phase 2, the per-head weighted sum (``headed_sum_kernel``) on the
    folded RMAT-40k layout ``pg`` (``gat_mesh_layout``): GAT's self-looped
    halo list over the [n*P | n*B] table, at ``HEADED_SHAPES``' rows of H *
    D floats with random per-head weights (0 on masked edges). Each launch
    bitwise the plain version (``ref.headed_segment_sum_ref``) and a second
    launch, one launch a call counted in both ``segment_sum.launches`` and
    ``segment_sum.headed_launches``; timed beside the plain version, with
    the seconds the case took."""
    t_all = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(9)
    el = bsp._edges(pg, torch.device("cuda"), "halo", "gat_heads")
    rows = pg.n * (pg.slots + pg.boundary_slots)
    idx, order, offsets = el.gather, el.order, el.offsets
    summed, v = order.shape[0], el.num_vertices
    rows_read = int(torch.unique(idx).numel())
    cases = []
    for heads, d in HEADED_SHAPES:
        t0 = time.perf_counter()
        f = heads * d
        x = torch.randn((rows, f), generator=gen, device="cuda")
        w = (torch.rand((el.receivers.shape[0], heads), generator=gen,
                        device="cuda") * el.mask[:, None])
        longs = el.long_segments(f)

        def call():
            return sg.segment_sum(x, order, offsets, idx=idx, w=w,
                                  long=longs)
        before = (sg.segment_sum.launches, sg.segment_sum.headed_launches)
        got = call()
        after = (sg.segment_sum.launches, sg.segment_sum.headed_launches)
        if (after[0] - before[0], after[1] - before[1]) != (1, 1):
            raise AssertionError(f"headed_sum H={heads} D={d}: "
                                 f"{after[0] - before[0]} launches, "
                                 f"{after[1] - before[1]} headed launches "
                                 f"for one call")
        want = ref.headed_segment_sum_ref(x, idx, offsets, order, w)
        for what, other in (("plain version", want), ("second launch",
                                                      call())):
            if not torch.equal(got.view(torch.int32),
                               other.view(torch.int32)):
                raise AssertionError(f"headed_sum H={heads} D={d}: not "
                                     f"bitwise the {what}")
        del got, want
        b_ms, b_by = headed_bound(rows_read, f, summed, v, heads)
        k_ms = time_ms(call, reps=30)
        p_ms = time_ms(lambda: ref.headed_segment_sum_ref(
            x, idx, offsets, order, w), reps=5)
        rec = {"case": "rmat-40k mesh halo", "path": "mesh", "H": heads,
               "D": d, "F": f, "rows": rows, "summed": summed, "V": v,
               "source_rows": rows_read,
               "long_segments": int(longs.ids.numel()),
               "max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "roofline_pct": 100.0 * b_ms / k_ms}
        del x, w
        torch.cuda.empty_cache()
        rec["case_s"] = time.perf_counter() - t0
        cases.append(rec)
        log(f"  headed_sum H={heads} D={d}: [{rows}, {f}] -> [{v}, {f}] "
            f"over {summed} entries, bitwise the plain version, one launch "
            f"a call; {k_ms:.4f} ms (bound {b_ms:.4f} ms, {b_by}, "
            f"{rec['roofline_pct']:.1f} %), plain {p_ms:.4f} ms; case "
            f"{rec['case_s']:.2f} s")
    log(f"  headed_sum cases, the edge list's build included: "
        f"{time.perf_counter() - t_all:.2f} s")
    return cases


#: Heads of the edge-softmax cases: GAT's one, the multi-head cell's 4 and 6.
SOFTMAX_HEADS = (1, 4, 6)


def softmax_bound(rows_read: int, v: int, summed: int, heads: int) -> tuple:
    """Least time (ms) of one edge softmax: the source scores of the rows
    it gathers and the receivers' scores read once, the offsets once, the
    order and the gather index once and a coefficient written an entry and
    head, at the HBM rate; or seven operations an entry and head (an add,
    the leaky product, a max, a subtraction, an exponent, an add and a
    division) at the f32 rate."""
    nbytes = 4 * (rows_read * heads + v * heads + (v + 1)
                  + summed * (2 + heads))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 7 * summed * heads / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def edge_softmax_cases(es, sg, ref, bsp, pg) -> list:
    """Phase 2, GAT's edge softmax (``edge_softmax_kernel``) on the folded
    RMAT-40k layout ``pg`` (``gat_mesh_layout``): GAT's self-looped halo
    list over the [n*P | n*B] table at SOFTMAX_HEADS heads, N(0, 2) scores.
    Each launch bitwise the plain chain on the card (``ref.
    edge_softmax_ref``, its denominators the segment-sum kernel's, as the
    layer ran it) over every entry of the order, and a second launch; one
    launch a call and no segment sum. Timed beside the chain (plain_ms),
    the chain with ``torch.segment_reduce`` sums (library_ms: library calls
    only) and the chain's ``scatter_reduce`` max alone, with the seconds
    the case took. H = 1 is GAT's layer (path "mesh"), H = 4 and 6 the
    multi-head cell's (path "mesh-heads")."""
    t_all = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    el = bsp._edges(pg, torch.device("cuda"), "halo", "gat")
    rows = pg.n * (pg.slots + pg.boundary_slots)
    order, v = el.order, el.num_vertices
    kept = order.long()
    summed = order.shape[0]
    rows_read = int(torch.unique(el.gather).numel())
    n_long = int(el.long_segments(es.LONG_FEATURES).ids.numel())
    total = es._total(el)
    cases = []
    for heads in SOFTMAX_HEADS:
        t0 = time.perf_counter()
        shape = () if heads == 1 else (heads,)
        a_src = torch.randn((rows,) + shape, generator=gen,
                            device="cuda") * 2.0
        a_dst = torch.randn((v,) + shape, generator=gen, device="cuda") * 2.0

        def call():
            return es.edge_softmax(a_src, a_dst, el)

        def plain(sums=total):
            return ref.edge_softmax_ref(a_src, a_dst, el.senders,
                                        el.receivers, el.mask, order,
                                        el.offsets, sums)

        def library():
            return plain(None)

        def scatter_max():
            logits = torch.where(el.mask > 0, a_src.movedim(0, -1)[
                ..., el.senders], -torch.inf)
            return torch.full(logits.shape[:-1] + (v,), -torch.inf,
                              device="cuda").scatter_reduce(
                -1, el.receivers.long().expand_as(logits), logits, "amax",
                include_self=False)

        before = (es.edge_softmax.launches, sg.segment_sum.launches)
        got = call()
        after = (es.edge_softmax.launches, sg.segment_sum.launches)
        if (after[0] - before[0], after[1] - before[1]) != (1, 0):
            raise AssertionError(f"edge_softmax H={heads}: "
                                 f"{after[0] - before[0]} launches and "
                                 f"{after[1] - before[1]} segment sums for "
                                 f"one call")
        want = plain()
        for what, other in (("plain chain", want), ("second launch",
                                                    call())):
            if not torch.equal(got[kept].view(torch.int32),
                               other[kept].view(torch.int32)):
                bad = int((got[kept] != other[kept]).sum())
                raise AssertionError(f"edge_softmax H={heads}: not bitwise "
                                     f"the {what} ({bad} entries differ)")
        lib_err = float((library()[kept] - got[kept]).abs().max())
        del got, want
        b_ms, b_by = softmax_bound(rows_read, v, summed, heads)
        k_ms = time_ms(call, reps=30)
        p_ms = time_ms(plain, reps=10)
        l_ms = time_ms(library, reps=10)
        m_ms = time_ms(scatter_max, reps=10)
        rec = {"case": "rmat-40k mesh halo",
               "path": "mesh" if heads == 1 else "mesh-heads", "H": heads,
               "rows": rows, "summed": summed,
               "edges": int(el.senders.shape[0]), "V": v,
               "source_rows": rows_read, "long_segments": n_long,
               "max_abs_err": 0.0, "library_max_abs_diff": lib_err,
               "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "scatter_max_ms": m_ms, "bound_ms": b_ms, "bound_by": b_by,
               "roofline_pct": 100.0 * b_ms / k_ms}
        del a_src, a_dst
        torch.cuda.empty_cache()
        rec["case_s"] = time.perf_counter() - t0
        cases.append(rec)
        log(f"  edge_softmax H={heads}: {summed} entries of "
            f"{rec['edges']} edges into {v} receivers ({n_long} long), "
            f"bitwise the plain chain and a second launch, one launch a "
            f"call; {k_ms:.4f} ms (bound {b_ms:.4f} ms, {b_by}, "
            f"{rec['roofline_pct']:.1f} %), plain chain {p_ms:.4f} ms, "
            f"library chain {l_ms:.4f} ms (max diff {lib_err:.3g}), its "
            f"scatter max {m_ms:.4f} ms; case {rec['case_s']:.2f} s")
    log(f"  edge_softmax cases, the edge list's build included: "
        f"{time.perf_counter() - t_all:.2f} s")
    return cases


def wgrad_bound(src_rows: int, g_rows: int, f: int, summed: int,
                entries: int) -> tuple:
    """Least time (ms) of the w-gradient ``<x[idx[k]], g[v]>``: the
    distinct rows of x and of g it reads (4 F bytes each), idx, the
    entries' segments and order (4 bytes an entry each) once, the
    gradient of every entry of w (4 bytes, masked ones 0) written once;
    a product and an add per summed entry and feature at the f32 peak."""
    nbytes = 4 * ((src_rows + g_rows) * f + 3 * summed + entries)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * summed * f / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def segment_backward_cases(sg, ref, layers, g, pems) -> list:
    """Phase 2, the segment sum's backward at the gradient widths of the
    training path on full-scale SIoT: the sum over the transposed order
    (``EdgeList.transposed``: entries sorted by source row, each with its
    receiver as the gather index) that gives the gradient for x, for
    GCN's and SAGE's layer-2 input (F = 64, unweighted), GAT's weighted
    messages (F = 64 and 2, over the self-looped list) and GAT's F = 1
    denominators (one term per edge), and ASTGCN-lite's spatial sum over
    the PeMS window's list (``pems``, F = 36); and the plain w-gradient
    (the per-entry dot) on GAT's F = 64 case. Each is held to its plain version
    in float64 at the kernel bar; two launches must be bitwise equal and
    the launch ``autograd`` makes bitwise the direct one. Beside each: the
    plain version (f32), the bound, and two library calls that compute
    the same gradient (timed, never called by the port): ``index_add_`` of
    the edges' messages ``g[receiver] (* w)`` into the source rows and
    ``torch.sparse.mm`` of the transposed adjacency with g."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    edges = layers.EdgeList.from_graph(g, device="cuda")
    looped = edges.self_looped
    # (name, edges, F, per_edge, weighted, path)
    cases = [("siot bwd", edges, 64, False, False, "train"),
             ("siot gat bwd", looped, 64, False, True, None),
             ("siot gat bwd", looped, 2, False, True, None),
             ("siot gat denom bwd", looped, 1, True, False, None),
             ("pems bwd", pems, PEMS_WIDTH, False, False, "astgcn")]
    recs = []
    for name, el, f, per_edge, weighted, path in cases:
        e, v = el.receivers.shape[0], el.num_vertices
        rows = e if per_edge else v
        t = el.transposed(rows, per_edge)
        longs = t.long_segments(f)
        gshape = (v,) if per_edge else (v, f)
        grad = torch.randn(gshape, generator=gen, device="cuda")
        w = (torch.rand(e, generator=gen, device="cuda") * el.mask
             if weighted else None)
        x = torch.randn((e,) if per_edge else (v, f), generator=gen,
                        device="cuda")

        def call():
            return sg.segment_sum(grad, t.order, t.offsets, idx=t.idx, w=w,
                                  long=longs)

        def plain():
            return ref.gather_segment_sum_ref(grad, t.idx, t.offsets,
                                              order=t.order, w=w)
        kept = el.order.long()
        send = (kept if per_edge else el.senders.long()[kept])
        recv = el.receivers.long()[kept]
        msgs = grad.index_select(0, recv)
        if w is not None:
            msgs = msgs * w.index_select(0, kept)[:, None]

        def index_add():
            return msgs.new_zeros((rows,) + tuple(msgs.shape[1:])
                                  ).index_add_(0, send, msgs)
        vals = (torch.ones(t.order.shape[0], device="cuda") if w is None
                else w.index_select(0, t.order.long()))
        at_csr = torch.sparse_csr_tensor(t.offsets.long(), t.idx.long(),
                                         vals, size=(rows, v))
        g2 = grad[:, None] if per_edge else grad

        def sparse_mm():
            return torch.sparse.mm(at_csr, g2)
        got = call()
        if not torch.equal(got, call()):
            raise AssertionError(f"segment_sum {name} F={f}: two backward "
                                 f"launches differ")
        xr = x.clone().requires_grad_()
        out = sg.segment_sum(xr, el.order, el.offsets,
                             idx=None if per_edge else el.gather, w=w,
                             long=el.long_segments(f), transposed=lambda: t)
        if not torch.equal(torch.autograd.grad(out, xr, grad)[0], got):
            raise AssertionError(f"segment_sum {name} F={f}: autograd's "
                                 f"backward is not the transposed sum")
        want = ref.gather_segment_sum_ref(
            grad.double(), t.idx, t.offsets, order=t.order,
            w=None if w is None else w.double())
        err = errors(got, want)
        err["plain_f32_max_abs_err"] = errors(plain(), want)["max_abs_err"]
        check_close(f"segment_sum {name} F={f}", got.double(), want,
                    KERNEL_RTOL, KERNEL_ATOL)
        check_close(f"index_add_ {name} F={f}", index_add().double(), want,
                    KERNEL_RTOL, KERNEL_ATOL)
        check_close(f"sparse.mm {name} F={f}",
                    sparse_mm().reshape(got.shape).double(), want,
                    KERNEL_RTOL, KERNEL_ATOL)
        k_ms = time_ms(call, reps=30)
        p_ms = time_ms(plain, reps=10)
        i_ms = time_ms(index_add, reps=30)
        s_ms = time_ms(sparse_mm, reps=30)
        counts = t.offsets[1:] - t.offsets[:-1]
        summed = t.order.shape[0]
        rows_read = int(torch.unique(t.idx).numel())
        b_ms, b_by = segment_bound(rows_read, f, summed, rows, weighted)
        rec = {"case": name, "F": f, "E": e, "summed": summed, "V": rows,
               "source_rows": rows_read, "weighted": weighted,
               "backward": True,
               "longest_segment": int(counts.max()),
               "long_segments": int(longs.ids.numel()),
               "long_threshold": longs.threshold, "path": path, **err,
               "ms": k_ms, "plain_ms": p_ms, "index_add_ms": i_ms,
               "sparse_mm_ms": s_ms, "library_ms": min(i_ms, s_ms),
               "library": "index_add_" if i_ms <= s_ms else "sparse.mm",
               "bound_ms": b_ms, "bound_by": b_by}
        recs.append(rec)
        log(f"  segment_sum {name:18s} F={f:2d} (transposed: {rows} rows, "
            f"longest {rec['longest_segment']}, {rec['long_segments']} "
            f"long) err {err['max_abs_err']:.3g} kernel {k_ms:.4f} ms  "
            f"plain {p_ms:.4f} ms  index_add_ {i_ms:.4f} ms  sparse.mm "
            f"{s_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        if weighted and f == 64:
            recs.append(wgrad_case(sg, el, t, x, grad, w, name, f))
        del grad, w, x, msgs, at_csr, got, want
    return recs


def wgrad_case(sg, el, t, x, grad, w, name: str, f: int) -> dict:
    """Phase 2, the w-gradient of a weighted sum (GAT's coefficients):
    what ``_SegmentSum.backward`` computes in plain PyTorch (the per-entry
    dot ``<x[idx[k]], g[v]>``, scattered to the entries' edges), held to
    the same in float64 at the kernel bar, two calls bitwise equal; no
    kernel, so no library yardstick."""
    wr = w.clone().requires_grad_()

    def wgrad():
        out = sg.segment_sum(x, el.order, el.offsets, idx=el.gather, w=wr,
                             transposed=lambda: t)
        return torch.autograd.grad(out, wr, grad)[0]

    def dots():   # the backward's own arithmetic, without the forward
        d = (x.index_select(0, el.gather.long())
             * grad.index_select(0, t.segment.long())).sum(-1)
        return torch.zeros_like(w).index_copy_(0, el.order.long(), d)
    got = wgrad()
    if not torch.equal(got, wgrad()) or not torch.equal(got, dots()):
        raise AssertionError(f"w-gradient {name} F={f}: not deterministic "
                             f"or not the per-entry dot")
    x64, g64 = x.double(), grad.double()
    want = torch.zeros_like(w, dtype=torch.float64).index_copy_(
        0, el.order.long(),
        (x64.index_select(0, el.gather.long())
         * g64.index_select(0, t.segment.long())).sum(-1))
    err = errors(got, want)
    check_close(f"w-gradient {name} F={f}", got.double(), want, KERNEL_RTOL,
                KERNEL_ATOL)
    ms = time_ms(dots, reps=30)
    summed = el.order.shape[0]
    b_ms, b_by = wgrad_bound(int(torch.unique(el.gather).numel()),
                             int(torch.unique(t.idx).numel()), f, summed,
                             w.shape[0])
    log(f"  w-gradient {name:19s} F={f:2d} (plain PyTorch, no kernel) err "
        f"{err['max_abs_err']:.3g} {ms:.4f} ms  bound {b_ms:.4f} ms "
        f"({b_by})")
    return {"case": f"{name} w-gradient", "F": f, "E": w.shape[0],
            "summed": summed, "weighted": True, "backward": True,
            "kernel": False, "path": None, **err, "ms": ms, "plain_ms": ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


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


#: Phase 3f: requests of each server replay, the server's batch cap, the
#: kinds served, and the mixed trace of the update path (its length, its
#: update fraction, and the two deltas: feature upserts over ~1 % of SIoT's
#: vertices, then added edges and removed vertices of that size).
SERVER_REQUESTS = 32
SERVER_MAX_BATCH = 8
SERVER_KINDS = ("gcn", "sage")
MIXED_REQUESTS, MIXED_UPDATE_FRACTION = 24, 0.1
UPDATE_UPSERTS, UPDATE_EDGES, UPDATE_REMOVED = 162, 160, 16


def server_plan(Engine, models, g, kind: str, executor: str):
    """Phase 3f's plan of ``kind``: seeded [52, 64, 2] weights, the kernel
    path and the DAQ codec on the default cluster (on the mesh: the halo
    exchange with the DAQ halo wire). Returns the plan and its compile s."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.gnn_init(gen, kind, [g.feature_dim, DIMS_HIDDEN,
                                         DIMS_OUT])
    t0 = time.perf_counter()
    plan = Engine((params, kind), cluster="1A+4B+1C", executor=executor,
                  exchange="halo", aggregation="pallas", compressor="daq",
                  device="cuda").compile(g)
    return plan, time.perf_counter() - t0


def server_rate(plan) -> float:
    """2 / the plan's simulated single-query latency (host only, before any
    replay): arrivals outpace one query's service often enough that
    micro-batches form."""
    return 2.0 / plan.session().account().total_latency


def batches_of(responses) -> dict:
    """batch_index -> (batch size, ladder rung) of a replay's responses."""
    from repro_torch.api.server import Response
    return {r.batch_index: (r.batch_size, r.degradation)
            for r in responses if isinstance(r, Response)}


def expected_launches(responses, plan, mesh: bool, ladder=()) -> dict:
    """The launches a replay's batches imply: a batch of one K
    ``block_spmm`` (and K ``dequant_spmm`` on the mesh's DAQ wire), a batch
    of two or more K of the batched kernels; a batch of b on a segment-sum
    rung of L layers ``segment_launches(kind, b * L)`` (the rule of
    ``segment_gates``)."""
    want = dict.fromkeys(REPLACES, 0)
    k = plan.model.num_layers
    for b, level in batches_of(responses).values():
        if level:
            rung = ladder[level - 1]
            if rung.aggregation != "segment_sum":
                raise AssertionError(f"rung {rung} is not a segment-sum rung")
            for name, n in segment_launches(
                    plan.model.kind, b * (rung.num_layers or k)).items():
                want[name] += n
            continue
        suffix = "" if b == 1 else "_batched"
        want["block_spmm" + suffix] += k
        if mesh:
            want["dequant_spmm" + suffix] += k
    return want


def check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: launched {got}, expected {want}")


def replay_thunk(srv, trace):
    """One replay of ``trace`` on ``srv``, returning the responses, the
    session's plan after it and the host seconds of the replay."""
    def run():
        t0 = time.perf_counter()
        out = srv.replay(trace)
        return out, srv.session.plan, time.perf_counter() - t0
    return run


def server_summary(srv, out, wall_s: float) -> dict:
    """The replay's simulated-clock summary, batch-size histogram and host
    time."""
    summary = srv.summarize(out)
    hist = {}
    for b, _ in batches_of(out).values():
        hist[b] = hist.get(b, 0) + 1
    served = summary["requests"]
    return {"batch_histogram": {str(b): hist[b] for b in sorted(hist)},
            "replay_s": wall_s, "host_ms_per_request": wall_s * 1e3
            / max(served, 1),
            **{k: summary[k] for k in ("requests", "rejected", "updates",
                                       "batches", "mean_batch", "makespan_s",
                                       "throughput_rps", "latency_p50_s",
                                       "latency_p95_s", "degraded")}}


def check_server(case: dict, out, counts: dict, mesh: bool) -> dict:
    """Gates of one ``server`` / ``server-mesh`` replay: exact launches by
    batch size, a batch of two or more, and every response bitwise the
    serial ``Session.query`` of its request (stored features: one query
    covers them all). Returns the record."""
    plan, what = case["plan"], case["what"]
    responses, _, wall_s = out
    check_launches(what, counts, expected_launches(responses, plan, mesh))
    rec = {"kind": plan.model.kind, "executor": plan.config.executor,
           "rate_rps": case["rate"], "compile_s": case["compile_s"],
           "launches": counts, **server_summary(case["srv"], responses,
                                                wall_s)}
    if max(int(b) for b in rec["batch_histogram"]) < 2:
        raise AssertionError(f"{what}: no batch of two or more formed "
                             f"({rec['batch_histogram']})")
    t0 = time.perf_counter()
    want = plan.session().query().embeddings
    rec["serial_query_ms"] = (time.perf_counter() - t0) * 1e3
    for r in responses:
        if not np.array_equal(r.embeddings, want):
            raise AssertionError(f"{what}: response {r.request_id} (batch "
                                 f"of {r.batch_size}) is not bitwise the "
                                 f"serial query")
    log(f"  {what}: {rec['requests']} requests at {case['rate']:.2f}/s, "
        f"batches {rec['batch_histogram']}, bitwise the serial query; "
        f"replay {wall_s:.2f} s ({rec['host_ms_per_request']:.1f} ms a "
        f"request, serial query {rec['serial_query_ms']:.1f} ms); simulated "
        f"p95 {rec['latency_p95_s'] * 1e3:.1f} ms, "
        f"{rec['throughput_rps']:.2f} req/s; launches {counts}")
    return rec


def slo_case(plan, kind: str, traces, slo) -> dict:
    """The server-slo replay of ``kind``: two equally likely classes, a
    tight one (priority 1) whose deadline lies between the cheapest
    degraded rung's and the native rung's per-request estimates (so every
    batch holding one is served on a degraded rung, all of which sum on
    ``segment_sum``) and a loose one (priority 0, ten native services).
    The estimates are host-only ``account`` calls before the replay; late
    requests are served at the last rung rather than rejected."""
    srv = plan.server(max_batch=SERVER_MAX_BATCH,
                      slo=slo.SLOPolicy(reject_hopeless=False))
    rungs = [{}] + [r.knobs() for r in srv.ladder]
    svc = [plan.session(**kn).account().total_latency for kn in rungs]
    if min(svc[1:]) >= svc[0]:
        raise AssertionError(f"{kind}: no degraded rung is cheaper: {svc}")
    tight = (svc[0] + min(svc[1:])) / 2.0
    trace = traces.poisson(SERVER_REQUESTS, server_rate(plan), seed=0,
                           slo_fn=slo.slo_classes([(0.5, 1, tight),
                                                   (0.5, 0, 10 * svc[0])]))
    if not any(r.deadline == tight for r in trace):
        raise AssertionError(f"{kind}: the trace drew no tight request")
    return {"what": f"{kind} server-slo", "plan": plan, "srv": srv,
            "trace": trace, "rung_estimates_s": svc, "tight_s": tight,
            "ladder": [r.name for r in srv.ladder]}


def check_slo(case: dict, out, counts: dict) -> dict:
    """Gates of one server-slo replay: exact launches (segment sums by the
    degraded batches), a batch on a segment-sum rung, and every response
    bitwise a session configured with its rung's knobs."""
    plan, srv, what = case["plan"], case["srv"], case["what"]
    responses, _, wall_s = out
    check_launches(what, counts, expected_launches(responses, plan, False,
                                                   srv.ladder))
    levels = {}
    for b, level in batches_of(responses).values():
        levels.setdefault(level, [0, 0])
        levels[level][0] += 1
        levels[level][1] += b
    if not any(level for level in levels):
        raise AssertionError(f"{what}: no batch was served on a degraded "
                             f"(segment-sum) rung")
    for level in levels:
        knobs = srv.ladder[level - 1].knobs() if level else {}
        want = plan.session(**knobs).query().embeddings
        for r in responses:
            if r.degradation == level and not np.array_equal(r.embeddings,
                                                             want):
                raise AssertionError(f"{what}: response {r.request_id} on "
                                     f"rung {level} is not bitwise a "
                                     f"session with {knobs}")
    hist = {str(lv): {"batches": n, "requests": q}
            for lv, (n, q) in sorted(levels.items())}
    rec = {"kind": plan.model.kind, "ladder": case["ladder"],
           "rung_estimates_s": case["rung_estimates_s"],
           "tight_deadline_s": case["tight_s"], "launches": counts,
           "degradation_histogram": hist,
           **server_summary(srv, responses, wall_s)}
    log(f"  {what}: ladder {case['ladder']}, rung estimates "
        f"{[round(x * 1e3, 1) for x in case['rung_estimates_s']]} ms, tight "
        f"deadline {case['tight_s'] * 1e3:.1f} ms; degradation histogram "
        f"(rung: batches / requests) {hist}; degraded responses bitwise "
        f"their rung's session; replay {wall_s:.2f} s; launches {counts}")
    return rec


def mixed_trace(traces, GraphDelta, UpdateRequest, g, rate: float):
    """The update path's mixed trace: the first seed whose Poisson stream
    holds exactly two updates with queries before, between and after them;
    the first update upserts UPDATE_UPSERTS vertices' features, the second
    adds UPDATE_EDGES edges and removes UPDATE_REMOVED vertices. Returns the
    trace split after each update (three replays) and the two deltas."""
    def probe(i, rng):
        return GraphDelta()
    for seed in range(200):
        t = traces.mixed(MIXED_REQUESTS, rate, delta_fn=probe, seed=seed,
                         update_fraction=MIXED_UPDATE_FRACTION)
        at = [i for i, r in enumerate(t) if isinstance(r, UpdateRequest)]
        if (len(at) == 2 and at[0] >= 2 and at[1] - at[0] >= 3
                and len(t) - at[1] >= 3):
            break
    else:
        raise AssertionError("no seed gives two separated updates")
    v, f = g.num_vertices, g.feature_dim
    deltas = []

    def delta_fn(i, rng):
        if not deltas:
            ids = np.sort(rng.choice(v, UPDATE_UPSERTS, replace=False))
            d = GraphDelta(feature_ids=ids, feature_values=g.features[ids]
                           + rng.normal(scale=0.1, size=(len(ids), f)))
        else:
            d = GraphDelta(add_edges=rng.integers(0, v, (UPDATE_EDGES, 2)),
                           remove_vertices=rng.choice(v, UPDATE_REMOVED,
                                                      replace=False))
        deltas.append(d)
        return d
    t = traces.mixed(MIXED_REQUESTS, rate, delta_fn=delta_fn, seed=seed,
                     update_fraction=MIXED_UPDATE_FRACTION)
    return [t[:at[0] + 1], t[at[0] + 1:at[1] + 1], t[at[1] + 1:]], deltas


def check_update(case: dict, outs, counts, bsp) -> dict:
    """Gates of one server-update path (three replays: before, between and
    after the two updates): exact launches per replay, and every response
    bitwise a fresh compile of the graph it saw (``sim``) or a layout built
    from scratch at the session's assignment (``mesh-bsp``)."""
    plan, what = case["plan"], case["what"]
    mesh = plan.config.executor == "mesh-bsp"
    yardstick = "scratch layout" if mesh else "fresh compile"
    reports = []
    for j, ((responses, after, wall_s), cnt) in enumerate(zip(outs, counts)):
        check_launches(f"{what} replay {j}", cnt,
                       expected_launches(responses, plan, mesh))
        # The plan each replay's queries saw: the original for the first,
        # else the plan the previous replay's update produced.
        seen = plan if j == 0 else outs[j - 1][1]
        if mesh:
            ref = dataclasses.replace(seen, partitioned=bsp.build_partitioned(
                seen.graph, seen.placement.assignment, n=seen.num_fogs,
                build_blocks=True))
        else:
            ref = case["Engine"].from_plan(plan).compile(seen.graph)
        want = ref.session().query().embeddings
        for r in responses:
            if hasattr(r, "embeddings") and not np.array_equal(r.embeddings,
                                                               want):
                raise AssertionError(f"{what} replay {j}: response "
                                     f"{r.request_id} is not bitwise the "
                                     f"{yardstick}")
            if hasattr(r, "report"):
                rep = r.report
                reports.append({"mode": rep.mode,
                                "dirty_local": list(rep.dirty_local),
                                "dirty_halo": list(rep.dirty_halo),
                                **{k: getattr(rep, k) for k in (
                                    "added_vertices", "removed_vertices",
                                    "added_edges", "feature_upserts",
                                    "imbalance", "cut_fraction_after")}})
        del ref
    rec = {"kind": plan.model.kind, "executor": plan.config.executor,
           "updates": reports, "launches": counts,
           "replay_s": [o[2] for o in outs]}
    log(f"  {what}: three replays bitwise the {yardstick}s; updates "
        + "; ".join(f"{u['mode']} dirty local {u['dirty_local']} halo "
                    f"{u['dirty_halo']}" for u in reports)
        + f"; launches {counts}")
    return rec


def update_costs(case: dict, deltas, ops) -> list:
    """Host ms of ``apply_delta`` for each update, from the plan the server
    applied it to, and of the first two executes after it: the first
    rebuilds the device state a new layout or graph needs (on ``sim`` the
    mutated graph's block-CSR operand, dropped first so that it is built
    again; on the mesh the new layout's uploads and compaction)."""
    before, out = case["plan"], []
    for d in deltas:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        after = case["Engine"].from_plan(before).apply_delta(before, d)
        apply_ms = (time.perf_counter() - t0) * 1e3
        if d.is_structural and after.config.executor != "mesh-bsp":
            ops.invalidate_block_csr(after.graph)
        sess = after.session()
        feats = sess.collect()
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.execute(feats)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out.append({"mode": after.update_report.mode, "apply_ms": apply_ms,
                    "first_execute_ms": times[0],
                    "second_execute_ms": times[1]})
        log(f"  {case['what']} {after.update_report.mode}: apply_delta "
            f"{apply_ms:.1f} ms, first execute after it {times[0]:.1f} ms "
            f"(then {times[1]:.1f} ms)")
        before = after
    return out


def server_paths(Engine, models, g, api, bsp, ops, drive_each) -> dict:
    """Phase 3f: ``plan.server(...).replay(trace)`` at full SIoT on the
    card, each path driven with the counts set to 0 just before each replay
    and read just after; every yardstick runs after the counts are read."""
    plans = {}
    for kind in SERVER_KINDS:
        for ex in ("sim", "mesh-bsp"):
            plans[kind, ex] = server_plan(Engine, models, g, kind, ex)
    out = {}
    for path, ex in (("server", "sim"), ("server-mesh", "mesh-bsp")):
        cases = []
        for kind in SERVER_KINDS:
            plan, compile_s = plans[kind, ex]
            rate = server_rate(plan)
            cases.append({"what": f"{kind} {path}", "plan": plan,
                          "compile_s": compile_s, "rate": rate,
                          "srv": plan.server(max_batch=SERVER_MAX_BATCH),
                          "trace": api.traces.poisson(SERVER_REQUESTS, rate,
                                                      seed=0)})
        outs, counts = drive_each(path, [replay_thunk(c["srv"], c["trace"])
                                         for c in cases])
        out[path] = [check_server(c, o, n, ex == "mesh-bsp")
                     for c, o, n in zip(cases, outs, counts)]
    cases = [slo_case(plans[kind, "sim"][0], kind, api.traces, api.slo)
             for kind in SERVER_KINDS]
    outs, counts = drive_each("server-slo", [
        replay_thunk(c["srv"], c["trace"]) for c in cases])
    out["server-slo"] = [check_slo(c, o, n)
                         for c, o, n in zip(cases, outs, counts)]
    cases, runs = [], []
    for ex in ("sim", "mesh-bsp"):
        plan = plans["gcn", ex][0]
        pieces, deltas = mixed_trace(api.traces, api.GraphDelta,
                                     api.UpdateRequest, g, server_rate(plan))
        srv = plan.server(max_batch=SERVER_MAX_BATCH)
        cases.append({"what": f"gcn server-update {ex}", "plan": plan,
                      "Engine": Engine, "deltas": deltas,
                      "pieces": [len(p) for p in pieces]})
        runs += [replay_thunk(srv, p) for p in pieces]
    outs, counts = drive_each("server-update", runs)
    out["server-update"] = []
    for j, case in enumerate(cases):
        rec = check_update(case, outs[3 * j:3 * j + 3],
                           counts[3 * j:3 * j + 3], bsp)
        rec["costs"] = update_costs(case, case["deltas"], ops)
        out["server-update"].append(rec)
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


def small_serve_reference(sv, tf, registry, arch: str = ARCH) -> dict:
    """A reduced ``arch`` served through the kernels on the card and
    through the plain versions on the CPU, same weights: prefill logits of
    one batch within rtol 1e-4 / atol 1e-4; greedy tokens reported."""
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
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
    log(f"  reduced {arch} serve: card vs CPU prefill logits within rtol "
        f"{LOGIT_RTOL} / atol {LOGIT_ATOL}; greedy tokens agree {agree} / "
        f"{total}")
    return {"arch": cfg.name, "greedy_tokens_agree": agree,
            "greedy_tokens": total}


# ---------------------------------------------------------------------------
# Phase 3j, the non-dense decoders at full width
# ---------------------------------------------------------------------------

def path_launches(cfg, batches: int, steps: int) -> dict:
    """Launches of each kernel that ``cfg``'s layer specs imply for
    ``batches`` served batches of one prefill and ``steps`` decode steps:
    a prefill runs each recurrent layer's scan twice (the forward's and
    the state's, which the reference recomputes from the uncast
    projection) and, with ``attn_impl="flash"``, one flash kernel a GQA or
    local-attention layer; a decode step one scan a recurrent layer."""
    mixers = [spec.mixer for spec in cfg.layer_specs()]
    attn = sum(m in ("gqa", "local_attn") for m in mixers) \
        if cfg.attn_impl == "flash" else 0
    out = {}
    for name, kind in (("selective_scan", "mamba"), ("rglru_scan", "rglru")):
        n = mixers.count(kind)
        out[name] = batches * (2 * n + steps * n)
    out["flash_attention"] = batches * attn
    return out


def check_path_launches(path: str, got: dict, want: dict) -> None:
    """The path's counts of the three model kernels must be exactly
    ``want``, and every other kernel's 0."""
    for name, n in got.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {n} {name} launches, expected "
                                 f"{want.get(name, 0)} ({want})")


def served_prompts(sv, cfg, n: int) -> torch.Tensor:
    """The first ``n`` served requests' prompts, left-padded with token 0
    as ``serve`` pads a batch."""
    reqs = sv.make_requests(cfg, SERVE["requests"], SERVE["tokens"])[:n]
    plen = max(len(r.prompt) for r in reqs)
    toks = np.zeros((n, plen), np.int64)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt
    return torch.as_tensor(toks, device="cuda")


def decode_vs_forward(sv, tf, cfg, params) -> dict:
    """One served batch in f32 activations, at the reference's
    decode-vs-forward bar: the prefill's last logits against a forward of
    the same S tokens, and the first decode step after the prefill against
    a forward of the S + 1 tokens (row S). A MoE model's prefill drops at
    capacity 1.25 (as the reference's), which reaches the caches of every
    layer after a MoE layer, while its decode is dropless: so, as the
    reference's own check does (tests/test_arch_smoke.py:52-69), its S + 1
    tokens are decoded from empty caches and every step is held to a
    forward at capacity E / k.

    Only the decode half is an independent check: decode attends through
    the plain ``_sdpa`` (MLA: the weight-absorbed form) and runs the scans
    at S = 1 from the prefill's state, against the forward's flash or
    chunked attention and full-sequence scans. The prefill half runs the
    forward's own mixer code and kernels, so it holds the port to itself
    (it catches a prefill that computes its logits off the forward's
    path, not a kernel fault)."""
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    toks = served_prompts(sv, cfg, SERVE["batch_size"])
    b, s = toks.shape
    with torch.inference_mode():
        lp, caches = tf.prefill(params, cfg32, toks, cache_len=s + 1)
        want_p = tf.forward(params, cfg32, toks)[0][:, -1:]
        nxt = torch.argmax(lp[:, -1:], dim=-1)
        full = torch.cat([toks, nxt], dim=1)
        if cfg.num_experts:
            del caches
            caches = tf.init_cache(cfg32, b, s + 1, device="cuda")
            steps = []
            for t in range(s + 1):
                logits, caches = tf.decode_step(params, cfg32, caches,
                                                full[:, t:t + 1], t)
                steps.append(logits)
            ld = torch.cat(steps, dim=1)
            want_d = tf.forward(params, cfg32, full, capacity_factor=(
                cfg.num_experts / cfg.experts_per_token))[0]
        else:
            ld, _ = tf.decode_step(params, cfg32, caches, nxt, s)
            want_d = tf.forward(params, cfg32, full)[0][:, s:s + 1]
        del caches
    rec = {"S": s, "B": b, "decode_from_empty_caches": bool(cfg.num_experts),
           "prefill": errors(lp, want_p, 0.0, DECODE_VS_FORWARD_ATOL),
           "decode": errors(ld, want_d, 0.0, DECODE_VS_FORWARD_ATOL),
           "logit_max_abs": float(want_d.abs().max())}
    log(f"  f32 prefill (S = {s}) / decode vs forward: max |err| "
        f"{rec['prefill']['max_abs_err']:.3g} / "
        f"{rec['decode']['max_abs_err']:.3g} (bar "
        f"{DECODE_VS_FORWARD_ATOL}; |logit| up to "
        f"{rec['logit_max_abs']:.3g}"
        + ("; decoded from empty caches, dropless)" if cfg.num_experts
           else ")"))
    finite = bool(torch.isfinite(lp).all() and torch.isfinite(ld).all())
    if not finite or max(rec[w]["tol_ratio"] for w in ("prefill",
                                                       "decode")) > 1:
        raise AssertionError(f"{cfg.name} prefill / decode vs forward: "
                             f"{rec}")
    return rec


def rg_long_prefill(tf, cfg, params) -> dict:
    """recurrentgemma-9b's bf16 prefill at B = 1, S = RG_PREFILL_S (the
    served copy), twice: the second timed."""
    served = tf.cast_params(params, cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, RG_PREFILL_S), generator=gen,
                         device="cuda")
    times = []
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = tf.prefill(served, cfg, toks)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del caches
    if logits.shape != (1, 1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"bad long prefill logits {tuple(logits.shape)}")
    log(f"  prefill B=1 S={RG_PREFILL_S} (bf16): {times[1]:.1f} ms (first "
        f"{times[0]:.1f} ms)")
    return {"B": 1, "S": RG_PREFILL_S, "first_ms": times[0],
            "ms": times[1]}


def nondense_paths(sv, tf, registry, drive, launches) -> list:
    """Phase 3j: falcon-mamba-7b, recurrentgemma-9b (flash) and
    deepseek-v3-671b (4 of its 61 layers) at full width, each served
    through ``launch.serve.serve`` with SERVE's traffic as its own driven
    path, with exact launches, timings and the f32 decode-vs-forward
    check; recurrentgemma's long prefill driven apart. Each model is freed
    before the next."""
    out = []
    for arch, path, layers in NONDENSE:
        cfg = registry.get(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        if any(s.mixer in ("gqa", "local_attn") for s in cfg.layer_specs()):
            cfg = dataclasses.replace(cfg, attn_impl="flash")
        cut = (f", depth cut to {layers} of {registry.get(arch).num_layers} "
               f"layers" if layers else "")
        log(f"  {arch}: {cfg.param_count() / 1e9:.3f} B parameters "
            f"({cfg.param_dtype}){cut}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tf.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        res = drive(path, lambda: sv.serve(cfg, device="cuda", params=params,
                                           log=log, **SERVE))
        n_batches = len(res["batches"])
        want = path_launches(cfg, n_batches, SERVE["tokens"] - 1)
        check_path_launches(path, launches[path], want)
        for r in res["requests"]:
            if len(r.done) != SERVE["tokens"] or not all(
                    0 <= t < cfg.vocab_size for t in r.done):
                raise AssertionError(f"{arch} request {r.rid}: bad tokens "
                                     f"{r.done}")
        b = res["batches"]
        steady = b[1:] or b
        rec = {"arch": cfg.name, "path": path, "num_layers": cfg.num_layers,
               "depth_cut": layers, "parameters": cfg.param_count(),
               "init_s": init_s, "batches": n_batches,
               "tokens": res["tokens"], "wall_s": res["wall_s"],
               "tokens_per_s": res["tokens_per_s"],
               "first_prefill_ms": b[0]["prefill_ms"],
               "prefill_ms_median": statistics.median(
                   x["prefill_ms"] for x in steady),
               "decode_ms_per_step_median": statistics.median(
                   x["decode_ms"] / x["decode_steps"] for x in steady),
               "launches": {k: v for k, v in launches[path].items() if v},
               "launches_per_prefill": path_launches(cfg, 1, 0),
               "launches_per_decode_step": {
                   k: v - w for (k, v), w in zip(
                       path_launches(cfg, 1, 1).items(),
                       path_launches(cfg, 1, 0).values())},
               "batch_timings": b}
        log(f"  {arch} serve: {rec['tokens']} tokens in {rec['wall_s']:.2f} "
            f"s ({rec['tokens_per_s']:.1f} tok/s), prefill "
            f"{rec['prefill_ms_median']:.2f} ms / decode "
            f"{rec['decode_ms_per_step_median']:.2f} ms a step (median "
            f"after the first batch; first prefill "
            f"{rec['first_prefill_ms']:.1f} ms); launches {rec['launches']} "
            f"({rec['launches_per_prefill']} a prefill, "
            f"{rec['launches_per_decode_step']} a decode step)")
        rec["decode_vs_forward"] = decode_vs_forward(sv, tf, cfg, params)
        if arch == "recurrentgemma-9b":
            rec["long_prefill"] = drive("prefill-recurrentgemma",
                                        lambda: rg_long_prefill(tf, cfg,
                                                                params))
            check_path_launches("prefill-recurrentgemma",
                                launches["prefill-recurrentgemma"],
                                path_launches(cfg, 2, 0))
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["init_and_checks_s"] = time.perf_counter() - t0
        log(f"  {arch}: peak {rec['peak_gb']:.1f} GB allocated, "
            f"{rec['init_and_checks_s']:.1f} s")
        out.append(rec)
        del params, res
        torch.cuda.empty_cache()
    return out


def quant_decode(tf, registry) -> dict:
    """qwen1.5-0.5b at full width (bf16 served copy): QUANT_STEPS decode
    steps from an empty int8 cache (``init_cache(quantized=True)``) against
    the bf16 forward of the same tokens, at the reference's relative bar."""
    cfg = dataclasses.replace(registry.get(ARCH), attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(4)
    served = tf.cast_params(tf.init_params(cfg, gen), cfg)
    b = SERVE["batch_size"]
    toks = torch.randint(0, cfg.vocab_size, (b, QUANT_STEPS), generator=gen,
                         device="cuda")
    with torch.inference_mode():
        caches = tf.init_cache(cfg, b, QUANT_STEPS, quantized=True,
                               device="cuda")
        cache_bytes = sum(t.numel() * t.element_size() for c in caches
                          for t in dataclasses.astuple(c))
        outs = []
        for t in range(QUANT_STEPS):
            logits, caches = tf.decode_step(served, cfg, caches,
                                            toks[:, t:t + 1], t)
            outs.append(logits)
        dec = torch.cat(outs, dim=1).float()
        fwd = tf.forward(served, cfg, toks)[0].float()
    rel = float((dec - fwd).abs().max() / fwd.abs().max())
    bf16_bytes = 2 * 2 * b * QUANT_STEPS * cfg.num_kv_heads * cfg.head_dim \
        * cfg.num_layers
    log(f"  {ARCH} int8 KV cache: {QUANT_STEPS} decode steps vs the bf16 "
        f"forward, max |err| / max |logit| = {rel:.4g} (bar "
        f"{QUANT_REL_BAR}); cache {cache_bytes} bytes against {bf16_bytes} "
        f"in bf16")
    if not torch.isfinite(dec).all() or rel >= QUANT_REL_BAR:
        raise AssertionError(f"int8 KV cache decode: relative error {rel}")
    del served, caches
    torch.cuda.empty_cache()
    return {"steps": QUANT_STEPS, "B": b, "rel_err": rel,
            "cache_bytes": cache_bytes, "bf16_cache_bytes": bf16_bytes}


def to_device(tree, device):
    """A copy of a parameter dictionary on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# Phase 2, row-subset launches; phase 3g, frontier, stale and fleet paths
# ---------------------------------------------------------------------------

#: Sensors whose readings change between two queries of phase 3g's stream,
#: the queries made for each count, and the changed leaf sensors of each
#: member of its batch (and of phase 2's subset cases: their frontier).
FRONTIER_SENSORS = (16, 64, 256)
FRONTIER_QUERIES = 2
FRONTIER_BATCH_SENSORS = 8
SUBSET_SENSORS = 64
#: (path, executor, aggregation) of phase 3g's frontier paths; every plan
#: uses the DAQ codec (on the mesh's kernel path the DAQ halo wire).
FRONTIER_PATHS = (("frontier-sim", "sim", "pallas"),
                  ("frontier-mesh", "mesh-bsp", "pallas"),
                  ("frontier-sim-segment", "sim", "segment_sum"),
                  ("frontier-mesh-segment", "mesh-bsp", "segment_sum"))
FRONTIER_KINDS = ("gcn", "sage")
STALE_BOUND = 2
STALE_PATTERN = [0, 1, 2, 0, 1]
FLEET_SITES = {"north": (59.33, 18.07), "south": (48.21, 16.37)}
FLEET_REQUESTS = 24
FLEET_CAPACITY = 8


def leaf_sensors(g) -> np.ndarray:
    """The vertices with at most one in-edge: IoT end devices with at most
    one relation (7,328 of full SIoT's 16,216)."""
    return np.flatnonzero(np.bincount(g.receivers,
                                      minlength=g.num_vertices) <= 1)


def subset_blocks(g, pg, out_rows: int, frontier) -> tuple:
    """The row blocks a frontier layer launches over on each path: the
    layer-1 dirty rows of SUBSET_SENSORS seeded leaf sensors (layer 2's
    reach nearly every block), as ``sim`` blocks (rows // 128) and as the
    mesh's folded output blocks."""
    rng = np.random.default_rng(6)
    seeds = np.unique(rng.choice(leaf_sensors(g), SUBSET_SENSORS,
                                 replace=False))
    rows = frontier.expand_frontier(g, seeds, np.empty((0, 2), np.int64),
                                    1)[-1]
    return (len(rows), np.unique(rows // 128),
            np.unique((pg.part_of[rows] * out_rows + pg.slot_of[rows])
                      // 128))


def subset_nnz(rows, sub) -> int:
    """The entries of the rows ``sub`` lists: what its launch walks."""
    per_row = (rows.seg_ptr[rows.row_ptr[1:].long()]
               - rows.seg_ptr[rows.row_ptr[:-1].long()])
    return int(per_row[sub.row_mask()].sum())


def subset_cases(ga, dq, ref, bsp, csr, local, halo, halo_real_rows: int,
                 blocks_sim, blocks_mesh) -> dict:
    """Phase 2, kernels 1-4 over a row subset (``ga.row_subset``: the rows
    of a frontier's 128-row blocks) at the main paths' full-scale shapes,
    F = 64: the listed rows bitwise the full launch's, every other row 0,
    one ``subset_launches`` a launch; held to the rows plain version in
    float64 (sliced by ``ref.keep_row_blocks``); subset and full launch
    timed. Returns {kernel: [records]}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.default_rng(5)
    f = 64
    operands = {
        "siot": ((csr.blocks, csr.cols, csr.mask), csr.rows, csr.max_col,
                 csr.padded_v, blocks_sim),
        "mesh_local": ((local.blocks, local.cols, local.mask), local.rows,
                       local.max_col, local.src_rows, blocks_mesh),
        "mesh_halo": ((halo.blocks, halo.cols, halo.mask), halo.rows,
                      halo.max_col, halo.src_rows, blocks_mesh)}
    cases = [("block_spmm", "siot", 1), ("block_spmm_batched", "siot", BATCH),
             ("block_spmm", "mesh_local", 1),
             ("block_spmm_batched", "mesh_local", BATCH),
             ("dequant_spmm", "mesh_halo", 1),
             ("dequant_spmm_batched", "mesh_halo", BATCH)]
    out = {name: [] for name in SUBSET_KERNELS}
    for name, where, batch in cases:
        ops_, rows, max_col, src_rows, sel = operands[where]
        sub = ga.row_subset(rows, sel)
        keep = sub.row_mask()
        if name.startswith("dequant"):
            kern = getattr(dq, name)
            tables = wire_codes(bsp, gen, rng, batch, src_rows,
                                halo_real_rows, f, torch.uint8)
            if batch == 1:
                tables = tuple(t[0] for t in tables)
            rows_plain = (ref.dequant_spmm_rows_ref if batch == 1
                          else ref.dequant_spmm_rows_batched_ref)
            want = rows_plain(rows, *tables, dtype=torch.float64)
            code_bytes, row_bytes = 1, 8
        else:
            kern = getattr(ga, name)
            shape = (src_rows, f) if batch == 1 else (batch, src_rows, f)
            tables = (torch.randn(shape, generator=gen, device="cuda"),)
            rows_plain = (ref.block_spmm_rows_ref if batch == 1
                          else ref.block_spmm_rows_batched_ref)
            want = rows_plain(rows, tables[0].double())
            code_bytes, row_bytes = 4, 0
        want = ref.keep_row_blocks(want, sub.blocks)

        def full_call():
            return kern(*ops_, *tables, rows=rows, max_col=max_col)

        def sub_call():
            return kern(*ops_, *tables, rows=sub, max_col=max_col)
        before = kern.subset_launches
        got = sub_call()
        if kern.subset_launches != before + 1:
            raise AssertionError(f"{name} {where}: a subset launch counted "
                                 f"{kern.subset_launches - before}")
        full = full_call()
        what = f"{name} {where} subset of {len(sel)} blocks"
        if not torch.equal(got[..., keep, :], full[..., keep, :]):
            raise AssertionError(f"{what}: listed rows are not bitwise the "
                                 f"full launch's")
        if got[..., ~keep, :].any():
            raise AssertionError(f"{what}: an unlisted row is not 0")
        err = errors(got, want)
        check_close(what, got.double(), want, KERNEL_RTOL, KERNEL_ATOL)
        nnz = subset_nnz(rows, sub)
        b_ms, b_by = bound(nnz, len(sel), rows.tiles[1], src_rows, f, batch,
                           code_bytes, row_bytes)
        rec = {"case": where, "F": f, "B": batch, "blocks": len(sel),
               "of_blocks": rows.tiles[0], "rows_listed": int(keep.sum()),
               "entries": nnz, "of_entries": rows.nnz,
               "bitwise_full_rows": True, **err,
               "ms": time_ms(sub_call, reps=30),
               "full_ms": time_ms(full_call, reps=30),
               "bound_ms": b_ms, "bound_by": b_by,
               "host_us": host_us(sub_call)}
        out[name].append(rec)
        log(f"  {name:19s} {where:10s} subset {len(sel)}/{rows.tiles[0]} "
            f"blocks ({nnz}/{rows.nnz} entries) B={batch}: bitwise the full "
            f"rows, err {err['max_abs_err']:.3g}; {rec['ms']:.4f} ms (full "
            f"{rec['full_ms']:.4f}) bound {b_ms:.4f} ms ({b_by})")
        del tables, got, full, want
    return out


def gnn_plan(Engine, models, g, kind: str, **knobs):
    """A plan of ``kind`` with the phases' seeded [52, 64, 2] weights, the
    default cluster and the DAQ codec, and its compile seconds."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.gnn_init(gen, kind, [g.feature_dim, DIMS_HIDDEN,
                                         DIMS_OUT])
    t0 = time.perf_counter()
    plan = Engine((params, kind), compressor="daq", device="cuda",
                  **knobs).compile(g)
    return plan, time.perf_counter() - t0


def frontier_stream(g, collect) -> tuple:
    """Phase 3g's collected feature sets: the stored features, then a
    stream in which each query changes the readings of n sensors of the
    previous one (a seeded normal step of 0.5), FRONTIER_QUERIES queries
    for each n in FRONTIER_SENSORS, the sensors first drawn from the leaf
    sensors and then from all; then a batch of BATCH sets, each changing
    FRONTIER_BATCH_SENSORS leaf sensors of the one before. Returns (base,
    [(pool, n, feats)], batch stack)."""
    rng = np.random.default_rng(11)
    pools = {"leaf": leaf_sensors(g), "any": np.arange(g.num_vertices)}
    raw = np.asarray(g.features, np.float32)

    def step(pool, n):
        nonlocal raw
        raw = raw.copy()
        pick = rng.choice(pools[pool], n, replace=False)
        raw[pick] += rng.normal(scale=0.5, size=(n, g.feature_dim)).astype(
            np.float32)
        return collect(raw)
    base = collect(raw)
    stream = [(pool, n, step(pool, n)) for pool in pools
              for n in FRONTIER_SENSORS for _ in range(FRONTIER_QUERIES)]
    batch = np.stack([step("leaf", FRONTIER_BATCH_SENSORS)
                      for _ in range(BATCH)])
    return base, stream, batch


def subset_wrappers(ga, dq) -> dict:
    return {"block_spmm": ga.block_spmm,
            "block_spmm_batched": ga.block_spmm_batched,
            "dequant_spmm": dq.dequant_spmm,
            "dequant_spmm_batched": dq.dequant_spmm_batched}


def cached_run(sess, feats, wrappers):
    """One execute (``execute_many`` for a stack) of the cached session,
    its subset launches counted from 0; beforehand, on the host, the
    cache's own plan of the query (None: over the budget), timed: the
    host part of the execute's decision (the session repeats it)."""
    def run():
        for w in wrappers.values():
            w.subset_launches = 0
        plan, cache = sess.plan, sess._acache
        t0 = time.perf_counter()
        predicted = (cache.plan_query(feats, plan.graph,
                                      plan.model.num_layers)
                     if cache.primed else None)
        plan_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out = (sess.execute_many(feats) if feats.ndim == 3
               else sess.execute(feats))
        ms = (time.perf_counter() - t0) * 1e3
        return {"out": out, "ms": ms, "plan_ms": plan_ms,
                "frontier": sess.last_frontier, "predicted": predicted,
                "subset": {n: w.subset_launches for n, w in wrappers.items()}}
    return run


def frontier_launches(mesh: bool, segment: bool, kind: str, k: int,
                      batch: int, decision: str) -> tuple:
    """(launches, subset launches) one cached execute implies: nothing for
    an empty frontier; on the segment path K segment sums an example
    (masked edge list or full pass alike); on the kernel path K launches a
    layer operand (the batched kernels for a stack), over row subsets when
    the frontier path ran."""
    want = dict.fromkeys(REPLACES, 0)
    sub = dict.fromkeys(SUBSET_KERNELS, 0)
    if decision == "empty":
        return want, sub
    if segment:
        want.update(segment_launches(kind, k * batch))
        return want, sub
    suffix = "" if batch == 1 else "_batched"
    for name in ["block_spmm"] + ["dequant_spmm"] * mesh:
        want[name + suffix] = k
        if decision == "frontier":
            sub[name + suffix] = k
    return want, sub


def check_frontier(case: dict, outs, counts) -> dict:
    """Gates of one frontier session's runs: the frontier path taken
    exactly when the cache's own host plan admits a non-empty frontier and
    the kind supports it (the reference's rule), its dirty rows that plan's,
    exact launches and subset launches, and every result bitwise a
    cache-less session's execute of the same features (serial executes for
    the batch). Returns the record with per-run dirty rows, row blocks
    launched and host ms against the full execute."""
    plan, what, path = case["plan"], case["what"], case["path"]
    kind, k = plan.model.kind, plan.model.num_layers
    mesh, segment = "mesh" in path, path.endswith("segment")
    supported = kind in FRONTIER_KINDS
    full = plan.session()
    pg = plan.partitioned
    runs = []
    for (label, feats), o, n in zip(case["runs"], outs, counts):
        batch = feats.shape[0] if feats.ndim == 3 else 1
        qf, pred = o["frontier"], o["predicted"]
        if pred is not None and not len(pred.rows):
            decision = "empty"
        else:
            decision = "frontier" if qf is not None else "full"
        admitted = pred is not None and len(pred.rows) > 0
        if (decision == "frontier") != (admitted and supported):
            raise AssertionError(f"{what} {label}: took the {decision} path"
                                 f", the cache's plan "
                                 f"{'admits' if admitted else 'refuses'} a "
                                 f"frontier")
        want, want_sub = frontier_launches(mesh, segment, kind, k, batch,
                                           decision)
        check_launches(f"{what} {label}", n, want)
        check_launches(f"{what} {label} subsets", o["subset"], want_sub)
        t0 = time.perf_counter()
        full_out = (full.execute_many(feats) if batch > 1
                    else full.execute(feats))
        full_ms = (time.perf_counter() - t0) * 1e3
        serial = ([full.execute(x) for x in feats] if batch > 1
                  else [full_out])
        got = o["out"] if batch > 1 else [o["out"]]
        for b, (x, y) in enumerate(zip(got, serial)):
            if not np.array_equal(x, y):
                raise AssertionError(f"{what} {label}: example {b} is not "
                                     f"bitwise a full execute")
        rec = {"run": label, "batch": batch, "decision": decision,
               "ms": o["ms"], "plan_ms": o["plan_ms"], "full_ms": full_ms,
               "launches": n,
               "launches_subset": o["subset"]}
        if pred is not None:
            rec["fraction"] = pred.fraction
            rec["seeds"] = len(pred.seeds)
        if qf is not None:
            if any(not np.array_equal(a, b) for a, b in zip(qf.rows,
                                                            pred.rows)):
                raise AssertionError(f"{what} {label}: dirty rows differ "
                                     f"from the cache's plan")
            rec["dirty_rows"] = [len(r) for r in qf.rows]
            if not segment:
                if mesh:
                    out_rows = pg.local_csr.out_rows
                    rec["blocks"] = [len(np.unique(
                        (pg.part_of[r] * out_rows + pg.slot_of[r]) // 128))
                        for r in qf.rows]
                else:
                    rec["blocks"] = [len(np.unique(r // 128))
                                     for r in qf.rows]
        runs.append(rec)
    taken = [r for r in runs if r["decision"] == "frontier"]
    if supported and not any(r["batch"] == 1 for r in taken):
        raise AssertionError(f"{what}: no query took the frontier path")
    log(f"  {what}: {len(runs)} executes bitwise full executes, launches "
        f"exact; frontier path " + ", ".join(
            f"{r['run']}:{r['decision']}"
            + (f"{r['dirty_rows']}" if "dirty_rows" in r else "")
            + f" {r['ms']:.1f}/{r['full_ms']:.1f}ms" for r in runs))
    return {"kind": kind, "executor": plan.config.executor,
            "aggregation": plan.config.aggregation,
            "compile_s": case["compile_s"], "runs": runs}


def frontier_paths(Engine, models, g, drive_each, ga, dq) -> tuple:
    """Phase 3g, frontier queries: a session with ``activation_cache=True``
    on each path of FRONTIER_PATHS, GCN and SAGE (and GAT on the ``sim``
    segment path, which must fall back), fed phase 3g's stream; each path
    driven with the counts set to 0 just before each execute and read just
    after, every yardstick after. Returns the records and the stream."""
    wrappers = subset_wrappers(ga, dq)
    out = {}
    stream = None
    for path, executor, aggregation in FRONTIER_PATHS:
        cases, runs = [], []
        kinds = FRONTIER_KINDS + (("gat",) if path == "frontier-sim-segment"
                                  else ())
        for kind in kinds:
            plan, compile_s = gnn_plan(Engine, models, g, kind,
                                       executor=executor,
                                       aggregation=aggregation)
            if stream is None:
                stream = frontier_stream(g, plan.session().collect)
            base, queries, batch = stream
            sess = plan.session(activation_cache=True)
            plan_runs = [("prime", base)] + [
                (f"{pool}{n}.{i % FRONTIER_QUERIES}", x)
                for i, (pool, n, x) in enumerate(queries)]
            if kind == "gat":
                plan_runs = plan_runs[:3]
            else:
                plan_runs.append((f"batch{BATCH}", batch))
            cases.append({"what": f"{kind} {path}", "path": path,
                          "plan": plan, "compile_s": compile_s,
                          "runs": plan_runs})
            runs += [cached_run(sess, x, wrappers) for _, x in plan_runs]
        outs, counts = drive_each(path, runs)
        out[path], at = [], 0
        for case in cases:
            m = len(case["runs"])
            out[path].append(check_frontier(case, outs[at:at + m],
                                            counts[at:at + m]))
            at += m
        del cases, runs, outs
    return out, stream


def stale_path(Engine, models, g, bsp, api, drive_each, stream) -> dict:
    """Phase 3g, stale halos on ``mesh-bsp`` (GCN): ``halo_async`` with
    ``staleness_bound=0`` bitwise ``halo`` on both aggregation paths; with
    STALE_BOUND the staleness pattern STALE_PATTERN, each stale serve
    bitwise ``bsp_infer_stale`` over ``build_halo_tables`` of the recorded
    fresh serve's captured layer inputs (recaptured on the ``halo`` plan)
    and unlike a fresh serve; a graph update forces a fresh serve, bitwise
    a fresh serve of the updated plan. Every execute driven with the
    counts set to 0 just before it: a fresh serve (capturing, DAQ wire)
    launches K ``block_spmm`` + K ``dequant_spmm``, a stale one 2K
    ``block_spmm`` (local and the replayed f32 halo table)."""
    feats = [stream[0]] + [x for _, _, x in stream[1][:5]]
    plans, runs, labels = {}, [], []
    for agg in ("pallas", "segment_sum"):
        for exchange, bound_ in (("halo", 0), ("halo_async", 0)):
            plans[agg, exchange, bound_] = gnn_plan(
                Engine, models, g, "gcn", executor="mesh-bsp",
                aggregation=agg, exchange=exchange,
                staleness_bound=bound_)[0]
    plans["pallas", "halo_async", STALE_BOUND] = gnn_plan(
        Engine, models, g, "gcn", executor="mesh-bsp", aggregation="pallas",
        exchange="halo_async", staleness_bound=STALE_BOUND)[0]
    sessions = {key: p.session() for key, p in plans.items()}

    def timed(fn):
        def run():
            t0 = time.perf_counter()
            o = fn()
            return o, (time.perf_counter() - t0) * 1e3
        return run
    for agg in ("pallas", "segment_sum"):
        for exchange in ("halo", "halo_async"):
            for i in range(2):
                s = sessions[agg, exchange, 0]
                runs.append(timed(lambda s=s, x=feats[i]: s.execute(x)))
                labels.append(("bound0", agg, exchange, i))
    stale = sessions["pallas", "halo_async", STALE_BOUND]
    recorded = []
    for i in range(5):
        def serve(x=feats[i]):
            recorded.append(stale._halo.tables)
            return stale.execute(x), stale.last_staleness
        runs.append(timed(serve))
        labels.append(("bound2", "pallas", "halo_async", i))
    v, f = g.num_vertices, g.feature_dim
    rng = np.random.default_rng(13)
    ids = np.sort(rng.choice(v, 64, replace=False))
    delta = api.GraphDelta(feature_ids=ids, feature_values=g.features[ids]
                           + rng.normal(scale=0.1, size=(64, f)))

    def update_then_serve():
        stale.update(delta)
        x = stale.collect()
        t0 = time.perf_counter()
        emb = stale.execute(x)
        return emb, stale.last_staleness, x, (time.perf_counter() - t0) * 1e3
    runs.append(timed(update_then_serve))
    labels.append(("update", "pallas", "halo_async", 5))
    outs, counts = drive_each("stale", runs)
    k = plans["pallas", "halo", 0].model.num_layers
    # bound 0 == halo, bitwise, each aggregation path
    for agg in ("pallas", "segment_sum"):
        got = {lab[2:]: o[0] for lab, o in zip(labels, outs)
               if lab[0] == "bound0" and lab[1] == agg}
        for i in range(2):
            if not np.array_equal(got["halo", i], got["halo_async", i]):
                raise AssertionError(f"stale {agg}: halo_async bound 0 is "
                                     f"not bitwise halo")
        if sessions[agg, "halo_async", 0].last_staleness != 0:
            raise AssertionError("bound 0 served stale")
    for lab, n in zip(labels, counts):
        if lab[0] != "bound0":
            continue
        want = dict.fromkeys(REPLACES, 0)
        if lab[1] == "pallas":
            want["block_spmm"] = want["dequant_spmm"] = k
        else:
            want["segment_sum"] = k * SEGMENT_SUMS["gcn"]
        check_launches(f"stale {lab}", n, want)
    # the bound-2 session: pattern, replay, launches
    sync = sessions["pallas", "halo", 0]
    backend = sync.resolve_executor()
    pg = stale.partitioned()
    params = list(plans["pallas", "halo", 0].model.params)
    serves = [(lab, o, n) for lab, o, n in zip(labels, outs, counts)
              if lab[0] == "bound2"]
    pattern = [o[0][1] for _, o, _ in serves]
    if pattern != STALE_PATTERN:
        raise AssertionError(f"stale: staleness pattern {pattern}, "
                             f"expected {STALE_PATTERN}")
    fresh_ms, stale_ms = [], []
    for (lab, (res, ms), n), tables in zip(serves, recorded):
        i = lab[3]
        emb, age = res
        want = dict.fromkeys(REPLACES, 0)
        if age == 0:
            want["block_spmm"] = want["dequant_spmm"] = k
            fresh_ms.append(ms)
            if not np.array_equal(emb, sync.execute(feats[i])):
                raise AssertionError(f"stale serve {i}: a fresh serve is "
                                     f"not bitwise halo")
        else:
            want["block_spmm"] = 2 * k
            stale_ms.append(ms)
            j = i - age    # the fresh serve whose tables this one replays
            plan = sync.plan
            layers = backend.run_layers(plan, feats[j],
                                        plan.placement.assignment,
                                        sync.partitioned(), "halo",
                                        aggregation="pallas")
            built = bsp.build_halo_tables(pg, [feats[j]] + layers[:-1])
            if not all(np.array_equal(a, b) for a, b in zip(built, tables)):
                raise AssertionError(f"stale serve {i}: the recorded tables "
                                     f"are not those of serve {j}")
            replay = bsp.bsp_infer_stale(params, "gcn", feats[i], pg, built,
                                         device="cuda",
                                         aggregation="pallas")
            if not np.array_equal(emb, replay):
                raise AssertionError(f"stale serve {i}: not bitwise the "
                                     f"replay of serve {j}'s tables")
            if np.array_equal(emb, sync.execute(feats[i])):
                raise AssertionError(f"stale serve {i}: equal to a fresh "
                                     f"serve")
        check_launches(f"stale serve {i}", n, want)
    (emb, age, x, upd_ms), _ = outs[-1]
    if age != 0:
        raise AssertionError(f"stale: the serve after an update was "
                             f"{age} serves stale")
    want = dict.fromkeys(REPLACES, 0)
    want["block_spmm"] = want["dequant_spmm"] = k
    check_launches("stale: serve after the update", counts[-1], want)
    sync.update(delta)
    if not np.array_equal(emb, sync.execute(x)):
        raise AssertionError("stale: the serve after the update is not "
                             "bitwise a fresh serve of the updated plan")
    rec = {"pattern": pattern, "fresh_ms": fresh_ms, "stale_ms": stale_ms,
           "serve_after_update_ms": upd_ms,
           "exchange_bytes": {"fresh": stale.exchange_bytes(staleness=0),
                              "stale": stale.exchange_bytes(staleness=1)},
           "simulated_latency_s": {
               "fresh": stale.account(staleness=0).total_latency,
               "stale": stale.account(staleness=1).total_latency}}
    log(f"  stale: bound 0 == halo (pallas, segment_sum), pattern "
        f"{pattern}, stale serves bitwise the replay; host ms fresh "
        f"{[round(t, 2) for t in fresh_ms]} stale "
        f"{[round(t, 2) for t in stale_ms]}, after an update (fresh) "
        f"{upd_ms:.1f}")
    return rec


def fleet_path(Engine, models, g, api, drive_each) -> tuple:
    """Phase 3g, the fleet: ``compile_fleet`` with two sites plus the cloud
    (GCN, ``sim``, the kernel path, ``halo_async`` with STALE_BOUND), a
    ``FleetServer`` replay of a geo-tagged Poisson trace with per-request
    feature noise, drained a third of the way through, the nearest site of
    most requests set down halfway with requests pending there; zero
    drops, exact launches per site's batches, every response bitwise a
    session of its serving tier on its features. Returns the record and
    the fleet."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.gnn_init(gen, "gcn", [g.feature_dim, DIMS_HIDDEN,
                                          DIMS_OUT])
    fleet = Engine((params, "gcn"), executor="sim", aggregation="pallas",
                   compressor="daq", exchange="halo_async",
                   staleness_bound=STALE_BOUND,
                   device="cuda").compile_fleet(g, FLEET_SITES)
    compile_s = time.perf_counter() - t0
    fs = fleet.server(capacity=FLEET_CAPACITY, max_batch=SERVER_MAX_BATCH)
    rate = server_rate(fleet.sites[0].plan) * len(FLEET_SITES)

    def features_fn(i, rng):
        return g.features + rng.normal(scale=0.01, size=g.features.shape)
    trace = api.traces.poisson(
        FLEET_REQUESTS, rate, seed=0, features_fn=features_fn,
        origin_fn=api.traces.geo_origins(fleet.centroids(), seed=1))
    down = fleet.site_names[0]

    submitted = []

    def run():
        t1 = time.perf_counter()
        out, moved = [], 0
        for i, r in enumerate(trace):
            if i == FLEET_REQUESTS // 3:
                out += fs.drain()
            if i == FLEET_REQUESTS // 2:
                moved = fs.set_down(down)
            submitted.append(fs.submit(r))
        return out + fs.drain(), moved, time.perf_counter() - t1
    outs, counts = drive_each("fleet", [run])
    out, moved, wall_s = outs[0]
    summary = fs.summarize(out)
    responses = [r for r in out if isinstance(r, api.Response)]
    if len(responses) != FLEET_REQUESTS or summary["dropped"]:
        raise AssertionError(f"fleet: {len(responses)} responses of "
                             f"{FLEET_REQUESTS}, {summary['dropped']} "
                             f"dropped")
    k = fleet.cloud_plan.model.num_layers
    want = dict.fromkeys(REPLACES, 0)
    for site in fs.tier_names:
        mine = [r for r in responses if r.site == site]
        for b, _ in batches_of(mine).values():
            want["block_spmm" + ("" if b == 1 else "_batched")] += k
    check_launches("fleet", counts[0], want)
    plans = {s.name: s.plan for s in fleet.sites}
    plans["cloud"] = fleet.cloud_plan
    feats_of = {r.request_id: r.features for r in submitted}
    sessions = {}
    for r in responses:
        sess = sessions.setdefault(r.site, plans[r.site].session())
        if not np.array_equal(r.embeddings, sess.execute(
                sess.collect(feats_of[r.request_id]))):
            raise AssertionError(f"fleet: response {r.request_id} "
                                 f"({r.site}, {r.route}) is not bitwise "
                                 f"its tier's session")
    rec = {"sites": list(fleet.site_names), "down": down, "moved": moved,
           "compile_s": compile_s, "replay_s": wall_s, "rate_rps": rate,
           "phase_s": time.perf_counter() - t0, "launches": counts[0],
           "summary": summary}
    log(f"  fleet: {FLEET_REQUESTS} requests at {rate:.2f}/s over "
        f"{list(fs.tier_names)}, {down} down after "
        f"{FLEET_REQUESTS // 2} ({moved} pending moved); routes "
        f"{summary['routes']}, served "
        f"{ {s: v['served'] for s, v in summary['sites'].items()} }, "
        f"dropped {summary['dropped']}, staleness "
        f"{summary['staleness_histogram']}; every response bitwise its "
        f"tier's session; replay {wall_s:.2f} s, the fleet's part "
        f"{rec['phase_s']:.1f} s; launches exact")
    return rec, fleet


# ---------------------------------------------------------------------------
# Phase 3h, node-level fault tolerance and the static verifier
# ---------------------------------------------------------------------------

#: The fog phase 3h crashes (fog2(B) of "1A+4B+1C") and the one it slows.
CRASH_NODE = "fog2(B)"
SLOW_NODE = "fog1(B)"
#: Requests of each phase 3h replay, and tests/test_faults.py:370's chaos
#: property: the schedule's rates, outage and seed (over the trace's span).
FAULT_REQUESTS = 32
CHAOS = dict(crash_rate=1.5, loss_rate=2.0, straggler_rate=1.0,
             mean_outage=0.3, seed=11)
FAULT_KINDS = ("gcn", "sage")


def fault_plans(Engine, models, g) -> dict:
    """Phase 3h's base plans: GCN and SAGE [52, 64, 2] on the phase-3 plan
    (``sim``) and the phase-3b plan (``mesh-bsp``, the DAQ halo wire), the
    kernel path, ``exchange="halo_async"`` with STALE_BOUND, compiled with
    ``validate="strict"``; (plan, compile s) by (kind, executor)."""
    return {(kind, ex): gnn_plan(Engine, models, g, kind, executor=ex,
                                 aggregation="pallas", exchange="halo_async",
                                 staleness_bound=STALE_BOUND,
                                 validate="strict")
            for kind in FAULT_KINDS for ex in ("sim", "mesh-bsp")}


def lint_counts(kernel_lint, plan, batched: bool) -> dict:
    """The launches ``kernel_lint.launches_for_plan`` predicts for one
    execute (``batched=False``) or one ``execute_many`` of BATCH."""
    want = dict.fromkeys(REPLACES, 0)
    want.update(kernel_lint.launch_counts(
        s for s in kernel_lint.launches_for_plan(plan, BATCH)
        if (s.batch is not None) == batched))
    return want


def timed_ms(fn):
    def run():
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    return run


def failover_path(Engine, models, g, analysis, api, plans,
                  drive_each) -> list:
    """Phase 3h, failover plans: ``Engine.fail_nodes(plan, CRASH_NODE)`` in
    repair mode for every base plan and in recompile mode for GCN's
    (strict validation at its exit), the
    fault family on its ``FailoverAudit`` (0 errors); a recompile plan's
    host layout ``==`` a fresh compile on the survivors and its execute
    bitwise that plan's; on ``sim`` a repair plan's execute bitwise the
    pre-crash one; on the mesh a repair plan within the DAQ bar of the
    float64 forward (gating DAQ_GATED_KINDS), two executes equal and an
    ``execute_many`` of BATCH bitwise BATCH serial executes. Each plan's
    first execute, second execute and batch are driven with the counts
    set to 0 just before each, and each must equal what
    ``kernel_lint.launches_for_plan`` predicts for the plan. Reports the
    host ms of ``fail_nodes`` and of the first execute after it."""
    from repro_torch.analysis import kernel_lint
    recs, runs, cases = [], [], []
    for (kind, ex), (plan, compile_s) in plans.items():
        eng = Engine.from_plan(plan)
        base = plan.session(staleness_bound=0)
        x = base.collect()
        rng = np.random.default_rng(7)
        stack = np.stack([base.collect(g.features + rng.normal(
            scale=0.1, size=g.features.shape)) for _ in range(BATCH)])
        before = base.execute(x)
        # A recompile's layout depends on the graph and the survivors, not
        # on the model: GCN's covers SAGE's.
        for mode in ("repair", "recompile") if kind == "gcn" else (
                "repair",):
            t0 = time.perf_counter()
            plan2 = eng.fail_nodes(plan, CRASH_NODE, mode=mode)
            fail_ms = (time.perf_counter() - t0) * 1e3
            audit = api.FailoverAudit(plan=plan2, base_plan=plan,
                                      crashed=(CRASH_NODE,))
            report = analysis.run_checks(analysis.AnalysisContext(
                plan=plan2, failover=audit), families=("fault",))
            if report.errors or plan2.partitioned.device_cache:
                raise AssertionError(f"failover {kind} {ex} {mode}: "
                                     f"{report.format()}")
            sess = plan2.session(staleness_bound=0)
            case = {"kind": kind, "executor": ex, "mode": mode,
                    "plan": plan2, "base": plan, "x": x, "stack": stack,
                    "before": before, "fail_ms": fail_ms,
                    "fault_checks": len(report.ran)}
            runs += [timed_ms(lambda s=sess: s.execute(x)),
                     timed_ms(lambda s=sess: s.execute(x)),
                     timed_ms(lambda s=sess: s.execute_many(stack))]
            cases.append(case)
    outs, counts = drive_each("failover", runs)
    for i, case in enumerate(cases):
        (first, first_ms), (again, _), (many, batch_ms) = outs[3 * i:3 * i
                                                                + 3]
        plan2, kind, ex, mode = (case["plan"], case["kind"],
                                 case["executor"], case["mode"])
        what = f"failover {kind} {ex} {mode}"
        for j, batched in ((0, False), (1, False), (2, True)):
            check_launches(f"{what} run {j}", counts[3 * i + j],
                           lint_counts(kernel_lint, plan2, batched))
        report = analysis.run_checks(plan2, families=("kernel", "cache"))
        if report.errors:
            raise AssertionError(f"{what}: {report.format()}")
        if not np.array_equal(first, again):
            raise AssertionError(f"{what}: two executes differ")
        if not all(np.array_equal(m, case_exec) for m, case_exec in
                   zip(many, (plan2.session(staleness_bound=0).execute(s)
                              for s in case["stack"]))):
            raise AssertionError(f"{what}: the batch is not bitwise "
                                 f"{BATCH} serial executes")
        rec = {"kind": kind, "executor": ex, "mode": mode,
               "fogs": plan2.num_fogs, "fail_nodes_ms": case["fail_ms"],
               "first_execute_ms": first_ms, "batch_ms": batch_ms,
               "fault_checks": case["fault_checks"],
               "launches": counts[3 * i]}
        if mode == "recompile":
            survivors = dataclasses.replace(
                plan2.cluster, nodes=[n for n in case["base"].cluster.nodes
                                      if n.name != CRASH_NODE])
            cfg = case["base"].config
            fresh = Engine(case["base"].model, survivors,
                           executor=cfg.executor, aggregation="pallas",
                           compressor=cfg.compressor, exchange=cfg.exchange,
                           staleness_bound=cfg.staleness_bound,
                           validate="strict", device="cuda").compile(g)
            same = (np.array_equal(plan2.placement.assignment,
                                   fresh.placement.assignment)
                    and all(np.array_equal(getattr(plan2.partitioned, f),
                                           getattr(fresh.partitioned, f))
                            for f in ("part_of", "slot_of", "senders_halo",
                                      "boundary_rows", "boundary_mask")))
            if not same:
                raise AssertionError(f"{what}: the host layout is not a "
                                     f"fresh compile's on the survivors")
            if not np.array_equal(first, fresh.session(
                    staleness_bound=0).execute(case["x"])):
                raise AssertionError(f"{what}: not bitwise a fresh compile")
            del fresh
        elif ex == "sim":
            if not np.array_equal(first, case["before"]):
                raise AssertionError(f"{what}: not bitwise the pre-crash "
                                     f"execute")
        else:
            c = daq_errors(first, f64_forward(models, plan2, kind)(
                case["x"]))
            rec["daq_vs_f64"] = c
            if kind in DAQ_GATED_KINDS and c["ratio"] > 1:
                raise AssertionError(f"{what}: DAQ wire beyond the "
                                     f"reference's bar: {c}")
        log(f"  {what}: {plan2.num_fogs} fogs, fail_nodes "
            f"{case['fail_ms']:.1f} ms, first execute {first_ms:.1f} ms, "
            f"batch {batch_ms:.1f} ms"
            + (f", DAQ vs f64 ratio {rec['daq_vs_f64']['ratio']:.3g}"
               if "daq_vs_f64" in rec else "") + "; launches as linted")
        recs.append(rec)
    return recs


def recorded_batches(sess, wrappers):
    """Wrap ``sess.execute_many`` (what the Server calls once a batch) to
    record each batch's plan, staleness, size, launches and output."""
    calls = []
    orig = sess.execute_many

    def execute_many(feats, **kw):
        before = {n: w.launches for n, w in wrappers.items()}
        out = orig(feats, **kw)
        calls.append({"plan": sess.plan, "staleness": sess.last_staleness,
                      "b": len(feats), "out": out, "launches": {
                          n: w.launches - before[n]
                          for n, w in wrappers.items()}})
        return out
    sess.execute_many = execute_many
    return calls


class host_only:
    """Within the block, the port's block-CSR products return zeros on the
    CPU instead of running their plain versions: a replay's host decisions
    (simulated clock, recovery tiers, staleness) read no product, so a CPU
    replay of full SIoT costs only its host work."""

    def __init__(self, bsp, ops):
        self.bsp, self.ops = bsp, ops

    def __enter__(self):
        class Zero:
            def aggregate_traced(self, h, subset=None):
                return torch.zeros_like(h)
        self.saved = (self.bsp._folded_csrs, self.bsp._kernel_sum,
                      self.ops.block_csr_for)
        self.bsp._folded_csrs = lambda pg, device, *a: (None, None)
        self.bsp._kernel_sum = lambda pg, h, *a, **kw: torch.zeros_like(h)
        self.ops.block_csr_for = lambda *a, **kw: Zero()
        return self

    def __exit__(self, *exc):
        (self.bsp._folded_csrs, self.bsp._kernel_sum,
         self.ops.block_csr_for) = self.saved


def cpu_copy(plan):
    """``plan``'s host state on the CPU: the same graph, placement and
    layout (an empty device cache), the model and edge list copied to
    the CPU, and the cluster's nodes copied (stragglers mutate a node's
    load in place)."""
    edges = type(plan.edges)(*(t.cpu() if torch.is_tensor(t) else t
                               for t in plan.edges))
    return dataclasses.replace(
        plan, model=plan.model.to("cpu"), edges=edges,
        cluster=copy.deepcopy(plan.cluster),
        config=plan.config.with_overrides(device="cpu"),
        partitioned=dataclasses.replace(plan.partitioned, device_cache={}))


def cpu_replay(cpu_plan, trace, faults, bsp, ops, **session_kw) -> list:
    """A CPU replay of ``trace`` under ``faults`` (None: fault-free) on a
    ``cpu_copy``, host work only (see ``host_only``)."""
    with host_only(bsp, ops):
        return cpu_plan.server(max_batch=SERVER_MAX_BATCH, faults=faults,
                               **session_kw).replay(trace)


def loads_kept(plan, fn):
    """``fn`` with the cluster's background loads put back after it (a
    straggler still running when a replay ends keeps its extra load)."""
    def run():
        loads = [n.background_load for n in plan.cluster.nodes]
        try:
            return fn()
        finally:
            for n, load in zip(plan.cluster.nodes, loads):
                n.background_load = load
    return run


def fault_tags(r) -> tuple:
    return (r.request_id, r.recovered, r.retries, r.capacity, r.staleness)


def fresh_and_stale(bsp, plan) -> tuple:
    """(fresh, stale) embeddings of ``plan`` for its stored features: a
    fresh serve's, and the replay of the halo tables that serve records
    (``bsp_infer_stale`` over ``build_halo_tables``; mesh plans)."""
    sess = plan.session(staleness_bound=0)
    x = sess.collect()
    fresh = sess.execute(x)
    if plan.config.executor != "mesh-bsp":
        return fresh, fresh
    backend = sess.resolve_executor()
    layers = backend.run_layers(plan, x, plan.placement.assignment,
                                plan.partitioned, plan.config.exchange,
                                aggregation="pallas")
    tables = bsp.build_halo_tables(plan.partitioned, [x] + layers[:-1])
    stale = bsp.bsp_infer_stale(list(plan.model.params), plan.model.kind, x,
                                plan.partitioned, tables, device="cuda",
                                aggregation="pallas")
    return fresh, stale


def check_batches(what: str, calls, kernel_lint, bsp, k: int,
                  segment: bool = False) -> dict:
    """Gates of a replay's recorded batches: each batch's launches exact
    (a fresh mesh serve what ``launches_for_plan`` predicts for a batch, a
    stale one 2K ``block_spmm_batched``; a single-program batch K
    ``block_spmm``, batched for two or more; a segment-sum batch of b
    b * K segment sums) and each output bitwise the fresh (staleness 0)
    or stale replay of the plan that served it. Returns the counts of
    fresh and stale examples and of plans seen."""
    refs, n_fresh, n_stale = {}, 0, 0
    for i, c in enumerate(calls):
        plan, b, s = c["plan"], c["b"], c["staleness"]
        mesh = plan.config.executor == "mesh-bsp"
        want = dict.fromkeys(REPLACES, 0)
        if segment:
            want.update(segment_launches(plan.model.kind, b * k))
        elif mesh and s == 0:
            want = lint_counts(kernel_lint, plan, True)
        elif mesh:
            want["block_spmm_batched"] = 2 * k
        else:
            want["block_spmm" + ("" if b == 1 else "_batched")] = k
        check_launches(f"{what} batch {i}", c["launches"], want)
        if id(plan) not in refs:
            refs[id(plan)] = fresh_and_stale(bsp, plan) if not segment \
                else (plan.session(staleness_bound=0,
                                   aggregation="segment_sum").query()
                      .embeddings,) * 2
        fresh, stale = refs[id(plan)]
        want_emb = stale if (mesh and s > 0) else fresh
        for e in c["out"]:
            if not np.array_equal(e, want_emb):
                kind = "stale replay" if mesh and s else "fresh serve"
                raise AssertionError(f"{what} batch {i} (staleness {s}, "
                                     f"{plan.provenance}): not bitwise the "
                                     f"{kind} of its plan")
        n_fresh += b * (s == 0)
        n_stale += b * (s > 0)
    return {"fresh": n_fresh, "stale": n_stale, "plans": len(refs)}


def mesh_schedule(api, free, span: float):
    """Phase 3h's schedule on the mesh, placed on the fault-free replay
    ``free`` of the same trace (the clocks agree up to the first event):
    a ``halo_loss`` past ``max_retries`` (6 lost rounds, no node named) at
    the service instant of the first batch whose predecessor left the
    halo store able to serve once more stale (tier 2), then 2 lost rounds
    (tier 1), a 3x straggler on SLOW_NODE, a crash of CRASH_NODE and its
    recover (tier 3 and the restore)."""
    batches = sorted({(r.batch_index, r.service_start, r.staleness)
                      for r in free})
    j = next(i for i in range(1, len(batches))
             if batches[i - 1][2] + 1 <= STALE_BOUND
             and batches[i][1] > batches[i - 1][1])
    t_stale = batches[j][1]
    t_retry = batches[min(j + 2, len(batches) - 1)][1] + 1e-6
    F = api.faults.Fault
    return api.faults.FaultSchedule([
        F(t_stale, "halo_loss", losses=6),
        F(max(t_retry, t_stale + 1e-6), "halo_loss", losses=2),
        F(0.35 * span, "straggler", node=SLOW_NODE, duration=0.2 * span,
          slowdown=3.0),
        F(0.5 * span, "crash", node=CRASH_NODE),
        F(0.8 * span, "recover", node=CRASH_NODE)])


def chaos_mesh(Engine, api, bsp, ops, plans, drive_each, wrappers) -> dict:
    """Phase 3h, the chaos replay on the mesh (GCN, ``halo_async`` with
    STALE_BOUND, the DAQ wire): FAULT_REQUESTS Poisson requests at phase
    3f's rate, first fault-free, then under ``mesh_schedule``; 0 drops,
    availability 1.0, the four tier tags and a degraded window, the
    session back on the original plan; every batch's launches exact and
    its outputs bitwise the fresh serve or the stale replay of the plan
    that served it; an untagged response bitwise the fault-free one at the
    same staleness; every response's recovered / retries / capacity /
    staleness those of a CPU replay of the same schedule and trace."""
    from repro_torch.analysis import kernel_lint
    plan = plans["gcn", "mesh-bsp"][0]
    k = plan.model.num_layers
    rate = server_rate(plan)
    trace = api.traces.poisson(FAULT_REQUESTS, rate, seed=0)
    span = max(r.arrival_time for r in trace)
    cpu_plan = cpu_copy(plan)
    free_srv = plan.server(max_batch=SERVER_MAX_BATCH)
    free_calls = recorded_batches(free_srv.session, wrappers)
    chaos_srv = [None]

    def chaos():
        t0 = time.perf_counter()
        out = chaos_srv[0].replay(trace)
        return out, time.perf_counter() - t0
    state = {}

    def free_run():
        out, wall = replay_thunk(free_srv, trace)()[0::2]
        sched = mesh_schedule(api, out, span)
        srv = plan.server(max_batch=SERVER_MAX_BATCH, faults=sched)
        state.update(sched=sched, calls=recorded_batches(srv.session,
                                                         wrappers))
        chaos_srv[0] = srv
        return out, wall
    outs, counts = drive_each("chaos-mesh", [free_run,
                                             loads_kept(plan, chaos)])
    (free, free_s), (out, chaos_s) = outs
    srv, sched = chaos_srv[0], state["sched"]
    summary = srv.summarize(out)
    if len(out) != FAULT_REQUESTS or summary["availability"] != 1.0:
        raise AssertionError(f"chaos mesh: {len(out)} responses of "
                             f"{FAULT_REQUESTS}, {summary}")
    tags = [r.recovered for r in out]
    for tag in ("stale", "retry", "failover", "restored"):
        if tag not in tags:
            raise AssertionError(f"chaos mesh: no response tagged {tag!r} "
                                 f"({tags})")
    if "degraded" not in [r.capacity for r in out] or \
            srv.session.plan is not plan or srv._crashed:
        raise AssertionError("chaos mesh: no degraded window, or not "
                             "restored onto the original plan")
    stats = {"free": check_batches("chaos mesh (fault-free)", free_calls,
                                   kernel_lint, bsp, k),
             "chaos": check_batches("chaos mesh", state["calls"],
                                    kernel_lint, bsp, k)}
    by_id = {r.request_id: r for r in free}
    same = 0
    for r in out:
        ref = by_id[r.request_id]
        if r.recovered is None and r.capacity == "full" and \
                r.staleness == ref.staleness:
            same += 1
            if not np.array_equal(r.embeddings, ref.embeddings):
                raise AssertionError(f"chaos mesh: untagged response "
                                     f"{r.request_id} is not the "
                                     f"fault-free one")
    if not same:
        raise AssertionError("chaos mesh: no untagged response to compare")
    t0 = time.perf_counter()
    cpu = [fault_tags(r) for r in cpu_replay(cpu_plan, trace, sched, bsp,
                                             ops)]
    cpu_s = time.perf_counter() - t0
    if cpu != [fault_tags(r) for r in out]:
        raise AssertionError(f"chaos mesh: tags differ from the CPU "
                             f"replay: {cpu} vs "
                             f"{[fault_tags(r) for r in out]}")
    rec = {"rate_rps": rate, "schedule": [dataclasses.astuple(f)
                                          for f in sched],
           "fault_free_replay_s": free_s, "replay_s": chaos_s,
           "cpu_replay_s": cpu_s, "replayed_in_flight": srv.replayed,
           "tags": {t: tags.count(t) for t in set(tags) if t},
           "degraded": sum(r.capacity == "degraded" for r in out),
           "untagged_compared": same, "batches": stats,
           "launches": counts[1],
           **{key: summary[key] for key in
              ("availability", "retried", "recovered", "latency_p50_s",
               "latency_p95_s", "throughput_rps", "makespan_s")}}
    log(f"  chaos mesh: {FAULT_REQUESTS} requests at {rate:.2f}/s, "
        f"schedule {sched!r}; tags {rec['tags']}, {rec['degraded']} "
        f"degraded, {srv.replayed} in flight replayed; replay {chaos_s:.2f} "
        f"s (fault-free {free_s:.2f} s); every batch bitwise its plan's "
        f"fresh serve or stale replay ({stats['chaos']}), {same} untagged "
        f"== fault-free, tags == the CPU replay ({cpu_s:.1f} s); simulated "
        f"p95 {rec['latency_p95_s'] * 1e3:.1f} ms; launches exact")
    return rec


def chaos_property(api, bsp, ops, plans, drive_each, wrappers) -> list:
    """Phase 3h, tests/test_faults.py:370's seeded chaos property on the
    phase-3 plan (GCN): its trace (FAULT_REQUESTS arrivals 0.03 s apart)
    and ``FaultSchedule.random(..., **CHAOS)`` over the fault-free
    replay's simulated makespan, replayed on ``sim`` (the kernel path and
    ``aggregation="segment_sum"``) and ``single`` (segment sum): 0 drops,
    availability 1.0, every batch's launches exact and its outputs
    bitwise the fresh serve of the plan that served it (single-program
    numerics do not depend on the assignment), the tags those of a CPU
    replay of the same executor."""
    from repro_torch.analysis import kernel_lint
    plan = plans["gcn", "sim"][0]
    k = plan.model.num_layers
    trace = [api.Request(arrival_time=i * 0.03)
             for i in range(FAULT_REQUESTS)]
    cpu_plan = cpu_copy(plan)
    span = max(r.finish_time for r in cpu_replay(cpu_plan, trace, None,
                                                 bsp, ops))
    sched = api.faults.FaultSchedule.random(
        [n.name for n in plan.cluster.nodes], horizon=span, **CHAOS)
    cases = [("sim", "pallas"), ("sim", "segment_sum"),
             ("single", "segment_sum")]
    runs, servers, calls = [], [], []
    for ex, agg in cases:
        srv = plan.server(max_batch=SERVER_MAX_BATCH, faults=sched,
                          executor=ex, aggregation=agg)
        servers.append(srv)
        calls.append(recorded_batches(srv.session, wrappers))
        runs.append(loads_kept(plan, replay_thunk(srv, trace)))
    outs, counts = drive_each("chaos-property", runs)
    cpu = {ex: [fault_tags(r) for r in cpu_replay(
        cpu_plan, trace, sched, bsp, ops, executor=ex)]
        for ex in ("sim", "single")}
    recs = []
    for (ex, agg), srv, c, (out, _, wall), n in zip(cases, servers, calls,
                                                    outs, counts):
        what = f"chaos property {ex} {agg}"
        summary = srv.summarize(out)
        if len(out) != FAULT_REQUESTS or summary["availability"] != 1.0:
            raise AssertionError(f"{what}: {len(out)} responses, {summary}")
        stats = check_batches(what, c, kernel_lint, bsp, k,
                              segment=agg == "segment_sum")
        if cpu[ex] != [fault_tags(r) for r in out]:
            raise AssertionError(f"{what}: tags differ from the CPU replay")
        tags = [r.recovered for r in out]
        rec = {"executor": ex, "aggregation": agg, "replay_s": wall,
               "horizon_s": span, "events": sched.counts(),
               "tags": {t: tags.count(t) for t in set(tags) if t},
               "degraded": sum(r.capacity == "degraded" for r in out),
               "batches": stats, "launches": n,
               **{key: summary[key] for key in
                  ("availability", "retried", "recovered", "latency_p95_s",
                   "throughput_rps")}}
        log(f"  {what}: {sched!r} over {span:.2f} s; tags {rec['tags']}, "
            f"{rec['degraded']} degraded; replay {wall:.2f} s; every batch "
            f"bitwise its plan's serve; tags == the CPU replay; launches "
            f"exact")
        recs.append(rec)
    return recs


def recover_after_update(Engine, api, bsp, plans, drive_each,
                         wrappers) -> dict:
    """Phase 3h, a recover after a graph update (the branch the JAX
    reference cannot run): on the mesh plan (GCN) CRASH_NODE crashes, a
    structural ``GraphDelta`` (2 sensors added with 6 edges, 8 edges
    removed) lands while it is down, then it recovers. The restored plan
    is a full-cluster plan of the current graph whose host layout ``==``
    a fresh compile's and whose execute is bitwise that compile's; every
    batch's launches exact and outputs bitwise its plan's fresh serve or
    stale replay."""
    from repro_torch.analysis import kernel_lint
    plan = plans["gcn", "mesh-bsp"][0]
    g = plan.graph
    k = plan.model.num_layers
    rate = server_rate(plan)
    trace = list(api.traces.poisson(FAULT_REQUESTS // 2, rate, seed=1))
    span = max(r.arrival_time for r in trace)
    rng = np.random.default_rng(17)
    v, f = g.num_vertices, g.feature_dim
    hubs = rng.choice(v, 6, replace=False)
    cut = rng.choice(g.num_edges, 8, replace=False)
    delta = api.GraphDelta(
        add_features=g.features[rng.choice(v, 2, replace=False)],
        add_edges=[(v + i % 2, int(h)) for i, h in enumerate(hubs)],
        remove_edges=[(int(g.senders[e]), int(g.receivers[e]))
                      for e in cut])
    F = api.faults.Fault
    sched = api.faults.FaultSchedule([
        F(0.2 * span, "crash", node=CRASH_NODE),
        F(0.7 * span, "recover", node=CRASH_NODE)])
    srv = plan.server(max_batch=SERVER_MAX_BATCH, faults=sched)
    calls = recorded_batches(srv.session, wrappers)
    stream = sorted(trace + [api.UpdateRequest(delta=delta,
                                               arrival_time=0.45 * span)],
                    key=lambda r: r.arrival_time)
    outs, counts = drive_each("recover-update",
                              [replay_thunk(srv, stream)])
    out, restored, wall = outs[0]
    resp = [r for r in out if isinstance(r, api.Response)]
    if len(resp) != len(trace) or "restored" not in [r.recovered
                                                     for r in resp]:
        raise AssertionError(f"recover after update: {len(resp)} "
                             f"responses, tags "
                             f"{[r.recovered for r in resp]}")
    if restored.provenance == "failover" or srv._crashed or \
            restored.graph.num_vertices != v + 2:
        raise AssertionError("recover after update: the session is not on "
                             "a full-cluster plan of the updated graph")
    t0 = time.perf_counter()
    fresh = Engine.from_plan(plan).compile(restored.graph)
    fresh_s = time.perf_counter() - t0
    for name in ("part_of", "slot_of", "senders_halo", "boundary_rows",
                 "boundary_mask", "feats"):
        if not np.array_equal(getattr(restored.partitioned, name),
                              getattr(fresh.partitioned, name)):
            raise AssertionError(f"recover after update: {name} differs "
                                 f"from a fresh compile")
    x = restored.session().collect()
    if not np.array_equal(restored.session(staleness_bound=0).execute(x),
                          fresh.session(staleness_bound=0).execute(x)):
        raise AssertionError("recover after update: the restored plan's "
                             "execute is not bitwise a fresh compile's")
    stats = check_batches("recover after update", calls, kernel_lint, bsp,
                          k)
    rec = {"replay_s": wall, "fresh_compile_s": fresh_s,
           "plans": [c["plan"].provenance for c in calls],
           "tags": [r.recovered for r in resp if r.recovered],
           "batches": stats, "launches": counts[0]}
    log(f"  recover after update: plans "
        f"{sorted(set(rec['plans']))}, tags {rec['tags']}; the restored "
        f"plan == a fresh compile of the updated graph (layout, execute "
        f"bitwise); replay {wall:.2f} s; launches exact")
    return rec


def fleet_faults(api, fleet, drive_each) -> dict:
    """Phase 3h, phase 3g's fleet with ``faults={"north": crash + recover
    of its last fog}``: the phase-3g trace (no site set down), 0 drops,
    the north site failing over and back, every response bitwise a
    session of its tier, launches exact; routes reported."""
    g = fleet.cloud_plan.graph
    north = fleet.site("north").plan
    node = north.cluster.nodes[-1].name
    rate = server_rate(fleet.sites[0].plan) * len(FLEET_SITES)

    def features_fn(i, rng):
        return g.features + rng.normal(scale=0.01, size=g.features.shape)
    trace = api.traces.poisson(
        FLEET_REQUESTS, rate, seed=0, features_fn=features_fn,
        origin_fn=api.traces.geo_origins(fleet.centroids(), seed=1))
    span = max(r.arrival_time for r in trace)
    F = api.faults.Fault
    sched = api.faults.FaultSchedule([F(0.2 * span, "crash", node=node),
                                      F(0.7 * span, "recover", node=node)])
    fs = fleet.server(capacity=FLEET_CAPACITY, max_batch=SERVER_MAX_BATCH,
                      faults={"north": sched})
    submitted = []

    def run():
        t0 = time.perf_counter()
        for r in trace:
            submitted.append(fs.submit(r))
        return fs.drain(), time.perf_counter() - t0
    outs, counts = drive_each("fleet-faults", [run])
    out, wall = outs[0]
    summary = fs.summarize(out)
    responses = [r for r in out if isinstance(r, api.Response)]
    if len(responses) != FLEET_REQUESTS or summary["dropped"]:
        raise AssertionError(f"fleet faults: {len(responses)} responses, "
                             f"{summary['dropped']} dropped")
    k = north.model.num_layers
    want = dict.fromkeys(REPLACES, 0)
    for site in fs.tier_names:
        mine = [r for r in responses if r.site == site]
        for b, _ in batches_of(mine).values():
            want["block_spmm" + ("" if b == 1 else "_batched")] += k
    check_launches("fleet faults", counts[0], want)
    plans = {s.name: s.plan for s in fleet.sites}
    plans["cloud"] = fleet.cloud_plan
    feats_of = {r.request_id: r.features for r in submitted}
    sessions = {}
    for r in responses:
        sess = sessions.setdefault(r.site, plans[r.site].session(
            staleness_bound=0))
        if not np.array_equal(r.embeddings, sess.execute(
                sess.collect(feats_of[r.request_id]))):
            raise AssertionError(f"fleet faults: response {r.request_id} "
                                 f"({r.site}) is not bitwise its tier's "
                                 f"session")
    tags = {s: sorted({str(r.recovered) for r in responses if r.site == s})
            for s in fs.tier_names}
    rec = {"crashed": f"north/{node}", "replay_s": wall,
           "launches": counts[0], "routes": summary["routes"],
           "tags": tags, "dropped": summary["dropped"],
           "availability": summary["availability"],
           "served": {s: v["served"] for s, v in summary["sites"].items()}}
    log(f"  fleet faults: north/{node} crash and recover; routes "
        f"{summary['routes']}, served {rec['served']}, tags {tags}, "
        f"dropped 0; every response bitwise its tier's session; replay "
        f"{wall:.2f} s; launches exact")
    return rec


def verifier_path(analysis, plans) -> dict:
    """Phase 3h, the static verifier at full SIoT: ``verify_plan`` (host
    ms, the plan family) on the sim and mesh plans, the kernel and cache
    families on each (0 errors, 0 warnings), and one corrupted copy of the mesh plan (a
    dropped halo row) that strict verification must refuse."""
    rec = {}
    for (kind, ex), (plan, _) in plans.items():
        t0 = time.perf_counter()
        analysis.verify_plan(plan, mode="strict")
        ms = (time.perf_counter() - t0) * 1e3
        report = analysis.run_checks(plan, families=("kernel", "cache"))
        if not report.ok or report.warnings:
            raise AssertionError(f"verifier {kind} {ex}: "
                                 f"{report.format()}")
        rec[f"{kind}/{ex}"] = {"verify_plan_ms": ms,
                               "checks_ran": len(report.ran)}
    plan = plans["gcn", "mesh-bsp"][0]
    pg = plan.partitioned
    p = int(np.argmax(pg.boundary_mask.sum(axis=1)))
    mask = pg.boundary_mask.copy()
    mask[p, 0] = 0.0
    bad = dataclasses.replace(plan, partitioned=dataclasses.replace(
        pg, boundary_mask=mask, device_cache={}))
    try:
        analysis.verify_plan(bad, mode="strict")
    except analysis.PlanValidationError as e:
        rec["corrupted"] = sorted({d.check_id for d in e.report.errors})
    else:
        raise AssertionError("verifier: a dropped halo row passed strict "
                             "validation")
    ms = {key: round(v["verify_plan_ms"], 1) for key, v in rec.items()
          if key != "corrupted"}
    log(f"  verifier: verify_plan ms {ms}; every family silent; a dropped "
        f"halo row refused by {rec['corrupted']}")
    return rec


# ----------------------------------------------------------------------------
# Phase 3i, training and the case study
# ----------------------------------------------------------------------------

#: The reference trainers' defaults (src/repro/gnn/models.py:70) and the
#: case-study example's step count (examples/traffic_forecasting.py:22).
TRAIN_KINDS = ("gcn", "sage", "gat")
TRAIN_STEPS, TRAIN_LR = 120, 5e-3
AST_STEPS = 300
#: Segment-sum launches a training step makes, (not for a gradient, for
#: one): K layers of SEGMENT_SUMS forward; then one launch a sum whose
#: input wants a gradient: GCN and SAGE sum the features at layer 1 (no
#: gradient) and layer 1's output at layer 2 (one); GAT's message sums
#: both sum functions of its weights (its w-gradient is plain PyTorch, no
#: launch), and each layer's edge-softmax backward recomputes the softmax
#: chain, its denominators one sum, and takes that sum's gradient (one
#: each). Beside them K SOFTMAXES edge-softmax launches a step, forward.
#: ASTGCN-lite: one spatial sum over all timesteps.
TRAIN_LAUNCHES = {"gcn": (2, 1), "sage": (2, 1), "gat": (4, 4)}
#: The layers of the trained models ([52, 64, 2]).
TRAIN_LAYERS = 2
AST_LAUNCHES = (1, 1)
DAQ_ACCURACY_DROP = 0.01                # tests/test_system.py:63
#: The card's ASTGCN-lite run against the CPU's from the same init: final
#: loss and each forecast error. Two float32 runs that round differently;
#: a float32 run sits 4.0e-4 (loss) and 2.0-2.8e-4 (forecast errors) from
#: the float64 one after 300 steps (scripts/astgcn_seeds.py --drift, CPU),
#: so 1e-3 leaves room for both runs' rounding and catches a wrong sum.
AST_RTOL = 1e-3
#: The paths whose runs take gradients: every other path must make no
#: backward launch.
BACKWARD_PATHS = ("train", "astgcn", "demo", "train-falcon-mamba",
                  "train-recurrentgemma", "train-cli")
#: The demo on the card against ``--device cpu``: its printed loss (3
#: decimals) may differ by one unit in the last place.
DEMO_LOSS_ATOL = 1e-3


class plain_calls:
    """Counts calls of the segment sum's plain version within the block
    (the card's path must make none)."""

    def __init__(self, ref):
        self.ref, self.calls = ref, 0

    def __enter__(self):
        self.saved = self.ref.gather_segment_sum_ref

        def counted(*a, **kw):
            self.calls += 1
            return self.saved(*a, **kw)
        self.ref.gather_segment_sum_ref = counted
        return self

    def __exit__(self, *exc):
        self.ref.gather_segment_sum_ref = self.saved


#: The mesh executor's batched calls (``runtime.bsp``), each of which
#: stages its micro-batch with one ``stage_rows`` launch (``_local_stack``).
STAGED_CALLS = ("bsp_infer_many", "bsp_infer_capture_many",
                "bsp_infer_stale_many", "bsp_infer_frontier_many")


class StagedCalls:
    """Counts the calls of ``STAGED_CALLS``, each replaced on ``bsp`` by a
    counting wrapper for the rest of the script (the executors call them
    through the module)."""

    def __init__(self, bsp):
        self.calls = 0
        for name in STAGED_CALLS:
            setattr(bsp, name, self._counted(getattr(bsp, name)))

    def _counted(self, fn):
        def counted(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        return counted


def flat_params(params):
    """(per-layer dicts of fresh leaf tensors that want gradients, their
    flat list)."""
    ps = [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
          for p in params]
    return ps, [v for p in ps for v in p.values()]


def first_step(models, layers, g, kind: str, params, device, dtype):
    """The first training step's loss and gradients on ``device`` in
    ``dtype`` (the CPU: the port's plain versions through the same
    transposed orders)."""
    ps, flat = flat_params([{k: v.to(device, dtype) for k, v in p.items()}
                            for p in params])
    edges = layers.EdgeList.from_graph(g, device=device)
    h0 = torch.as_tensor(g.features, dtype=dtype, device=device)
    y = torch.as_tensor(g.labels, dtype=torch.int64, device=device)
    loss = models.cross_entropy(models.gnn_apply(ps, kind, h0, edges), y)
    return loss.detach(), torch.autograd.grad(loss, flat)


def gradient_gate(models, layers, sg, es, g, kind: str) -> dict:
    """Phase 3i, one kind's first training step on the card (``[52, 64,
    2]``, ``gnn_init`` from a CUDA generator, seed 0): exactly
    TRAIN_LAUNCHES segment-sum launches (the backward ones counted apart)
    and K SOFTMAXES edge-softmax launches, and its loss and every gradient
    against the CPU float64 step at rtol 1e-4 / atol 1e-5."""
    fwd, bwd = TRAIN_LAUNCHES[kind]
    soft = TRAIN_LAYERS * SOFTMAXES[kind]
    init = models.gnn_init(torch.Generator(device="cuda").manual_seed(0),
                           kind, [g.feature_dim, DIMS_HIDDEN, DIMS_OUT])
    before = (sg.segment_sum.launches, sg.segment_sum.backward_launches,
              es.edge_softmax.launches)
    loss_card, g_card = first_step(models, layers, g, kind, init,
                                   torch.device("cuda"), torch.float32)
    step_launches = (sg.segment_sum.launches - before[0],
                     sg.segment_sum.backward_launches - before[1],
                     es.edge_softmax.launches - before[2])
    if step_launches != (fwd + bwd, bwd, soft):
        raise AssertionError(f"{kind} training step: {step_launches} "
                             f"(launches, backward launches, edge "
                             f"softmaxes), expected {(fwd + bwd, bwd, soft)}")
    loss_64, g_64 = first_step(models, layers, g, kind, init,
                               torch.device("cpu"), torch.float64)
    names = [f"{i}/{k}" for i, p in enumerate(init) for k in p]
    checks = {}
    for name, got, want in zip(names, g_card, g_64):
        c = checks[name] = emb_errors(got.cpu().numpy(), want.numpy())
        if c["beyond_bar"]:
            raise AssertionError(f"{kind} first-step gradient {name} vs the "
                                 f"CPU float64 one beyond rtol {EMB_RTOL} / "
                                 f"atol {EMB_ATOL}: {c}")
    worst = max(c["tol_ratio"] for c in checks.values())
    log(f"  {kind}: first-step loss {float(loss_card):.6f} (float64 "
        f"{float(loss_64):.6f}); gradients vs float64 worst ratio "
        f"{worst:.3g}")
    return {"dims": [g.feature_dim, DIMS_HIDDEN, DIMS_OUT],
            "first_step_loss": float(loss_card),
            "first_step_loss_f64": float(loss_64),
            "first_step_gradients": checks}


def train_runs(models, sg, g) -> list:
    """Phase 3i's training runs: for each kind, ``train_node_classifier``
    from a CUDA generator (seed 0) at the reference's defaults for 1 step
    and twice for TRAIN_STEPS steps. Each run returns (kind, steps,
    params, loss, wall seconds, its backward launches)."""
    def run(kind, steps):
        def go():
            b0 = sg.segment_sum.backward_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, loss = models.train_node_classifier(
                torch.Generator(device="cuda").manual_seed(0), kind, g,
                hidden=DIMS_HIDDEN, steps=steps, lr=TRAIN_LR)
            torch.cuda.synchronize()
            return (kind, steps, params, loss, time.perf_counter() - t0,
                    sg.segment_sum.backward_launches - b0)
        return go
    return [run(kind, n) for kind in TRAIN_KINDS
            for n in (1, TRAIN_STEPS, TRAIN_STEPS)]


def check_training(outs, per_run, plain_calls_made: int) -> tuple:
    """Phase 3i's training gates: every run's segment-sum launches (and
    backward ones) exactly TRAIN_LAUNCHES a step, no call of the plain
    version, two runs from one seed bitwise equal (every kind: the
    backward of GAT's ``t[index]`` gathers is CUDA's sort-based
    ``index_put_`` accumulate, a fixed order, and its ``scatter_reduce``
    max counts ties, exact in any order). Returns the records and the
    trained parameters by kind."""
    if plain_calls_made:
        raise AssertionError(f"training on the card called the plain "
                             f"segment sum {plain_calls_made} times")
    by_kind = {}
    for (kind, steps, params, loss, wall, bwd_n), counts in zip(outs,
                                                                per_run):
        fwd, bwd = TRAIN_LAUNCHES[kind]
        soft = TRAIN_LAYERS * SOFTMAXES[kind]
        if counts["segment_sum"] != steps * (fwd + bwd) or \
                bwd_n != steps * bwd or \
                counts["edge_softmax"] != steps * soft:
            raise AssertionError(
                f"{kind}: {steps} training steps launched "
                f"{counts['segment_sum']} segment sums ({bwd_n} backward) "
                f"and {counts['edge_softmax']} edge softmaxes, expected "
                f"{steps * (fwd + bwd)} ({steps * bwd}) and {steps * soft}")
        by_kind.setdefault(kind, []).append((params, loss, wall))
    recs, trained = [], {}
    for kind, ((_, loss_1, _), (params, loss_n, wall),
               (again, loss_again, wall2)) in by_kind.items():
        bitwise = loss_n == loss_again and all(
            torch.equal(a[k], b[k]) for a, b in zip(params, again)
            for k in a)
        if not bitwise:
            raise AssertionError(f"{kind}: two training runs from one seed "
                                 f"differ")
        fwd, bwd = TRAIN_LAUNCHES[kind]
        step_ms = [wall / TRAIN_STEPS * 1e3, wall2 / TRAIN_STEPS * 1e3]
        log(f"  {kind}: {TRAIN_STEPS} steps, "
            f"{statistics.median(step_ms):.3f} ms a step ({step_ms[0]:.3f} "
            f"/ {step_ms[1]:.3f}); loss step 1 {loss_1:.6f}, step "
            f"{TRAIN_STEPS} {loss_n:.6f}; {fwd} + {bwd} segment-sum "
            f"launches a step; two runs bitwise equal: {bitwise}")
        recs.append({"kind": kind, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
                     "ms_per_step": step_ms, "loss_step_1": loss_1,
                     "loss_final": loss_n,
                     "launches_per_step": {"forward": fwd,
                                           "backward": bwd},
                     "runs_bitwise_equal": bitwise})
        trained[kind] = params
    return recs, trained


def daq_accuracy(Engine, models, layers, g, params, drive) -> dict:
    """The trained GCN served through ``Engine(..., executor="sim",
    aggregation="pallas")`` on the card with ``compressor="none"`` and
    ``"daq"``: the accuracy drop of the DAQ-collected features must stay
    below DAQ_ACCURACY_DROP (paper Table IV, tests/test_system.py:63), and
    the DAQ embeddings within the reference's 8-bit bar of the float64
    forward (on the CPU, the plain versions), which a codec fault fails
    even where both codecs predict the majority class. Reported: the
    f32 embeddings against that forward, the majority class's share and
    the share of vertices whose argmax the two codecs agree on."""
    labels = torch.as_tensor(g.labels)

    def acc(emb):
        return float(models.accuracy(torch.as_tensor(emb), labels))

    def serve():
        plan = Engine((params, "gcn"), executor="sim", aggregation="pallas",
                      compressor="daq", device="cuda").compile(g)
        daq = plan.session().query().embeddings
        raw = plan.session(compressor="none").query().embeddings
        return raw, daq
    raw, daq = drive("train-serve", serve)
    p64 = [{k: v.detach().cpu().double() for k, v in p.items()}
           for p in params]
    want = models.gnn_apply(p64, "gcn", torch.as_tensor(
        g.features, dtype=torch.float64), layers.EdgeList.from_graph(g)
        ).numpy()
    daq_c, raw_c = daq_errors(daq, want), emb_errors(raw, want)
    acc_raw, acc_daq = acc(raw), acc(daq)
    drop = acc_raw - acc_daq
    majority = float(np.bincount(g.labels).max() / g.labels.shape[0])
    agree = float((np.argmax(raw, -1) == np.argmax(daq, -1)).mean())
    log(f"  trained gcn served on the card: accuracy {acc_raw:.4f} (f32 "
        f"features) vs {acc_daq:.4f} (DAQ), drop {drop:.4f}; majority "
        f"class {majority:.4f}; argmax agreement {agree:.4f}; DAQ vs "
        f"float64 forward ratio {daq_c['ratio']:.3g} of the 8-bit bar, "
        f"f32 vs it worst {raw_c['tol_ratio']:.3g} of rtol {EMB_RTOL} / "
        f"atol {EMB_ATOL}")
    if not drop < DAQ_ACCURACY_DROP:
        raise AssertionError(f"DAQ accuracy drop {drop} not below "
                             f"{DAQ_ACCURACY_DROP}")
    if daq_c["ratio"] > 1:
        raise AssertionError(f"trained gcn's DAQ embeddings beyond the "
                             f"reference's 8-bit bar: {daq_c}")
    return {"accuracy_f32": acc_raw, "accuracy_daq": acc_daq, "drop": drop,
            "majority_class_share": majority, "argmax_agreement": agree,
            "daq_vs_f64": daq_c, "f32_vs_f64": raw_c}


def astgcn_spatial_check(models, layers, ref, edges, shape) -> dict:
    """ASTGCN-lite's one-launch spatial sum on the card at the case
    study's shape ``[T_in, V, F]``: bitwise T_in launches of width F, and
    it and its autograd gradient (one backward launch over the PeMS
    transposed order) against the float64 plain version
    (``ref.gather_segment_sum_ref`` over the [V, T_in * F] table,
    differentiated by autograd) at the kernel bar."""
    t_in, v, f = shape
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(shape, device="cuda", generator=gen)
    gy = torch.randn(shape, device="cuda", generator=gen)
    xr = x.clone().requires_grad_()
    one = models.astgcn_spatial_sum(xr, edges)
    (gx,) = torch.autograd.grad(one, xr, gy)
    per_t = torch.stack([layers.aggregate_sum(x[t], edges)
                         for t in range(t_in)])
    if not torch.equal(one.detach(), per_t):
        raise AssertionError("astgcn: the one-launch spatial sum is not "
                             "bitwise the per-timestep sums")
    xd = x.double().requires_grad_()
    want = ref.gather_segment_sum_ref(
        xd.permute(1, 0, 2).reshape(v, t_in * f), edges.gather,
        edges.offsets, order=edges.order).reshape(v, t_in, f
                                                  ).permute(1, 0, 2)
    (want_gx,) = torch.autograd.grad(want, xd, gy.double())
    rec = {"forward": errors(one.detach(), want.detach()),
           "gradient": errors(gx, want_gx)}
    check_close("astgcn spatial sum", one.detach().double(), want.detach(),
                KERNEL_RTOL, KERNEL_ATOL)
    check_close("astgcn spatial sum gradient", gx.double(), want_gx,
                KERNEL_RTOL, KERNEL_ATOL)
    log(f"  astgcn: the one-launch spatial sum (F = {t_in * f}) bitwise "
        f"{t_in} sums of F = {f}; it and its gradient vs float64 plain: "
        f"err {rec['forward']['max_abs_err']:.3g} / "
        f"{rec['gradient']['max_abs_err']:.3g}")
    return rec


def astgcn_path(models, layers, datasets, ref, drive_each) -> dict:
    """Phase 3i, the case study: ``train_astgcn`` (AST_STEPS steps) on the
    PeMS window on the card from the example's init (drawn on the host, a
    CPU generator with seed 0, so the same on every machine), driven as
    path "astgcn" (exactly AST_LAUNCHES segment-sum launches a step), and
    the same training on the CPU (the plain versions) as its witness: the
    card's final loss and ``forecast_errors`` within AST_RTOL of the
    CPU's. ASTGCN-lite trains on raw readings at lr 1e-3 and diverges
    from some inits in both packages (scripts/astgcn_seeds.py); this init
    converges. Then ``astgcn_spatial_check``."""
    tg = datasets.load_pems_window(1.0, seed=0)
    t_in, _, feats = tg.history.shape
    if t_in * feats != PEMS_WIDTH:
        raise AssertionError(f"PeMS window {tg.history.shape}: not the "
                             f"{PEMS_WIDTH}-wide spatial sum of phase 2")
    init = models.astgcn_init(torch.Generator().manual_seed(0), feats,
                              t_in, tg.target.shape[0])

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = models.train_astgcn(torch.Generator(device="cuda"), tg,
                                  steps=AST_STEPS, init=init)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    ((card, wall),), (counts,) = drive_each("astgcn", [run])
    want = AST_STEPS * sum(AST_LAUNCHES)
    if counts["segment_sum"] != want:
        raise AssertionError(f"astgcn: {counts['segment_sum']} segment "
                             f"sums, expected {want}")
    t0 = time.perf_counter()
    cpu = models.train_astgcn(torch.Generator(), tg, steps=AST_STEPS,
                              init=init)
    cpu_s = time.perf_counter() - t0

    def forecast(params, mu_sd, device):
        edges = layers.EdgeList.from_graph(tg.graph, device=device)
        with torch.no_grad():
            pred = models.astgcn_apply(params, tg.history, edges
                                       ).cpu().numpy()
        return models.forecast_errors(pred * mu_sd[1] + mu_sd[0],
                                      tg.target)
    errs = forecast(card[0], card[1], "cuda")
    cpu_errs = forecast(cpu[0], cpu[1], "cpu")
    got = {"loss": card[2], **errs}
    witness = {"loss": cpu[2], **cpu_errs}
    rel = {k: abs(got[k] - witness[k]) / abs(witness[k]) for k in got}
    step_ms, cpu_step_ms = wall / AST_STEPS * 1e3, cpu_s / AST_STEPS * 1e3
    log(f"  astgcn: {AST_STEPS} steps on the card, {step_ms:.3f} ms a step "
        f"(CPU {cpu_step_ms:.3f}); loss "
        f"{card[2]:.6g} (CPU {cpu[2]:.6g}); forecast errors "
        f"{ {k: round(v, 4) for k, v in errs.items()} } (CPU "
        f"{ {k: round(v, 4) for k, v in cpu_errs.items()} }); worst "
        f"relative difference {max(rel.values()):.3g}")
    if not all(np.isfinite(v) and rel[k] <= AST_RTOL
               for k, v in got.items()):
        raise AssertionError(f"astgcn on the card {got} vs the CPU run "
                             f"{witness} beyond rtol {AST_RTOL}")
    edges = layers.EdgeList.from_graph(tg.graph, device="cuda")
    return {"steps": AST_STEPS, "spatial_sum_width": t_in * feats,
            "launches_per_step": dict(zip(("forward", "backward"),
                                          AST_LAUNCHES)),
            "ms_per_step": step_ms, "cpu_ms_per_step": cpu_step_ms,
            "loss_final": card[2], "forecast_errors": errs,
            "cpu_loss_final": cpu[2], "cpu_forecast_errors": cpu_errs,
            "relative_difference": rel,
            "spatial_sum": astgcn_spatial_check(
                models, layers, ref, edges, tg.history.shape)}


_NUMBER = re.compile(r"-?\d+(?:\.\d+)?")


def demo_matches(card: str, cpu: str, vertices: int) -> dict:
    """The demo's output on the card against ``--device cpu``'s (the same
    weights: the demo draws them on the host): every line the same but
    for its numbers and the device named; the trained loss within
    DEMO_LOSS_ATOL, each accuracy within one vertex (1 / V, and half a
    unit of its printed place each side), every other number equal."""
    a, b = card.splitlines(), cpu.splitlines()
    if len(a) != len(b):
        raise AssertionError(f"demo: {len(a)} lines on the card, {len(b)} "
                             f"with --device cpu")
    worst = {"loss": 0.0, "accuracy": 0.0}
    for la, lb in zip(a, b):
        la = la.replace(" on cuda:0", " on cpu").replace(" on cuda",
                                                         " on cpu")
        if _NUMBER.sub("#", la) != _NUMBER.sub("#", lb):
            raise AssertionError(f"demo: {la!r} vs {lb!r}")
        for m, na, nb in zip(_NUMBER.finditer(la), _NUMBER.findall(la),
                             _NUMBER.findall(lb)):
            key = ("loss" if la[:m.start()].endswith("(loss ") else
                   "accuracy" if la[:m.start()].endswith("accuracy ")
                   else None)
            d = round(abs(float(na) - float(nb)), 9)   # printed decimals
            if key is not None:
                worst[key] = max(worst[key], d)
            bar = {"loss": DEMO_LOSS_ATOL,
                   "accuracy": 1 / vertices + 1e-4}.get(key, 0.0)
            if d > bar:
                raise AssertionError(f"demo: {la!r} vs {lb!r} ({na} vs "
                                     f"{nb})")
    return worst


def train_path(models, layers, datasets, ref, sg, Engine, g, drive,
               drive_each) -> dict:
    """Phase 3i: training on the card (GCN, SAGE, GAT; the runs of every
    kind driven as one path, "train"), the trained GCN on the DAQ wire,
    the ASTGCN-lite case study and ``fograph-demo-torch``
    (``repro_torch.api.demo.main([])``, path "demo": exit 0 and the
    output of ``--device cpu``)."""
    from repro_torch.api import demo
    t0 = time.perf_counter()
    from repro_torch.kernels import edge_softmax as es
    gates = {kind: gradient_gate(models, layers, sg, es, g, kind)
             for kind in TRAIN_KINDS}
    with plain_calls(ref) as plain:
        outs, per_run = drive_each("train", train_runs(models, sg, g))
    recs, trained = check_training(outs, per_run, plain.calls)
    rec = {"kinds": [{**r, **gates[r["kind"]]} for r in recs]}
    rec["daq_accuracy"] = daq_accuracy(Engine, models, layers, g,
                                       trained["gcn"], drive)
    rec["astgcn"] = astgcn_path(models, layers, datasets, ref, drive_each)

    def run_demo(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = demo.main(argv)
        if code != 0:
            raise AssertionError(f"demo.main({argv}) returned {code}")
        return buf.getvalue()
    t1 = time.perf_counter()
    card = drive("demo", lambda: run_demo([]))
    rec["demo_s"] = time.perf_counter() - t1
    log(card.rstrip())
    cpu = run_demo(["--device", "cpu"])
    vertices = int(re.search(r"\|V\|=(\d+)", cpu).group(1))
    rec["demo_vs_cpu"] = demo_matches(card, cpu, vertices)
    log(f"  demo: the card's output is --device cpu's (loss and "
        f"accuracy differ by at most {rec['demo_vs_cpu']})")
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ---------------------------------------------------------------------------
# Phase 3k, transformer training at full width
# ---------------------------------------------------------------------------

#: Phase 3k's training paths: (arch, path, layers kept, B, S, micro-batches),
#: each at the config's full width and dtypes (f32 parameters, bf16
#: activations) and cut in depth only, for memory and the script's time:
#: falcon-mamba-7b keeps 4 of its 64 layers (0.953 B parameters, 15.3 GB
#: with gradients and f32 moments), recurrentgemma-9b one period of its
#: pattern, 3 of 38 (2.687 B, 43.0 GB); the whole models with AdamW state
#: need 116 GB and 153 GB. recurrentgemma's S = 3072 passes its 2048
#: window, so the local attention masks.
LM_TRAIN = (("falcon-mamba-7b", "train-falcon-mamba", 4, 2, 2048, 1),
            ("recurrentgemma-9b", "train-recurrentgemma", 3, 2, 3072, 2))
LM_STEPS, LM_CKPT_STEP = 4, 2
LM_SCHEDULE = dict(base_lr=3e-4, warmup=2, total=4)
#: Gate 3: the first step's loss and gradients through the kernels against
#: the same step through the scans' plain forward and backward, in f32
#: activations at this sequence length.
LM_PLAIN_S = 256
#: The reference launcher's defaults (granite-3-2b, --size 25m, 100 steps,
#: seq 256, batch 8), then the same run resumed to 120 steps; a
#: checkpoint every 20 steps gives the keep-3 collection six to thin.
TRAIN_CLI = ["--arch", "granite-3-2b", "--size", "25m", "--seq", "256",
             "--batch", "8", "--ckpt-every", "20"]
TRAIN_CLI_STEPS = (100, 120)
CKPT_KEEP = 3
#: The reference's learnability bar: the loss must fall by this much
#: (tests/test_substrate.py:82).
LEARN_DROP = 0.3
#: Reduced configs trained one step on the card and on the CPU from the
#: same weights (B = 2, S = REDUCED_TRAIN_S).
REDUCED_TRAIN = ("falcon-mamba-7b", "recurrentgemma-9b", "deepseek-v3-671b")
REDUCED_TRAIN_S = 32


class BackwardCount:
    """A scan wrapper's backward launches as a kernel row's ``launches``
    (read and set to 0 like a wrapper's own count)."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self) -> int:
        return self.fn.backward_launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.backward_launches = n


def plain_scans(ref):
    """The two scans' plain forward and backward (``kernels.ref``) as
    autograd Functions: gate 3's yardstick on the card."""
    class Selective(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return ref.selective_scan_ref(*args)

        @staticmethod
        def backward(ctx, dy, dh_last):
            return ref.selective_scan_bwd_ref(*ctx.saved_tensors, dy,
                                              dh_last)

    class RGLRU(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            hs, h_last = ref.rglru_scan_ref(*args)
            ctx.save_for_backward(*args, hs)
            return hs, h_last

        @staticmethod
        def backward(ctx, dhs, dh_last):
            return ref.rglru_scan_bwd_ref(*ctx.saved_tensors, dhs, dh_last)

    return Selective.apply, RGLRU.apply


@contextlib.contextmanager
def patched(module, **names):
    """``module``'s attributes replaced by ``names`` for the block."""
    old = {k: getattr(module, k) for k in names}
    for k, v in names.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def on_card(batch: dict) -> dict:
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def leaf_errors(got: list, want: list) -> dict:
    """The worst leaf at the kernel bar (rtol 1e-4, atol 1e-5 * max(1,
    max|want|) per leaf): its ratio and max |err|."""
    worst = {"tol_ratio": 0.0, "max_abs_err": 0.0}
    for g, w in zip(got, want):
        atol = SCAN_ATOL * max(1.0, float(w.abs().max()))
        e = errors(g, w, SCAN_RTOL, atol)
        worst = {k: max(worst[k], e[k]) for k in worst}
    return worst


def lm_grads(tf, cfg, params, batch, mb: int, remat: bool):
    """(loss, the gradient leaves) of ``mb`` micro-batches of ``batch``."""
    loss, grads = tf.value_and_grad(params, cfg, batch, microbatches=mb,
                                    remat=remat)
    return loss, pytree.tree_leaves(grads)


def lm_train_one(tf, registry, adamw, ckpt, pipeline, ref, ssm, drive,
                 launches, spec, bwd_ms: float) -> dict:
    """One phase-3k path: gates 3 (kernels against plain) and 2 (remat)
    on the first step, then LM_STEPS AdamW steps driven as ``path`` with a
    checkpoint at LM_CKPT_STEP, then gate 1: the checkpoint restored into
    fresh parameters and state and the last steps run again, bitwise the
    uninterrupted run."""
    arch, path, layers, b, s, mb = spec
    cfg = dataclasses.replace(registry.get(arch), num_layers=layers)
    n = sum(sp.mixer in ("mamba", "rglru") for sp in cfg.layer_specs())
    scan = ("selective_scan" if cfg.layer_specs()[0].mixer == "mamba"
            else "rglru_scan")
    log(f"  {arch}: {cfg.param_count() / 1e9:.3f} B parameters, depth cut "
        f"to {layers} of {registry.get(arch).num_layers} layers ({n} "
        f"{scan} layers), B = {b}, S = {s}, {mb} micro-batch(es)")
    t_path = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen)
    shape = pipeline.InputShape

    # Gate 3: the kernels against the plain scans, f32 activations.
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    small = on_card(pipeline.SyntheticCorpus(
        cfg, shape("train", LM_PLAIN_S, b, "train"), seed=1).batch(0))
    loss_k, g_k = lm_grads(tf, cfg32, params, small, 1, True)
    sel, rg = plain_scans(ref)
    with patched(ssm, selective_scan=sel, rglru_scan=rg):
        loss_p, g_p = lm_grads(tf, cfg32, params, small, 1, True)
    plain_err = leaf_errors(g_k, g_p)
    loss_err = errors(loss_k, loss_p, SCAN_RTOL,
                      SCAN_ATOL * max(1.0, abs(float(loss_p))))
    del g_k, g_p
    log(f"  kernels vs plain scans (f32, S = {LM_PLAIN_S}): loss "
        f"{float(loss_k):.6f} vs {float(loss_p):.6f}; worst gradient leaf "
        f"ratio {plain_err['tol_ratio']:.3g} (max err "
        f"{plain_err['max_abs_err']:.3g})")
    if max(plain_err["tol_ratio"], loss_err["tol_ratio"]) > 1:
        raise AssertionError(f"{path}: kernels vs plain scans {plain_err}, "
                             f"loss {loss_err}")

    # Gate 2: remat bitwise no remat, on the first training batch.
    corpus = pipeline.SyntheticCorpus(cfg, shape("train", s, b, "train"),
                                      seed=0)
    first = on_card(corpus.batch(0))
    l1, g1 = lm_grads(tf, cfg, params, first, mb, True)
    l0, g0 = lm_grads(tf, cfg, params, first, mb, False)
    remat_bitwise = bool(torch.equal(l0, l1)) and all(
        torch.equal(x, y) for x, y in zip(g0, g1))
    del g0, g1
    if not remat_bitwise:
        raise AssertionError(f"{path}: remat's first-step loss or "
                             f"gradients differ from remat off")
    torch.cuda.empty_cache()

    # The run, driven: LM_STEPS steps, a checkpoint at LM_CKPT_STEP.
    opt = adamw.AdamW(learning_rate=adamw.warmup_cosine(**LM_SCHEDULE))
    step = tf.make_train_step(cfg, opt, microbatches=mb, remat=True)
    ckdir = ROOT / "build" / "ckpt_3k"
    shutil.rmtree(ckdir, ignore_errors=True)
    need = 12 * cfg.param_count()
    free = shutil.disk_usage(ROOT).free
    if free < 1.2 * need:
        raise AssertionError(f"{path}: {free / 1e9:.1f} GB free beside the "
                             f"checkpoint's {need / 1e9:.1f} GB")
    box = {"params": params, "state": opt.init(params)}
    del params

    def run(first_step: int, save: bool):
        metrics, ms = [], []
        save_s = None
        for i in range(first_step, LM_STEPS):
            batch = on_card(corpus.batch(i))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            box["params"], box["state"], m = step(box["params"],
                                                  box["state"], batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append((m["loss"], m["grad_norm"]))
            if save and i + 1 == LM_CKPT_STEP:
                t0 = time.perf_counter()
                ckpt.save(str(ckdir), i + 1, {"params": box["params"],
                                              "opt": box["state"]})
                save_s = time.perf_counter() - t0
        return metrics, ms, save_s

    torch.cuda.reset_peak_memory_stats()
    metrics, ms, save_s = drive(path, lambda: run(0, True))
    peak = torch.cuda.max_memory_allocated()
    want = {scan: LM_STEPS * n * mb * 2, scan + "_bwd": LM_STEPS * n * mb,
            "segment_sum": LM_STEPS * mb}
    check_path_launches(path, launches[path], want)
    losses = [float(m[0]) for m in metrics]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{path}: losses {losses}")
    final = [t.cpu() for t in pytree.tree_leaves(
        [box["params"], box["state"].m, box["state"].v])]
    del box["params"], box["state"]
    torch.cuda.empty_cache()

    # Gate 1: resume from the checkpoint into fresh parameters and state.
    t0 = time.perf_counter()
    fresh = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    target = {"params": fresh, "opt": opt.init(fresh)}
    del fresh
    restored = ckpt.restore(str(ckdir), target)
    del target
    box["params"], box["state"] = restored["params"], restored["opt"]
    del restored
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ckdir, ignore_errors=True)
    resumed, _, _ = run(LM_CKPT_STEP, False)
    again = pytree.tree_leaves([box["params"], box["state"].m,
                                box["state"].v])
    resume_bitwise = (int(box["state"].step) == LM_STEPS and all(
        torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
        for x, y in zip(resumed, metrics[LM_CKPT_STEP:])) and all(
        torch.equal(x.cpu(), y) for x, y in zip(again, final)))
    del again, final, box["params"], box["state"]
    torch.cuda.empty_cache()
    if not resume_bitwise:
        raise AssertionError(f"{path}: the resumed steps differ from the "
                             f"uninterrupted run")
    steady = statistics.median(ms[1:])
    rec = {"arch": arch, "path": path, "num_layers": layers,
           "depth_cut": f"{layers} of {registry.get(arch).num_layers}",
           "parameters": cfg.param_count(), "B": b, "S": s,
           "microbatches": mb, "steps": LM_STEPS, "losses": losses,
           "grad_norms": [float(m[1]) for m in metrics],
           "step_ms": ms, "step_ms_median": steady,
           "tokens_per_s": b * s / (steady / 1e3),
           "peak_gb": peak / 1e9, "checkpoint_gb": need / 1e9,
           "save_s": save_s, "restore_s": restore_s,
           "backward_kernel_ms": bwd_ms,
           "backward_share": bwd_ms * n * mb / steady,
           "launches": {k: v for k, v in launches[path].items() if v},
           "launches_per_step": {k: v // LM_STEPS for k, v in want.items()},
           "gates": {"resume_bitwise": resume_bitwise,
                     "remat_bitwise": remat_bitwise,
                     "kernels_vs_plain": plain_err,
                     "kernels_vs_plain_loss": loss_err,
                     "finite": True},
           "path_s": time.perf_counter() - t_path}
    log(f"  {arch} train: {steady:.1f} ms a step (median after the first; "
        f"first {ms[0]:.1f}), {rec['tokens_per_s']:.0f} training tokens/s, "
        f"peak {rec['peak_gb']:.1f} GB allocated; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; backward kernels "
        f"{n * mb} x {bwd_ms:.3f} ms = {100 * rec['backward_share']:.2f} % "
        f"of a step (phase 2's time); launches {rec['launches']}; "
        f"checkpoint {need / 1e9:.1f} GB saved in {save_s:.1f} s, restored "
        f"in {restore_s:.1f} s; resume, remat bitwise; {rec['path_s']:.1f} s")
    return rec


def train_cli(drive, launches) -> dict:
    """``python -m repro_torch.launch.train`` at the reference's defaults
    with a checkpoint directory, then again to TRAIN_CLI_STEPS[1], in this
    process (``runpy``, as ``-m`` runs it) so that its launches count:
    the second run resumes from the first's last checkpoint, the loss
    falls by LEARN_DROP, CKPT_KEEP checkpoints stay."""
    import runpy
    ckdir = ROOT / "build" / "ckpt_cli"
    shutil.rmtree(ckdir, ignore_errors=True)

    def run(steps: int) -> str:
        buf, old = io.StringIO(), sys.argv
        sys.argv = ["train", *TRAIN_CLI, "--steps", str(steps),
                    "--ckpt-dir", str(ckdir)]
        try:
            with contextlib.redirect_stdout(buf), warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                runpy.run_module("repro_torch.launch.train",
                                 run_name="__main__")
        except SystemExit as e:
            if e.code not in (0, None):
                raise AssertionError(f"launch.train exited {e.code}")
        finally:
            sys.argv = old
        for line in buf.getvalue().splitlines():
            log(f"    {line}")
        return buf.getvalue()

    t0 = time.perf_counter()
    first, second = drive("train-cli", lambda: [run(n)
                                                for n in TRAIN_CLI_STEPS])
    wall = time.perf_counter() - t0
    check_path_launches("train-cli", launches["train-cli"],
                        {"segment_sum": TRAIN_CLI_STEPS[1]})
    loss = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step\s+(\d+) loss (\S+)", first + second, re.M)}
    kept = sorted(p.name for p in ckdir.glob("step_*.npz"))
    shutil.rmtree(ckdir, ignore_errors=True)
    n0, n1 = TRAIN_CLI_STEPS
    rec = {"argv": TRAIN_CLI, "steps": list(TRAIN_CLI_STEPS), "losses": loss,
           "resumed": f"resumed from step {n0}" in second,
           "drop": loss[1] - loss[n0], "kept": kept, "wall_s": wall,
           "launches": {k: v for k, v in launches["train-cli"].items()
                        if v}}
    log(f"  train-cli: loss {loss[1]:.4f} at step 1, {loss[n0]:.4f} at "
        f"{n0}, {loss.get(n1, float('nan')):.4f} at {n1} (drop "
        f"{rec['drop']:.3f}, bar {LEARN_DROP}); resumed "
        f"{rec['resumed']}; kept {kept}; {wall:.1f} s")
    if not rec["resumed"] or rec["drop"] < LEARN_DROP or n1 not in loss \
            or len(kept) != CKPT_KEEP:
        raise AssertionError(f"train-cli: {rec}")
    return rec


def reduced_train(tf, registry, pipeline) -> list:
    """Reduced falcon-mamba, recurrentgemma and deepseek-v3 (MLA, MoE's
    auxiliary loss, the MTP loss): one step's loss and gradients on the
    card and on the CPU from the same weights, at the kernel bar with the
    atol scaled per leaf."""
    out = []
    for arch in REDUCED_TRAIN:
        cfg = registry.reduced(registry.get(arch))
        params = tf.init_params(cfg, torch.Generator().manual_seed(0))
        batch = pipeline.SyntheticCorpus(cfg, pipeline.InputShape(
            "train", REDUCED_TRAIN_S, 2, "train"), seed=0).batch(0)
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        lh, gh = lm_grads(tf, cfg, params, host, 1, True)
        lc, gc = lm_grads(tf, cfg,
                          to_device(params, "cuda"), on_card(batch), 1, True)
        err = leaf_errors([g.cpu() for g in gc], gh)
        loss_err = errors(lc.cpu(), lh, SCAN_RTOL,
                          SCAN_ATOL * max(1.0, abs(float(lh))))
        rec = {"arch": cfg.name, "loss_card": float(lc),
               "loss_cpu": float(lh), "loss": loss_err, "gradients": err}
        log(f"  reduced {arch} train step: card vs CPU loss "
            f"{float(lc):.6f} / {float(lh):.6f}; worst gradient leaf ratio "
            f"{err['tol_ratio']:.3g}")
        if max(err["tol_ratio"], loss_err["tol_ratio"]) > 1:
            raise AssertionError(f"reduced {arch} training: {rec}")
        out.append(rec)
    return out


def lm_train_paths(tf, registry, adamw, ckpt, pipeline, ref, ssm, drive,
                   launches, bwd_cases) -> dict:
    """Phase 3k: the two full-width training paths, each freed before the
    next, the reduced card-against-CPU steps and ``train-cli``."""
    t0 = time.perf_counter()
    bwd_ms = {c["path"]: c["ms"] for cases in bwd_cases.values()
              for c in cases["cases"] if c["path"]}
    paths = [lm_train_one(tf, registry, adamw, ckpt, pipeline, ref, ssm,
                          drive, launches, spec, bwd_ms[spec[1]])
             for spec in LM_TRAIN]
    rec = {"paths": paths,
           "reduced": reduced_train(tf, registry, pipeline),
           "train_cli": train_cli(drive, launches)}
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ----------------------------------------------------------------------------
# Phase 3l: mesh-bsp with one fog per torch.distributed rank
# ----------------------------------------------------------------------------

#: Six gloo ranks on the one card, one a fog of the default "1A+4B+1C".
#: NCCL refuses two ranks on one device; gloo stages each CUDA tensor of an
#: all_gather through host memory, the wire between the fogs.
DIST_RANKS = 6
#: GAT's attention-weighted sums stay on the segment sum, as in the
#: reference, so its ranks serve the segment-sum query only.
DIST_KINDS = ("gcn", "sage", "gat")
#: A cluster of four fogs, whose plan the six-rank group must refuse.
DIST_MISMATCH = "1A+2B+1C"


def dist_calls(Engine, models, g, kind: str, wrappers: dict) -> tuple:
    """Phase 3l's calls for ``kind``, in the order every rank and the
    folded run make them: QUERIES DAQ-wire queries, QUERIES executes of
    the collected features, one ``execute_many`` of BATCH, one f32-wire
    query (``compressor="none"``), one ``aggregation="segment_sum"``
    query; GAT the last only. Returns per call its output, host ms,
    launch deltas, and the bytes and seconds of its BSP syncs
    (``runtime.dist.WIRE``), and the DAQ session's layout."""
    from repro_torch.runtime.dist import WIRE
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.gnn_init(gen, kind, [g.feature_dim, DIMS_HIDDEN,
                                         DIMS_OUT])
    plan = Engine((params, kind), executor="mesh-bsp",
                  aggregation="segment_sum" if kind == "gat" else "pallas",
                  compressor="daq", device="cuda").compile(g)
    sess = plan.session()
    calls = []

    def call(name, fn):
        dist_call(calls, wrappers, name, fn)

    if kind != "gat":
        for i in range(QUERIES):
            call(f"query{i}", sess.query)
        feats = sess.collect()
        for i in range(QUERIES):
            call(f"execute{i}", lambda: sess.execute(feats))
        rng = np.random.default_rng(7)
        stack = np.stack([sess.collect(g.features + rng.normal(
            scale=0.1, size=g.features.shape)) for _ in range(BATCH)])
        call("batch", lambda: np.stack(sess.execute_many(stack)))
        call("f32_query", plan.session(compressor="none").query)
    call("segment_query", plan.session(aggregation="segment_sum").query)
    dist_results(calls)
    return calls, plan


def dist_call(calls: list, wrappers: dict, name: str, fn) -> None:
    """Run ``fn`` and append its output, host ms, launch deltas, and the
    bytes and seconds of its BSP syncs (``runtime.dist.WIRE``) to
    ``calls``."""
    from repro_torch.runtime.dist import WIRE
    before = {n: w.launches for n, w in wrappers.items()}
    syncs, secs = len(WIRE.sync_bytes), len(WIRE.seconds)
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1e3
    calls.append({
        "name": name, "out": out, "ms": ms,
        "launches": {n: w.launches - before[n]
                     for n, w in wrappers.items()
                     if w.launches != before[n]},
        "sync_bytes": WIRE.sync_bytes[syncs:],
        "sync_ms": [s * 1e3 for s in WIRE.seconds[secs:]]})


def dist_results(calls: list) -> None:
    """A query's output becomes its embeddings, beside its
    ``exchange_bytes``."""
    for c in calls:
        if hasattr(c["out"], "embeddings"):
            c["exchange_bytes"] = c["out"].exchange_bytes
            c["out"] = c["out"].embeddings


#: Phase 3l's faults part (path ``mesh-dist-faults``): a B node crashes,
#: and its rank then holds no shard; the kinds and wires failed over.
DIST_CRASHED = "fog2(B)"
DIST_OUTSIDE = 2
#: kind -> (compressor, failover modes): GCN on the DAQ wire, SAGE in f32,
#: GAT on the segment sum (f32 on the wire; one query a mode).
DIST_FAULT_KINDS = {"gcn": ("daq", ("repair", "recompile")),
                    "sage": ("none", ("repair", "recompile")),
                    "gat": ("daq", ("repair",))}
#: tests/test_torch_faults.py's seeded chaos schedule, over the six nodes,
#: and its replay's shape.
DIST_CHAOS = dict(horizon=0.5, crash_rate=1.5, loss_rate=2.0,
                  straggler_rate=1.0, mean_outage=0.3, seed=16)
DIST_REPLAY = dict(requests=16, max_batch=4, gap=0.03)


def dist_delta(GraphDelta, g):
    """A seeded structural delta of full SIoT: 64 new sensors wired in,
    32 removed, 64 edges removed."""
    rng = np.random.default_rng(27)
    v, k = g.num_vertices, 64
    fanout = rng.integers(1, 4, size=k)
    eidx = rng.integers(0, g.num_edges, size=k)
    return GraphDelta(
        add_features=rng.normal(size=(k, g.feature_dim)).astype(np.float32),
        add_edges=np.stack([np.repeat(v + np.arange(k), fanout),
                            rng.integers(0, v, int(fanout.sum()))], axis=1),
        remove_vertices=rng.choice(v, size=k // 2, replace=False),
        remove_edges=np.stack([g.senders[eidx], g.receivers[eidx]], axis=1))


def dist_replay(srv, Request) -> dict:
    """A replay's responses: embeddings, latencies and tags as arrays."""
    resp = srv.serve([Request(arrival_time=i * DIST_REPLAY["gap"])
                      for i in range(DIST_REPLAY["requests"])])
    resp.sort(key=lambda r: r.request_id)
    return {"embeddings": np.stack([r.embeddings for r in resp]),
            "latency": np.array([r.latency for r in resp]),
            "tags": np.array([[str(r.recovered), str(r.retries), r.capacity,
                               str(r.staleness)] for r in resp])}


def layer_bytes(bsp, pg) -> dict:
    """The bytes a sync of layout ``pg`` moves at each layer's input
    width, on the DAQ wire and in f32."""
    widths = (pg.feats.shape[-1], DIMS_HIDDEN)
    return {"daq": [bsp.exchange_bytes(pg, f, "halo", 1, 8) for f in widths],
            "f32": [bsp.exchange_bytes(pg, f, "halo") for f in widths]}


def dist_faults(Engine, models, g, wrappers: dict, plans: dict) -> tuple:
    """Phase 3l's faults part, in the order every rank and the folded run
    make its calls, on the plans ``dist_calls`` compiled (``plans`` by
    kind): per kind of DIST_FAULT_KINDS a query of the whole plan, then
    per mode a session failed over DIST_CRASHED serves its first execute,
    one query, one execute and one ``execute_many`` of BATCH (GAT: one
    query), and is rebound to the whole plan (``Server._recover``'s
    restore) for one query; one structural ``Session.update`` and a
    query; the seeded chaos replay of a ``halo_async`` GCN plan
    (``staleness_bound`` 2). Returns the calls (as ``dist_calls``) and, by
    call name, the ``layer_bytes`` of the layout each failover and update
    query ran on (the layouts themselves go, to keep the host's memory)."""
    from repro_torch.api import GraphDelta
    from repro_torch.api.faults import FaultSchedule
    from repro_torch.api.server import Request
    from repro_torch.runtime import bsp
    calls, wire = [], {}

    def call(name, fn):
        dist_call(calls, wrappers, name, fn)

    rng = np.random.default_rng(7)
    for kind, (comp, modes) in DIST_FAULT_KINDS.items():
        full = plans[kind].session(compressor=comp).plan
        stack = None
        call(f"{kind}/before", full.session().query)
        for mode in modes:
            sess = full.session()
            call(f"{kind}/{mode}/fail_nodes", lambda: np.asarray(
                sess.failover(DIST_CRASHED, mode=mode).fog_ranks))
            if kind == "gat":
                call(f"{kind}/{mode}/query", sess.query)
            else:
                feats = sess.collect()
                if stack is None:
                    stack = np.stack([sess.collect(g.features + rng.normal(
                        scale=0.1, size=g.features.shape))
                        for _ in range(BATCH)])
                call(f"{kind}/{mode}/first_execute",
                     lambda: sess.execute(feats))
                call(f"{kind}/{mode}/query", sess.query)
                call(f"{kind}/{mode}/execute", lambda: sess.execute(feats))
                call(f"{kind}/{mode}/batch",
                     lambda: np.stack(sess.execute_many(stack)))
            wire[f"{kind}/{mode}"] = layer_bytes(bsp, sess.partitioned())
            sess.rebind(full)
            call(f"{kind}/{mode}/restored", sess.query)
        del full, sess
    sess = plans["gcn"].session()
    call("update", lambda: np.asarray(
        sess.update(dist_delta(GraphDelta, g)).mode))
    call("update/query", sess.query)
    wire["update"] = layer_bytes(bsp, sess.partitioned())
    del sess
    chaos = Engine(plans["gcn"].model, executor="mesh-bsp",
                   aggregation="pallas", compressor="daq",
                   exchange="halo_async", staleness_bound=STALE_BOUND,
                   device="cuda").compile(g)
    srv = chaos.server(max_batch=DIST_REPLAY["max_batch"],
                       faults=FaultSchedule.random(
                           [nd.name for nd in chaos.cluster.nodes],
                           **DIST_CHAOS))
    call("replay/chaos", loads_kept(chaos, lambda: dist_replay(srv, Request)))
    dist_results(calls)
    return calls, wire


def dist_arrays(prefix: str, calls: list) -> dict:
    """Each call's output (popped) under ``prefix/name``, a replay's
    arrays under ``prefix/name/key``."""
    arrays = {}
    for c in calls:
        out = c.pop("out")
        if isinstance(out, dict):
            arrays.update({f"{prefix}/{c['name']}/{k}": v
                           for k, v in out.items()})
        else:
            arrays[f"{prefix}/{c['name']}"] = out
    return arrays


def dist_rank(rank: int, out_dir: str) -> None:
    """One fog of phase 3l: ``dist_calls`` for every kind on its shard,
    with the wrappers' counts set to 0 just before and read just after,
    then a plan of another fog count, which the executor must refuse, then
    ``dist_faults`` (its own counts, set to 0 just before and read just
    after). Saves its outputs and records under ``out_dir``."""
    import torch.distributed as dist
    from repro_torch.api import Engine
    from repro_torch.gnn import datasets, models
    from repro_torch.kernels import daq_dequant as dq
    from repro_torch.kernels import edge_softmax as es
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.kernels import segment_sum as sg
    from repro_torch.runtime.dist import WIRE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {"block_spmm": ga.block_spmm,
                "block_spmm_batched": ga.block_spmm_batched,
                "dequant_spmm": dq.dequant_spmm,
                "dequant_spmm_batched": dq.dequant_spmm_batched,
                "segment_sum": sg.segment_sum,
                "edge_softmax": es.edge_softmax}
    g = datasets.load("siot", 1.0, seed=0)
    WIRE.reset()
    WIRE.timed = True
    for w in wrappers.values():
        w.launches = 0
    arrays, records = {}, {"rank": rank, "world": dist.get_world_size()}
    plans = {}
    t0 = time.perf_counter()
    for kind in DIST_KINDS:
        calls, plans[kind] = dist_calls(Engine, models, g, kind, wrappers)
        arrays.update(dist_arrays(kind, calls))
        records[kind] = calls
    records["seconds"] = time.perf_counter() - t0
    records["launches"] = {n: w.launches for n, w in wrappers.items()}
    records["wire_bytes"] = WIRE.bytes
    params = models.gnn_init(torch.Generator(device="cuda").manual_seed(0),
                             "gcn", [g.feature_dim, DIMS_HIDDEN, DIMS_OUT])
    try:
        Engine((params, "gcn"), cluster=DIST_MISMATCH, executor="mesh-bsp",
               device="cuda").compile(g).session()
        records["mismatch"] = ""
    except RuntimeError as e:
        records["mismatch"] = str(e)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    calls, _ = dist_faults(Engine, models, g, wrappers, plans)
    records["fault_seconds"] = time.perf_counter() - t0
    records["fault_launches"] = {n: w.launches for n, w in wrappers.items()}
    arrays.update(dist_arrays("faults", calls))
    records["faults"] = calls
    np.savez(f"{out_dir}/rank{rank}.npz", **arrays)
    Path(f"{out_dir}/rank{rank}.json").write_text(json.dumps(records))


def dist_expected(bsp, pg, kind: str, name: str, k: int) -> tuple:
    """(launches, sync bytes) one rank's call ``name`` must show."""
    daq = [bsp.exchange_bytes(pg, f, "halo", 1, 8)
           for f in (pg.feats.shape[-1], DIMS_HIDDEN)]
    f32 = [bsp.exchange_bytes(pg, f, "halo")
           for f in (pg.feats.shape[-1], DIMS_HIDDEN)]
    if name.startswith(("query", "execute")):
        return {"block_spmm": k, "dequant_spmm": k}, daq
    if name == "batch":
        return ({"block_spmm_batched": k, "dequant_spmm_batched": k},
                [BATCH * b for b in daq])
    if name == "f32_query":
        return {"block_spmm": 2 * k}, f32
    return segment_launches(kind, k), f32


def dist_path(Engine, models, g, bsp, wrappers: dict) -> tuple:
    """Phase 3l: the kernels are built; spawn DIST_RANKS gloo ranks on the
    card (``runtime.dist.spawn``), each ``dist_rank``; run the same calls
    folded in this process; then gate. Every rank's outputs must be
    bitwise the folded ones, its launches and the bytes of each BSP sync
    exactly ``dist_expected``'s (a query's first sync is its
    ``exchange_bytes``), and the plan of DIST_MISMATCH must have been
    refused naming both counts; then ``dist_faults``' gates
    (``check_dist_faults``). The folded calls run after the ranks have
    ended (seven processes holding full-SIoT layouts at once outgrow a
    96 GiB host). Returns the phase's record and the launches summed over
    ranks, of each part."""
    import tempfile
    from repro_torch.runtime import dist as fog_dist
    t0 = time.perf_counter()
    low = host_memory_low()
    with tempfile.TemporaryDirectory() as tmp:
        fog_dist.spawn(dist_rank, DIST_RANKS, tmp, tmp)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(DIST_RANKS):
            with np.load(f"{tmp}/rank{r}.npz") as f:
                arrays = dict(f)
            ranks.append((arrays, json.loads(
                Path(f"{tmp}/rank{r}.json").read_text())))
    ranks_gib = low.stop()
    rec = {"ranks": DIST_RANKS, "spawn_s": spawn_s, "kinds": {},
           "host_gib_available_low": ranks_gib}
    folded, plans, folded_s = {}, {}, {}
    for kind in DIST_KINDS:
        t1 = time.perf_counter()
        folded[kind], plans[kind] = dist_calls(Engine, models, g, kind,
                                               wrappers)
        folded_s[kind] = time.perf_counter() - t1
    t1 = time.perf_counter()
    fault_folded, wire = dist_faults(Engine, models, g, wrappers, plans)
    fault_folded_s = time.perf_counter() - t1
    summed = dict.fromkeys(REPLACES, 0)
    fault_summed = dict.fromkeys(REPLACES, 0)
    for r, (arrays, records) in enumerate(ranks):
        if (records["rank"], records["world"]) != (r, DIST_RANKS):
            raise AssertionError(f"rank file {r} holds rank "
                                 f"{records['rank']} of {records['world']}")
        msg = records["mismatch"]
        if "needs 4 ranks" not in msg or f"has {DIST_RANKS}" not in msg:
            raise AssertionError(f"rank {r}: the {DIST_MISMATCH} plan was "
                                 f"not refused by world size: {msg!r}")
        for name, n in records["launches"].items():
            summed[name] += n
        for name, n in records["fault_launches"].items():
            fault_summed[name] += n
    for kind in DIST_KINDS:
        pg = plans[kind].partitioned
        k = 2
        per_rank = []
        for r, (arrays, records) in enumerate(ranks):
            for c, want in zip(records[kind], folded[kind]):
                name = want["name"]
                if not np.array_equal(arrays[f"{kind}/{name}"], want["out"]):
                    raise AssertionError(f"{kind} rank {r} {name}: not "
                                         f"bitwise the folded run")
                launches, syncs = dist_expected(bsp, pg, kind, name, k)
                if c["launches"] != launches:
                    raise AssertionError(f"{kind} rank {r} {name}: launched "
                                         f"{c['launches']}, expected "
                                         f"{launches}")
                if c["sync_bytes"] != syncs:
                    raise AssertionError(f"{kind} rank {r} {name}: synced "
                                         f"{c['sync_bytes']} bytes, expected "
                                         f"{syncs}")
                if "exchange_bytes" in c and \
                        c["exchange_bytes"] != c["sync_bytes"][0]:
                    raise AssertionError(f"{kind} rank {r} {name}: "
                                         f"exchange_bytes "
                                         f"{c['exchange_bytes']} != the "
                                         f"first sync's {c['sync_bytes'][0]}")
            by = {c["name"]: c for c in records[kind]}
            if kind == "gat":
                per_rank.append({"segment_query_ms":
                                 by["segment_query"]["ms"]})
                continue
            queries = [by[f"query{i}"] for i in range(QUERIES)]
            executes = [by[f"execute{i}"] for i in range(QUERIES)]
            per_rank.append({
                "query_ms": statistics.median(c["ms"] for c in queries),
                "execute_ms": statistics.median(c["ms"] for c in executes),
                "all_gather_ms_per_layer": [
                    statistics.median(c["sync_ms"][l] for c in executes)
                    for l in range(k)],
                "batch_ms": by["batch"]["ms"],
                "f32_query_ms": by["f32_query"]["ms"],
                "segment_query_ms": by["segment_query"]["ms"]})
        by = {c["name"]: c for c in folded[kind]}
        rec["kinds"][kind] = {
            "per_rank": per_rank,
            "folded": {"segment_query_ms": by["segment_query"]["ms"],
                       "seconds": folded_s[kind]},
            "sync_bytes": {c["name"]: c["sync_bytes"]
                           for c in ranks[0][1][kind]
                           if c["name"] in ("query0", "batch", "f32_query",
                                            "segment_query")}}
        if kind == "gat":
            log(f"  gat segment query: ranks " + ", ".join(
                f"{pr['segment_query_ms']:.1f}" for pr in per_rank)
                + f" ms, folded {by['segment_query']['ms']:.1f} ms")
            continue
        rec["kinds"][kind]["folded"].update(
            query_ms=statistics.median(
                by[f"query{i}"]["ms"] for i in range(QUERIES)),
            execute_ms=statistics.median(
                by[f"execute{i}"]["ms"] for i in range(QUERIES)),
            batch_ms=by["batch"]["ms"])
        for r, pr in enumerate(per_rank):
            log(f"  {kind} rank {r}: query {pr['query_ms']:.1f} ms, execute "
                f"{pr['execute_ms']:.1f} ms (all_gather "
                + " / ".join(f"{x:.2f}" for x in
                             pr["all_gather_ms_per_layer"])
                + f" ms a layer), batch of {BATCH} {pr['batch_ms']:.1f} ms, "
                f"f32 query {pr['f32_query_ms']:.1f} ms, segment query "
                f"{pr['segment_query_ms']:.1f} ms")
        f = rec["kinds"][kind]["folded"]
        log(f"  {kind} folded: query {f['query_ms']:.1f} ms, execute "
            f"{f['execute_ms']:.1f} ms, batch of {BATCH} "
            f"{f['batch_ms']:.1f} ms")
    rec["wire_bytes_per_rank"] = [records["wire_bytes"]
                                  for _, records in ranks]
    rec["rank_seconds"] = [records["seconds"] for _, records in ranks]
    rec["faults"] = check_dist_faults(bsp, ranks, fault_folded, wire,
                                      plans)
    rec["faults"]["folded_s"] = fault_folded_s
    rec["faults"]["rank_seconds"] = [records["fault_seconds"]
                                     for _, records in ranks]
    rec["phase_s"] = time.perf_counter() - t0
    return rec, summed, fault_summed


def dist_fault_expected(name: str, wire: dict, plans: dict, bsp,
                        member: bool):
    """(launches, sync bytes) one rank's faults call ``name`` must show,
    None for a replay (held by its outputs and tags): a member of the
    survivors' group runs the survivors' layout (``wire``), the rank
    outside it nothing; the whole plan runs on every rank."""
    if name.startswith("replay/"):
        return None
    if name == "update" or name.endswith("/fail_nodes"):
        return {}, []
    parts = name.split("/")
    if name == "update/query":
        kind, comp, syncs = "gcn", "daq", wire["update"]
    else:
        kind, comp = parts[0], DIST_FAULT_KINDS[parts[0]][0]
        if parts[-1] in ("before", "restored"):
            syncs = layer_bytes(bsp, plans[kind].partitioned)
        elif not member:
            return {}, []
        else:
            syncs = wire[f"{kind}/{parts[1]}"]
    k = 2
    if kind == "gat":
        return segment_launches(kind, k), syncs["f32"]
    if comp == "daq":
        one = {"block_spmm": k, "dequant_spmm": k}
        many = {"block_spmm_batched": k, "dequant_spmm_batched": k}
        syncs = syncs["daq"]
    else:
        one, many = {"block_spmm": 2 * k}, {"block_spmm_batched": 2 * k}
        syncs = syncs["f32"]
    if parts[-1] == "batch":
        return many, [BATCH * b for b in syncs]
    return one, syncs


def check_dist_faults(bsp, ranks: list, folded: list, wire: dict,
                      plans: dict) -> dict:
    """Phase 3l's faults gates: every rank's outputs (the crashed fog's
    rank's too) bitwise the folded calls', latencies and tags included;
    each rank's launches and sync bytes ``dist_fault_expected``'s, a
    query's ``exchange_bytes`` its layout's first sync; the failover plans
    on the survivors' ranks. Returns the per-rank times."""
    survivors = [r for r in range(DIST_RANKS) if r != DIST_OUTSIDE]
    failovers = [f"{kind}/{mode}" for kind, (_, modes)
                 in DIST_FAULT_KINDS.items() for mode in modes]
    out = {"survivor_ranks": survivors, "per_rank": []}
    for r, (arrays, records) in enumerate(ranks):
        calls = records["faults"]
        if [c["name"] for c in calls] != [c["name"] for c in folded]:
            raise AssertionError(f"faults rank {r}: calls "
                                 f"{[c['name'] for c in calls]}")
        for c, want in zip(calls, folded):
            name = c["name"]
            outs = (want["out"] if isinstance(want["out"], dict)
                    else {None: want["out"]})
            for key, w in outs.items():
                at = f"faults/{name}" + ("" if key is None else f"/{key}")
                if not np.array_equal(arrays[at], w):
                    raise AssertionError(f"faults rank {r} {at}: not "
                                         f"bitwise the folded run")
            exp = dist_fault_expected(name, wire, plans, bsp,
                                      r != DIST_OUTSIDE)
            if exp is None:
                continue
            launches, syncs = exp
            if c["launches"] != launches or c["sync_bytes"] != syncs:
                raise AssertionError(
                    f"faults rank {r} {name}: launched {c['launches']} and "
                    f"synced {c['sync_bytes']}, expected {launches} and "
                    f"{syncs}")
            if "exchange_bytes" in c:
                first = dist_fault_expected(name, wire, plans, bsp,
                                            True)[1][0]
                if c["exchange_bytes"] != first:
                    raise AssertionError(
                        f"faults rank {r} {name}: exchange_bytes "
                        f"{c['exchange_bytes']} != {first}")
        by = {c["name"]: c for c in calls}
        per = {"replay_s": by["replay/chaos"]["ms"] / 1e3}
        for key in failovers:
            # GAT serves one query after its failover: first and later.
            first = by.get(key + "/first_execute", by[key + "/query"])
            serve = by.get(key + "/execute", by[key + "/query"])
            per[key] = {"fail_nodes_ms": by[key + "/fail_nodes"]["ms"],
                        "first_serve_ms": first["ms"],
                        "serve_ms": serve["ms"],
                        "all_gather_ms_a_sync": serve["sync_ms"]}
        out["per_rank"].append(per)
    by = {c["name"]: c for c in folded}
    for key in failovers:
        got = by[key + "/fail_nodes"]["out"].tolist()
        if got != survivors:
            raise AssertionError(f"{key}: fogs on ranks {got}, expected "
                                 f"{survivors}")
    out["folded"] = {"fail_nodes_ms": {
        key: by[key + "/fail_nodes"]["ms"] for key in failovers},
        "replay_s": by["replay/chaos"]["ms"] / 1e3}
    out["chaos_tags"] = sorted({t[0] for t in
                                by["replay/chaos"]["out"]["tags"]})
    out["sync_bytes"] = {c["name"]: c["sync_bytes"]
                         for c in ranks[0][1]["faults"]
                         if c["name"].endswith(("/before", "/query",
                                                "/batch"))}
    out["wire_bytes_outside"] = sum(
        sum(c["sync_bytes"]) for c in ranks[DIST_OUTSIDE][1]["faults"]
        if not c["name"].startswith(("replay/", "update"))
        and not c["name"].endswith(("/before", "/restored")))
    log("  faults bytes a sync (rank 0): " + "; ".join(
        f"{k} {v}" for k, v in out["sync_bytes"].items()
        if "batch" not in k and not k.startswith("update"))
        + f"; rank {DIST_OUTSIDE} on the survivors' calls "
        f"{out['wire_bytes_outside']}")
    for r, per in enumerate(out["per_rank"]):
        log(f"  faults rank {r}" + (" (outside the survivors)"
                                    if r == DIST_OUTSIDE else "") + ": "
            + "; ".join(
                f"{key} fail_nodes {v['fail_nodes_ms']:.1f} ms, first "
                f"serve {v['first_serve_ms']:.1f}, then "
                f"{v['serve_ms']:.1f} (all_gather "
                + (" / ".join(f"{x:.2f}" for x in v["all_gather_ms_a_sync"])
                   or "none") + " ms a sync)"
                for key, v in per.items() if key != "replay_s")
            + f"; chaos replay {per['replay_s']:.2f} s")
    f = out["folded"]
    log("  faults folded: fail_nodes " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in f["fail_nodes_ms"].items())
        + f"; chaos replay {f['replay_s']:.2f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import analysis, api
    from repro_torch.api import Engine
    from repro_torch.configs import registry
    from repro_torch.core import compression, frontier
    from repro_torch.gnn import datasets, layers, models
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import daq_dequant as dq
    from repro_torch.kernels import edge_softmax as es
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.kernels import recurrence as rc
    from repro_torch.kernels import segment_sum as sg
    from repro_torch.kernels import stage_rows as sr
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
    # What the scans issue: their longest straight-line blocks.
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path("recurrence"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    for kernel in ("selective_scan_kernel", "rglru_scan_kernel",
                   "rglru_short_kernel", "selective_scan_bwd_kernel",
                   "rglru_scan_bwd_kernel"):
        total, (block, exps), (eblock, eexps) = sass_blocks(sass, kernel)
        log(f"  {kernel} SASS: {total} instructions; longest straight-line "
            f"block {block} ({exps} MUFU.EX2), longest with an exp {eblock} "
            f"({eexps} MUFU.EX2)")

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
    gat_pg, gat_layout_s = gat_mesh_layout(datasets, bsp)
    log(f"  GAT-shaped mesh layout: RMAT-40k, P={gat_pg.slots} slots "
        f"({gat_layout_s:.2f} s)")
    staging = stage_rows_cases(sr, ref, bsp, [
        ("gat-rmat40k", gat_pg, 32), ("gcn-siot", pg, g.feature_dim)])
    headed = headed_sum_cases(sg, ref, bsp, gat_pg)
    softmax = edge_softmax_cases(es, sg, ref, bsp, gat_pg)
    del gat_pg
    n_rows, blocks_sim, blocks_mesh = subset_blocks(g, pg, local.out_rows,
                                                    frontier)
    log(f"  row subsets: the layer-1 frontier of {SUBSET_SENSORS} leaf "
        f"sensors, {n_rows} rows: {len(blocks_sim)} of {vb} sim blocks, "
        f"{len(blocks_mesh)} of {local.rows.tiles[0]} mesh blocks")
    for name, recs in subset_cases(ga, dq, ref, bsp, csr, local, halo,
                                   pg.n * pg.boundary_slots, blocks_sim,
                                   blocks_mesh).items():
        results[name]["subset_cases"] = recs
    del local, halo
    pems = layers.EdgeList.from_graph(
        datasets.load_pems_window(1.0, seed=0).graph, device="cuda")
    results.update(segment_cases(sg, ref, layers, bsp, g, pg, pems))
    results["segment_sum"]["headed_cases"] = headed
    results["edge_softmax"] = {"cases": softmax}
    results["segment_sum"]["cases"] += segment_backward_cases(
        sg, ref, layers, g, pems)
    del pems
    tables = dequant_tables(g, compression, datasets)
    results.update(dequant_kernel_cases(dq, ref, tables))
    results.update(flash_cases(fa, ref))
    results.update(recurrence_cases(rc, ref))
    bwd_cases = recurrence_bwd_cases(rc, ref)
    results.update(bwd_cases)

    wrappers = {"block_spmm": ga.block_spmm,
                "block_spmm_batched": ga.block_spmm_batched,
                "dequant_spmm": dq.dequant_spmm,
                "dequant_spmm_batched": dq.dequant_spmm_batched,
                "dequant": dq.dequant,
                "flash_attention": fa.flash_attention,
                "segment_sum": sg.segment_sum,
                "edge_softmax": es.edge_softmax,
                "selective_scan": rc.selective_scan,
                "rglru_scan": rc.rglru_scan}
    wrappers["selective_scan_bwd"] = BackwardCount(rc.selective_scan)
    wrappers["rglru_scan_bwd"] = BackwardCount(rc.rglru_scan)
    kernels = [wrappers[n] for n in REPLACES]
    launches, backward = {}, {}
    # The staging gather's launches by path: on every driven path, one a
    # batched mesh call and none elsewhere.
    batched, staged = StagedCalls(bsp), {}

    def zero():
        for kern in kernels:
            kern.launches = 0
        sg.segment_sum.backward_launches = 0
        sr.stage_rows.launches = batched.calls = 0

    def check_staged(path, n, calls):
        if n != calls:
            raise AssertionError(f"{path}: {n} stage_rows launches for "
                                 f"{calls} batched mesh calls")
        staged[path] = n

    def read():
        return ({n: kern.launches for n, kern in zip(REPLACES, kernels)},
                sg.segment_sum.backward_launches)

    def record(path, counts, bwd):
        """Each kernel of the path must have launched, and the segment
        sum's backward exactly where the path takes gradients."""
        for name in PATH_KERNELS[path]:
            if counts[name] == 0:
                raise AssertionError(f"{name} was never launched on the "
                                     f"{path} path")
        if (bwd > 0) != (path in BACKWARD_PATHS):
            raise AssertionError(f"{bwd} backward segment sums on the "
                                 f"{path} path")
        launches[path], backward[path] = counts, bwd
        log(f"  launches on the {path} path: {counts}"
            + (f" ({bwd} segment-sum backward)" if bwd else ""))

    def drive_each(path, runs):
        """Drive one path as several runs, every count set to 0 just before
        each run and read just after; the path's counts are their sums.
        Returns each run's output and counts."""
        outs, per_run = [], []
        total, total_bwd = dict.fromkeys(REPLACES, 0), 0
        n_staged = n_batched = 0
        for run in runs:
            zero()
            outs.append(run())
            n_staged += sr.stage_rows.launches
            n_batched += batched.calls
            counts, bwd = read()
            per_run.append(counts)
            total_bwd += bwd
            for name in total:
                total[name] += counts[name]
        check_staged(path, n_staged, n_batched)
        record(path, total, total_bwd)
        return outs, per_run

    def drive(path, fn):
        """Drive one path with every count set to 0 just before it, read
        just after; each kernel of the path must have launched."""
        zero()
        out = fn()
        check_staged(path, sr.stage_rows.launches, batched.calls)
        record(path, *read())
        return out

    log("phase 3: main path (single program)")
    served = drive("sim", lambda: [serve(Engine, models, g, kind, ga)
                                   for kind in ("gcn", "sage")])
    seg_sim = drive("sim-segment", lambda: [
        segment_gates(Engine, models, g, kind, "sim", sg, es)
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
        segment_gates(Engine, models, g, kind, "mesh-bsp", sg, es)
        for kind in SEGMENT_KINDS])
    del gcn_mesh, pg
    for path in ("mesh", "mesh-segment"):
        if not staged[path]:
            raise AssertionError(f"stage_rows was never launched on the "
                                 f"{path} path")
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

    log(f"phase 3l: mesh-bsp over torch.distributed ({DIST_RANKS} gloo "
        f"ranks on the card, one a fog; the times are gloo's host-staged "
        f"wire on one card)")
    dist_rec, dist_counts, fault_counts = dist_path(Engine, models, g, bsp,
                                                    wrappers)
    record("mesh-dist", dist_counts, 0)
    record("mesh-dist-faults", fault_counts, 0)
    log(f"  phase 3l: {dist_rec['phase_s']:.1f} s (spawn and ranks "
        f"{dist_rec['spawn_s']:.1f} s, the faults part's folded run "
        f"{dist_rec['faults']['folded_s']:.1f} s; the host's available "
        f"memory fell to {dist_rec['host_gib_available_low']:.1f} GiB "
        f"while the ranks ran) on {card()}")

    log("phase 3c: dequantize path (ops.dequantize_features)")
    dequantized = drive("dequantize",
                        lambda: dequantize_path(ops, ref, tables))

    log("phase 3f: server paths (Server.replay: micro-batches, the SLO "
        "ladder, graph updates)")
    t_server = time.perf_counter()
    served_requests = server_paths(Engine, models, g, api, bsp, ops,
                                   drive_each)
    served_requests["phase_s"] = time.perf_counter() - t_server
    log(f"  phase 3f: {served_requests['phase_s']:.1f} s")

    log("phase 3g: frontier queries, stale halos, the fleet")
    t_3g = time.perf_counter()
    frontiers, stream = frontier_paths(Engine, models, g, drive_each, ga, dq)
    staled = stale_path(Engine, models, g, bsp, api, drive_each, stream)
    fleet, fleet_obj = fleet_path(Engine, models, g, api, drive_each)
    phase_3g_s = time.perf_counter() - t_3g
    log(f"  phase 3g: {phase_3g_s:.1f} s")

    log("phase 3h: failover, recovery tiers, the static verifier")
    t_3h = time.perf_counter()
    t0 = time.perf_counter()
    plans = fault_plans(Engine, models, g)
    fault_rec = {"compile_s": {f"{k}/{ex}": c
                               for (k, ex), (_, c) in plans.items()},
                 "plans_compile_s": time.perf_counter() - t0}
    fault_rec["failover"] = failover_path(Engine, models, g, analysis, api,
                                          plans, drive_each)
    fault_rec["chaos_mesh"] = chaos_mesh(Engine, api, bsp, ops, plans,
                                         drive_each, wrappers)
    fault_rec["chaos_property"] = chaos_property(api, bsp, ops, plans,
                                                 drive_each, wrappers)
    fault_rec["recover_after_update"] = recover_after_update(
        Engine, api, bsp, plans, drive_each, wrappers)
    fault_rec["fleet"] = fleet_faults(api, fleet_obj, drive_each)
    fault_rec["verifier"] = verifier_path(analysis, plans)
    del plans, fleet_obj
    fault_rec["phase_s"] = time.perf_counter() - t_3h
    log(f"  phase 3h: {fault_rec['phase_s']:.1f} s")

    log("phase 3i: training and the case study")
    trained = train_path(models, layers, datasets, ref, sg, Engine, g,
                         drive, drive_each)
    log(f"  phase 3i: {trained['phase_s']:.1f} s (demo "
        f"{trained['demo_s']:.1f} s)")
    subset_launches = {
        path: {name: sum(r["launches_subset"][name] for rec in recs
                         for r in rec["runs"])
               for name in SUBSET_KERNELS}
        for path, recs in frontiers.items()}
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

    log("phase 3j: the non-dense decoders at full width (Mamba, RG-LRU with "
        "local attention, MLA + MoE), the int8 KV cache")
    t_3j = time.perf_counter()
    nondense = {"models": nondense_paths(sv, tf, registry, drive, launches),
                "quant_kv_cache": quant_decode(tf, registry),
                "reduced_serve": [
                    small_serve_reference(sv, tf, registry, arch)
                    for arch in ("deepseek-v3-671b", "falcon-mamba-7b",
                                 "grok-1-314b", "recurrentgemma-9b")]}
    nondense["phase_s"] = time.perf_counter() - t_3j
    log(f"  phase 3j: {nondense['phase_s']:.1f} s")

    log("phase 3k: transformer training at full width (the scans' backward "
        "kernels, remat, micro-batches, AdamW, checkpoints, launch.train)")
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.data import pipeline
    from repro_torch.models import ssm
    from repro_torch.optim import adamw
    lm_trained = lm_train_paths(tf, registry, adamw, ckpt, pipeline, ref,
                                ssm, drive, launches, bwd_cases)
    log(f"  phase 3k: {lm_trained['phase_s']:.1f} s")

    kernel_rows = []
    for name, rec in results.items():
        main_cases = [c for c in rec["cases"] if c["path"] == ROW_PATH[name]]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            **({"subset_launches_by_path": {
                p: c[name] for p, c in subset_launches.items()}}
               if name in SUBSET_KERNELS else {}),
            **({"backward_launches_by_path": {
                p: n for p, n in backward.items() if n}}
               if name == "segment_sum" else {}),
            "max_abs_err": max(c["max_abs_err"] for c in rec["cases"]),
            "ms": sum(c["ms"] for c in main_cases),
            "plain_ms": sum(c["plain_ms"] for c in main_cases),
            "bound_ms": sum(c["bound_ms"] for c in main_cases),
            "bound_by": main_cases[-1]["bound_by"],
            "library_ms": None if any(c["library_ms"] is None
                                      for c in main_cases)
            else sum(c["library_ms"] for c in main_cases),
            **{k: v for k, v in rec.items() if k != "cases"},
            "cases": rec["cases"]})
    stage_cases = staging["stage_rows"]["cases"]
    kernel_rows.append({
        "name": "stage_rows", "route": "cuda",
        "source": CSRC + "stage_rows.cu",
        "replaces": "not a TPU kernel: the host scatter of "
                    "PartitionedGraph.feature_stack on the batched mesh "
                    "path (src/repro/runtime/bsp.py)",
        "launches": sum(staged.values()),
        "launches_by_path": {p: n for p, n in staged.items() if n},
        "max_abs_err": 0.0,
        **{k: {c["layout"]: c[k] for c in stage_cases if c["path"] == "mesh"}
           for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                     "replaced_host_ms", "roofline_pct")},
        "bound_by": "bytes", "cases": stage_cases})
    print(json.dumps({"fault_path": fault_rec}), flush=True)
    print(json.dumps({"compaction": compaction,
                      "main_path": served, "mesh_path": meshed,
                      "mesh_dist_path": dist_rec,
                      "segment_sum_path": {"sim": seg_sim,
                                           "mesh": seg_mesh},
                      "dequantize_path": dequantized,
                      "server_path": served_requests,
                      "frontier_path": frontiers, "stale_path": staled,
                      "fleet_path": fleet, "phase_3g_s": phase_3g_s,
                      "serve_path": served_lm, "prefill_path": prefilled,
                      "reduced_serve": reduced}), flush=True)
    print(json.dumps({"train_path": trained}), flush=True)
    print(json.dumps({"nondense_path": nondense}), flush=True)
    print(json.dumps({"lm_train_path": lm_trained}), flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
