"""Executor backends: where a query's numerics actually run.

Every backend computes real embeddings with PyTorch on the plan's device;
they differ in which simulated pipeline prices the query's latency:

  "sim"       single-program numerics, multi-fog BSP latency accounting.
  "single"    single-program numerics, single-most-powerful-fog accounting
              (the paper's single-fog baseline).
  "mesh-bsp"  the paper's distributed BSP runtime (§III-E): one shard per
              fog partition, a halo/allgather exchange per layer, the
              shards folded onto the plan's one device
              (``runtime.bsp``); multi-fog accounting.
  "cloud"     single-program numerics, de-facto cloud accounting (full
              WAN upload to a datacenter GPU) — the paper's Fig. 3
              cloud-vs-fog baseline.

Every backend honours the Engine/Session ``aggregation`` knob
("segment_sum" | "pallas" | "auto"): the single-program kernel path swaps
the model's neighborhood aggregation for the whole-graph block-CSR SpMM
kernels; the mesh backend routes each shard's aggregation through the
pre-blocked local + halo SpMM (and, with a DAQ compressor, ships the halo
quantized and aggregates it with the fused ``dequant_spmm`` kernel).
``resolve_aggregation`` in ``runtime.bsp`` defines the fallback/strictness
rules.

Micro-batches (``run_many``) run the kernel path with one batched launch
per layer and operand for the whole [B, V, F] stack and the dense tail
example by example; the segment-sum path runs the serial forward per
example. Either way each batched result is bitwise equal to the serial
``run`` on the same features.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np
import torch

from repro_torch.api.registry import EXECUTORS
from repro_torch.gnn.layers import EdgeList, apply_layer_with_sum
from repro_torch.gnn.models import gnn_apply
from repro_torch.kernels import ops
from repro_torch.runtime import bsp


def _as_stack(feats: Union[np.ndarray, Sequence[np.ndarray]]) -> np.ndarray:
    """Coerce a micro-batch (list of [V, F] arrays or an already stacked
    [B, V, F] array) to one stacked float32 array."""
    if isinstance(feats, np.ndarray) and feats.ndim == 3:
        return np.asarray(feats, np.float32)
    return np.stack([np.asarray(f, np.float32) for f in feats])


@dataclasses.dataclass(frozen=True)
class ExecutorBackend:
    """Base entry for the EXECUTORS registry.

    ``pipeline`` names the ``simulation.simulate`` accounting pipeline
    ("multi", "single" or "cloud"); ``run`` returns [V, D] float32
    embeddings (numpy) in original vertex order. ``aggregation`` is the
    Engine/Session knob (see ``bsp.resolve_aggregation``).
    """
    name: str
    pipeline: str

    #: True for backends whose kernel path reads the per-shard block-CSR
    #: operands of the PartitionedGraph (built on demand).
    needs_block_shards = False

    def check(self, plan) -> None:
        """Fail fast (helpful error) if this backend cannot run the plan."""

    def wire_format(self, plan, exchange: str, aggregation: str):
        """(dtype_bytes, row_overhead_bytes) of the per-sync halo payload."""
        return (4, 0)

    def run(self, plan, feats: np.ndarray, assignment: np.ndarray,
            pg: bsp.PartitionedGraph, exchange: str,
            aggregation: str = "segment_sum") -> np.ndarray:
        raise NotImplementedError

    def run_many(self, plan,
                 feats: Union[np.ndarray, Sequence[np.ndarray]],
                 assignment: np.ndarray, pg: bsp.PartitionedGraph,
                 exchange: str,
                 aggregation: str = "segment_sum") -> List[np.ndarray]:
        """One executor run over a micro-batch of feature sets.

        ``feats`` is either a stacked [B, V, F] array or a sequence of
        [V, F] arrays. The base implementation serves each set through
        ``run`` back-to-back.
        """
        return [self.run(plan, f, assignment, pg, exchange,
                         aggregation=aggregation)
                for f in _as_stack(feats)]


def _kernel_gnn_apply(params, kind: str, h: torch.Tensor, edges: EdgeList,
                      csr: ops.BlockCsr) -> torch.Tensor:
    """K-layer forward with block-CSR kernel aggregation, single or stacked.

    ``h`` is one [V, F] feature table or a stacked [B, V, F] micro-batch.
    Per layer, the neighbor sum runs as ONE kernel launch —
    ``block_spmm`` for a single example, ``block_spmm_batched`` for a
    stack — and the dense layer update then runs per example, which keeps
    batched results bitwise equal to serial ones. GCN/SAGE only (GAT
    re-weights edges per layer and cannot be pre-blocked;
    ``resolve_aggregation`` rejects it upstream).
    """
    n = len(params)
    for i, p in enumerate(params):
        h = apply_layer_with_sum(kind, p, h, edges, csr.aggregate_traced(h),
                                 last=i == n - 1)
    return h


class _SingleProgram(ExecutorBackend):
    def _apply(self, plan, h: torch.Tensor,
               aggregation: str) -> torch.Tensor:
        """One forward for ``h`` = [V, F] or [B, V, F] on the plan's device."""
        # Single-program layout: no cross-fog exchange is involved, so the
        # kernel path only depends on the model kind and the device.
        mode = bsp.resolve_aggregation(aggregation, plan.model.kind,
                                       device=plan.device)
        params = list(plan.model.params)
        kind = plan.model.kind
        edges = plan.edges
        if mode == "pallas":
            csr = ops.block_csr_for(plan.graph, device=plan.device)
            return _kernel_gnn_apply(params, kind, h, edges, csr)
        if h.ndim == 3:
            return torch.stack([gnn_apply(params, kind, hh, edges)
                                for hh in h])
        return gnn_apply(params, kind, h, edges)

    def _forward(self, plan, feats: np.ndarray,
                 aggregation: str) -> np.ndarray:
        h = torch.tensor(np.asarray(feats, np.float32), device=plan.device)
        with torch.no_grad():
            return self._apply(plan, h, aggregation).cpu().numpy()

    def run(self, plan, feats, assignment, pg, exchange,
            aggregation="segment_sum"):
        return self._forward(plan, feats, aggregation)

    def run_many(self, plan, feats, assignment, pg, exchange,
                 aggregation="segment_sum"):
        """Batched path: one forward over the stacked micro-batch (one
        batched kernel launch per layer on the kernel path). Singleton
        batches take the serial path."""
        stacked = _as_stack(feats)
        if stacked.shape[0] <= 1:
            return super().run_many(plan, stacked, assignment, pg,
                                    exchange, aggregation=aggregation)
        return list(self._forward(plan, stacked, aggregation))


class _MeshBsp(ExecutorBackend):
    #: this backend aggregates over PartitionedGraph.local_csr/halo_csr
    #: when the kernel path is active (Engine/Session build them lazily).
    needs_block_shards = True

    def check(self, plan) -> None:
        """The shards share the plan's one device, which must exist."""
        dev = plan.device
        if dev.type not in ("cuda", "cpu"):
            raise RuntimeError(f"executor 'mesh-bsp' runs on a cuda or cpu "
                               f"device, not {dev}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"executor 'mesh-bsp' needs the plan's device "
                               f"{dev}, but torch.cuda.is_available() is "
                               f"False")

    @staticmethod
    def _halo_quant(plan, exchange: str, aggregation: str) -> bool:
        """DAQ plans fuse wire dequantization into the halo SpMM (kernel
        path only): boundary rows cross the exchange quantized."""
        return (bsp.resolve_aggregation(aggregation, plan.model.kind,
                                        exchange=exchange,
                                        device=plan.device) == "pallas"
                and plan.config.compressor.startswith("daq"))

    def wire_format(self, plan, exchange, aggregation):
        if self._halo_quant(plan, exchange, aggregation):
            return (1, 8)   # uint8 codes + f32 (scale, min) per row
        return (4, 0)

    def run(self, plan, feats, assignment, pg, exchange,
            aggregation="segment_sum"):
        g = dataclasses.replace(plan.graph, features=feats)
        with torch.no_grad():
            return bsp.bsp_infer(
                list(plan.model.params), plan.model.kind, g, assignment,
                device=plan.device, exchange=exchange,
                aggregation=aggregation,
                halo_quant=self._halo_quant(plan, exchange, aggregation),
                pg=pg)

    def run_many(self, plan, feats, assignment, pg, exchange,
                 aggregation="segment_sum"):
        """One batched run for the whole micro-batch: the stacked
        [B, V, F] features become one folded [B, n*P, F] stack and each
        layer's exchange ships every example's boundary rows at once (see
        ``bsp.bsp_apply_many``). Bitwise the serial per-request loop;
        singleton batches take the serial path.
        """
        stacked = _as_stack(feats)
        if stacked.shape[0] <= 1:
            return super().run_many(plan, stacked, assignment, pg,
                                    exchange, aggregation=aggregation)
        with torch.no_grad():
            out = bsp.bsp_infer_many(
                list(plan.model.params), plan.model.kind, stacked, pg,
                device=plan.device, exchange=exchange,
                aggregation=aggregation,
                halo_quant=self._halo_quant(plan, exchange, aggregation))
        return list(out)

    def run_layers(self, *args, **kwargs):
        raise NotImplementedError("mesh-bsp layer capture and frontier "
                                  "runs are not ported yet: ROADMAP Queue 1 "
                                  "item 9, incremental frontier queries")

    run_frontier = run_layers

    def run_stale(self, *args, **kwargs):
        raise NotImplementedError("mesh-bsp run_stale is not ported yet: "
                                  "ROADMAP Queue 1 item 10, fleet and stale "
                                  "halos")


EXECUTORS.register("sim", _SingleProgram("sim", "multi"))
EXECUTORS.register("single", _SingleProgram("single", "single"))
EXECUTORS.register("cloud", _SingleProgram("cloud", "cloud"))
EXECUTORS.register("mesh-bsp", _MeshBsp("mesh-bsp", "multi"))
