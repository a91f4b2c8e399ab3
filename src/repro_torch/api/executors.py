"""Executor backends: where a query's numerics actually run.

Every backend computes real embeddings with PyTorch on the plan's device;
they differ in which simulated pipeline prices the query's latency:

  "sim"       single-program numerics, multi-fog BSP latency accounting.
  "single"    single-program numerics, single-most-powerful-fog accounting
              (the paper's single-fog baseline).
  "mesh-bsp"  the paper's distributed BSP runtime (§III-E): one shard per
              fog partition, a halo/allgather exchange per layer
              (``runtime.bsp``); multi-fog accounting. In a process whose
              default ``torch.distributed`` group is initialized, fog
              ``p`` runs on world rank ``plan.fog_ranks[p]`` (rank ``p``
              for a compile, whose fog count must be the world's; a
              failover plan's survivors keep their ranks) on the plan's
              device and the exchange crosses the group of those ranks;
              a rank outside it receives the result. Otherwise the shards
              fold onto the plan's one device.
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
per layer and operand for the whole [B, V, F] stack; every layer's dense
work, and on the segment-sum path its aggregation too, runs example by
example (``gnn.layers.apply_layer``). Either way each batched result is
bitwise equal to the serial ``run`` on the same features.

Incremental frontier queries (``run_layers`` / ``run_frontier``, driven by
``Session(activation_cache=True)``): a capturing pass returns every
layer's table, and a frontier pass recomputes only each layer's dirty rows
(``core.frontier``) and merges them into the cached tables with
``torch.where``, bitwise a full pass. On the kernel path each layer
launches the block kernels once per operand over a row subset of the
compacted operand (``gather_aggregate.row_subset``: the dirty rows'
128-row blocks); on the segment-sum path the edges into clean rows are
masked out. The dense tail runs at the full pass's shape, so cuBLAS picks
the full pass's algorithm and every row keeps its bits.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.registry import EXECUTORS
from repro_torch.gnn.layers import apply_layer
from repro_torch.kernels import ops
from repro_torch.kernels.gather_aggregate import BLOCK, row_subset
from repro_torch.runtime import bsp
from repro_torch.runtime import dist as fog_dist

#: model kinds the incremental frontier path supports: the kinds of the
#: kernel path, whose aggregation is a static sum (``bsp.KERNEL_KINDS``).
FRONTIER_KINDS = bsp.KERNEL_KINDS


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

    # -- incremental (frontier) execution ------------------------------------

    #: numerics family tag for the activation cache: values cached under
    #: one family must not be merged into another's recompute ("single"
    #: covers sim/single/cloud, which share one program).
    frontier_family = "single"

    def supports_frontier(self, plan, aggregation: str) -> bool:
        """Whether ``run_frontier``/``run_layers`` exist for this plan."""
        return False

    def run_layers(self, plan, feats, assignment, pg, exchange,
                   aggregation: str = "segment_sum") -> List[np.ndarray]:
        """Full pass that also returns every layer's activations.

        ``feats`` is [V, F] (returns K arrays [V, F_l]) or a stacked
        [B, V, F] micro-batch (returns K arrays [B, V, F_l]); the last
        entry is the plain ``run``/``run_many`` output, bit for bit.
        """
        raise NotImplementedError

    def run_frontier(self, plan, feats, assignment, pg, exchange,
                     aggregation, rows_per_layer, cached_layers):
        """Incremental pass: recompute only ``rows_per_layer[l]`` per
        layer and merge into ``cached_layers``. Returns ``(embeddings,
        merged_layers)`` where embeddings is [V, D] (or a list of [V, D]
        for a stacked ``feats``) bitwise a full recompute, and
        merged_layers is the new cache state.
        """
        raise NotImplementedError

    # -- stale-tolerant halo serving (exchange="halo_async") -----------------

    def supports_stale_halo(self, plan, aggregation: str) -> bool:
        """Whether this backend can replay recorded halo tables
        (``run_stale``/``run_stale_many``). Only the mesh backend has a
        real exchange to skip; single-program backends serve stale
        requests through their ordinary path (the Session still does the
        version/staleness accounting)."""
        return False

    def run_stale(self, plan, feats, assignment, pg,
                  halo_tables, aggregation: str = "segment_sum"):
        """Serve one query replaying ``halo_tables`` (the per-layer
        boundary-row tables of an earlier fresh pass) instead of running
        the per-layer exchange. Local rows use the CURRENT ``feats``;
        only cross-partition reads are stale."""
        raise NotImplementedError

    def run_stale_many(self, plan, feats, assignment, pg,
                       halo_tables, aggregation: str = "segment_sum"):
        raise NotImplementedError


class _SingleProgram(ExecutorBackend):
    def _layers(self, plan, feats: np.ndarray, aggregation: str,
                rows_per_layer=None, cached_layers=None
                ) -> List[torch.Tensor]:
        """Every layer's output of one forward for ``feats`` = [V, F] or
        [B, V, F], on the plan's device.

        Per layer the neighbour sums come from one launch of the
        whole-graph block kernels over the stack (kernel path), or the
        layer aggregates over ``plan.edges`` for itself; then the one
        layer step. A frontier pass (``rows_per_layer``, merged into
        ``cached_layers``) recomputes only each layer's dirty rows: on the
        kernel path one launch over the row subset of the dirty rows'
        128-row blocks (every row of such a block is recomputed and
        merged; its operands are the full pass's, so its value is too), on
        the segment path the edges into clean rows masked out. The dense
        tail runs at the full table's shape, then a ``torch.where`` merge
        into the cached table.
        """
        # Single-program layout: no cross-fog exchange is involved, so the
        # kernel path only depends on the model kind and the device.
        mode = bsp.resolve_aggregation(aggregation, plan.model.kind,
                                       device=plan.device)
        kind, dev = plan.model.kind, plan.device
        params = list(plan.model.params)
        v = plan.graph.num_vertices
        h = torch.tensor(np.asarray(feats, np.float32), device=dev)
        csr = (ops.block_csr_for(plan.graph, device=dev)
               if mode == "pallas" else None)
        outs = []
        for i, p in enumerate(params):
            edges, subset, mask = plan.edges, None, None
            if rows_per_layer is not None:
                rows = np.asarray(rows_per_layer[i], np.int64)
                if csr is not None:
                    subset = row_subset(csr.rows, np.unique(rows // BLOCK))
                    mask = subset.row_mask()[:v]
                else:
                    mask = torch.zeros(v, dtype=torch.bool, device=dev)
                    mask[torch.as_tensor(rows, device=dev)] = True
                    edges = edges.into(mask)
            kw = ({} if csr is None
                  else {"a_sum": csr.aggregate_traced(h, subset=subset)})
            h = apply_layer(kind, p, h, edges, last=i == len(params) - 1,
                            **kw)
            if mask is not None:
                cached = torch.as_tensor(
                    np.asarray(cached_layers[i], np.float32), device=dev)
                # A select, never a blend: clean rows keep the cached
                # bits, -0.0 included.
                h = torch.where(mask[:, None], h, cached)
            outs.append(h)
        return outs

    def _forward(self, plan, feats: np.ndarray,
                 aggregation: str) -> np.ndarray:
        with torch.no_grad():
            return self._layers(plan, feats, aggregation)[-1].cpu().numpy()

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

    def supports_frontier(self, plan, aggregation):
        return plan.model.kind in FRONTIER_KINDS

    def run_layers(self, plan, feats, assignment, pg, exchange,
                   aggregation="segment_sum"):
        with torch.no_grad():
            return [o.cpu().numpy()
                    for o in self._layers(plan, feats, aggregation)]

    def run_frontier(self, plan, feats, assignment, pg, exchange,
                     aggregation, rows_per_layer, cached_layers):
        """The frontier pass of ``_layers``: only ``rows_per_layer[l]``
        recomputed a layer, merged into ``cached_layers``."""
        with torch.no_grad():
            merged = [o.cpu().numpy() for o in self._layers(
                plan, feats, aggregation, rows_per_layer, cached_layers)]
        emb = merged[-1]
        if emb.ndim == 3:
            return list(emb), merged
        return emb, merged


class _MeshBsp(ExecutorBackend):
    #: this backend aggregates over PartitionedGraph.local_csr/halo_csr
    #: when the kernel path is active (Engine/Session build them lazily).
    needs_block_shards = True

    @staticmethod
    def _ranks(plan):
        """The world rank of each of the plan's fogs: its ``fog_ranks``, or
        one rank a fog of a world of the plan's fog count."""
        if plan.fog_ranks is not None:
            return plan.fog_ranks
        n, have = plan.num_fogs, dist.get_world_size()
        if have != n:
            raise RuntimeError(
                f"executor 'mesh-bsp' needs {n} ranks (one per fog "
                f"partition), the process group has {have} — start "
                f"{n} ranks, or serve without a process group to fold "
                f"the shards onto one device")
        return range(n)

    def group(self, plan=None):
        """With the default process group initialized, the group of the
        plan's fogs (``runtime.dist.FogGroup``; the whole world without a
        plan), the counterpart of the reference's ``jax.devices()[:n]``;
        else None (the shards fold onto the plan's device). Making a group
        is collective over the world: ``check`` makes the plan's where
        every rank binds it."""
        if not (dist.is_available() and dist.is_initialized()):
            return None
        if plan is None:
            return fog_dist.group_of(range(dist.get_world_size()))
        return fog_dist.group_of(self._ranks(plan))

    def check(self, plan) -> None:
        """The plan's device must exist; with a process group, one rank
        a fog (the plan's ``fog_ranks``), whose group every rank makes
        here."""
        dev = plan.device
        if dev.type not in ("cuda", "cpu"):
            raise RuntimeError(f"executor 'mesh-bsp' runs on a cuda or cpu "
                               f"device, not {dev}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"executor 'mesh-bsp' needs the plan's device "
                               f"{dev}, but torch.cuda.is_available() is "
                               f"False")
        self.group(plan)

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
                pg=pg, group=self.group(plan))

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
                halo_quant=self._halo_quant(plan, exchange, aggregation),
                group=self.group(plan))
        return list(out)

    #: mesh numerics (per-shard layouts, halo accumulation order) differ
    #: from the single program's in the last float bits, so cached layers
    #: are tagged with a distinct family and never cross-merged.
    frontier_family = "mesh"

    def supports_frontier(self, plan, aggregation):
        return plan.model.kind in FRONTIER_KINDS

    def run_layers(self, plan, feats, assignment, pg, exchange,
                   aggregation="segment_sum"):
        feats = np.asarray(feats, np.float32)
        hq = self._halo_quant(plan, exchange, aggregation)
        kw = dict(device=plan.device, exchange=exchange,
                  aggregation=aggregation, halo_quant=hq,
                  group=self.group(plan))
        with torch.no_grad():
            if feats.ndim == 3:
                return bsp.bsp_infer_capture_many(
                    list(plan.model.params), plan.model.kind, feats, pg,
                    **kw)
            g = dataclasses.replace(plan.graph, features=feats)
            return bsp.bsp_infer_capture(
                list(plan.model.params), plan.model.kind, g, assignment,
                pg=pg, **kw)

    def run_frontier(self, plan, feats, assignment, pg, exchange,
                     aggregation, rows_per_layer, cached_layers):
        feats = np.asarray(feats, np.float32)
        hq = self._halo_quant(plan, exchange, aggregation)
        kw = dict(device=plan.device, exchange=exchange,
                  aggregation=aggregation, halo_quant=hq,
                  group=self.group(plan))
        with torch.no_grad():
            if feats.ndim == 3:
                merged = bsp.bsp_infer_frontier_many(
                    list(plan.model.params), plan.model.kind, feats, pg,
                    rows_per_layer, cached_layers, **kw)
                return list(merged[-1]), merged
            merged = bsp.bsp_infer_frontier(
                list(plan.model.params), plan.model.kind, feats, pg,
                rows_per_layer, cached_layers, **kw)
        return merged[-1], merged

    def supports_stale_halo(self, plan, aggregation):
        return True

    def run_stale(self, plan, feats, assignment, pg, halo_tables,
                  aggregation="segment_sum"):
        """Replay recorded halo tables (no per-layer exchange; see
        ``bsp.bsp_infer_stale``)."""
        with torch.no_grad():
            return bsp.bsp_infer_stale(
                list(plan.model.params), plan.model.kind,
                np.asarray(feats, np.float32), pg, halo_tables,
                device=plan.device, aggregation=aggregation,
                group=self.group(plan))

    def run_stale_many(self, plan, feats, assignment, pg, halo_tables,
                       aggregation="segment_sum"):
        with torch.no_grad():
            out = bsp.bsp_infer_stale_many(
                list(plan.model.params), plan.model.kind, _as_stack(feats),
                pg, halo_tables, device=plan.device, aggregation=aggregation,
                group=self.group(plan))
        return list(out)


EXECUTORS.register("sim", _SingleProgram("sim", "multi"))
EXECUTORS.register("single", _SingleProgram("single", "single"))
EXECUTORS.register("cloud", _SingleProgram("cloud", "cloud"))
EXECUTORS.register("mesh-bsp", _MeshBsp("mesh-bsp", "multi"))
