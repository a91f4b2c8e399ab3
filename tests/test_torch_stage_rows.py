"""Staging a micro-batch on the card: ``runtime.bsp._local_stack`` ships
the caller's [B, V, F] stack (a rank's own rows of it) as it is and lays
it out in the folded slots with one ``kernels.stage_rows`` gather.

On the CPU (the gather's plain version) the staged [B, m*P, F] table is
bitwise the host form it replaces, ``feature_stack``'s numpy scatter cut
to the held shards and folded (``_gathered_stack``), for the folded
layout and every rank of a six-fog layout, with and without an empty
partition, at several batch sizes and widths (F = 7 takes the kernel's
scalar path on the card). Padded slots hold +0.0 (sign bit clear), and
-0.0 and NaN payloads of the caller's rows land bit for bit. On a CUDA
card the kernel is held bitwise to the plain version, one launch a
batched call.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.gnn.graph import Graph
from repro_torch.kernels import ref
from repro_torch.kernels import stage_rows as sr
from repro_torch.runtime import bsp

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

N = 6
V = 61
#: (name, assignment): every fog holds vertices; fog 3 holds none.
LAYOUTS = [("six", np.arange(V) % N),
           ("empty3", np.array([p if p != 3 else 4
                                for p in np.arange(V) % N]))]
BATCHES = (1, 3, 8)
WIDTHS = (32, 52, 7)
#: the folded run, then each rank of the six fogs.
HOLDERS = [None] + list(range(N))


def _layout(assignment, f: int) -> bsp.PartitionedGraph:
    rng = np.random.default_rng(0)
    senders = rng.integers(0, V, 240).astype(np.int32)
    receivers = rng.integers(0, V, 240).astype(np.int32)
    g = Graph(num_vertices=V, senders=senders, receivers=receivers,
              indptr=np.zeros(V + 1, np.int32),
              indices=np.zeros(0, np.int32),
              features=np.zeros((V, f), np.float32))
    return bsp.build_partitioned(g, assignment, build_blocks=False, n=N)


def _feats(b: int, f: int) -> np.ndarray:
    """A [B, V, F] stack with -0.0 and a NaN payload among its rows."""
    rng = np.random.default_rng(b * 100 + f)
    x = rng.normal(size=(b, V, f)).astype(np.float32)
    x[:, 5, 0] = -0.0
    x.view(np.int32)[:, 7, -1] = 0x7FC01234    # a NaN with a payload
    return x


def _fogs(rank):
    """Folded, or shard ``rank`` of N fogs (the group is only a tag for
    staging: nothing crosses a wire)."""
    return bsp._Fogs(N) if rank is None else bsp._Fogs(N, object(), rank)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: lay[0])
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("rank", HOLDERS,
                         ids=lambda r: "folded" if r is None else f"rank{r}")
def test_staged_stack_is_the_host_scatter_bitwise(layout, b, f, rank):
    pg = _layout(layout[1], f)
    fogs = _fogs(rank)
    feats = _feats(b, f)
    dev = torch.device("cpu")
    got = bsp._local_stack(pg, feats, fogs, dev)
    want = bsp._gathered_stack(torch.as_tensor(
        fogs.pick(pg.feature_stack(feats))))
    assert got.shape == want.shape == (b, fogs.m * pg.slots, f)
    assert torch.equal(_bits(got), _bits(want))
    # padded slots: +0.0, the sign bit clear
    pad = bsp._layout(pg, dev, fogs).row_src < 0
    assert int(pad.sum()) == fogs.m * pg.slots - (
        V if rank is None else int((pg.part_of == rank).sum()))
    assert bool((_bits(got)[:, pad] == 0).all())


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: lay[0])
@pytest.mark.parametrize("rank", HOLDERS + [-1],
                         ids=lambda r: "folded" if r is None else f"rank{r}")
def test_row_map_stages_each_held_vertex_once(layout, rank):
    """``row_src`` names every held vertex exactly once, at its slot; a
    rank outside the group (m = 0) stages nothing."""
    pg = _layout(layout[1], 4)
    fogs = _fogs(rank)
    lay = bsp._layout(pg, torch.device("cpu"), fogs)
    row_src = lay.row_src.numpy()
    assert row_src.dtype == np.int32 and row_src.shape == (
        fogs.m * pg.slots,)
    held = np.arange(V) if rank is None else lay.held
    if rank is not None:
        assert np.array_equal(held, np.flatnonzero(pg.part_of == rank))
    rows = np.flatnonzero(row_src >= 0)
    assert np.array_equal(np.sort(row_src[rows]), np.arange(len(held)))
    shard = 0 if rank is None else pg.part_of[held]
    assert np.array_equal(
        rows[np.argsort(row_src[rows])],
        (pg.part_of[held] - shard) * pg.slots + pg.slot_of[held])


@pytest.mark.parametrize("dv", [-1, 1], ids=["fewer", "more"])
@pytest.mark.parametrize("rank", [None, 2],
                         ids=lambda r: "folded" if r is None else f"rank{r}")
def test_a_stack_of_other_than_the_layouts_vertices_is_refused(dv, rank):
    """The gather reads the rows the layout's map names without a bounds
    check on the card, so a [B, V +- 1, F] stack is refused on the host,
    before anything is uploaded or launched."""
    pg = _layout(LAYOUTS[0][1], 4)
    feats = np.zeros((3, V + dv, 4), np.float32)
    before = sr.stage_rows.launches
    with pytest.raises(ValueError, match=rf"\[B, {V}, F\] stack"):
        bsp._local_stack(pg, feats, _fogs(rank), torch.device("cpu"))
    assert sr.stage_rows.launches == before


def test_plain_version_rejects_what_the_kernel_cannot_take():
    x = torch.zeros(2, 5, 4)
    idx = torch.tensor([0, -1, 4], dtype=torch.int32)
    assert torch.equal(sr.stage_rows(x, idx), ref.stage_rows_ref(x, idx))
    with pytest.raises(ValueError, match="B, S, F"):
        sr.stage_rows(x[0], idx)
    with pytest.raises(TypeError, match="float32"):
        sr.stage_rows(x.double(), idx)
    with pytest.raises(ValueError, match="int32"):
        sr.stage_rows(x, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        sr.stage_rows(x.transpose(1, 2), idx)
    before = sr.stage_rows.launches
    sr.stage_rows(x, idx)
    assert sr.stage_rows.launches == before   # the plain version: no launch


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [None, 2],
                         ids=lambda r: "folded" if r is None else f"rank{r}")
def test_kernel_is_the_plain_version_one_launch_a_batch(rank):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU path")
    dev = torch.device("cuda")
    for f in WIDTHS:
        pg = _layout(LAYOUTS[1][1], f)
        fogs = _fogs(rank)
        feats = _feats(8, f)
        before = sr.stage_rows.launches
        got = bsp._local_stack(pg, feats, fogs, dev)
        assert sr.stage_rows.launches == before + 1
        want = bsp._local_stack(pg, feats, fogs, torch.device("cpu"))
        assert torch.equal(_bits(got.cpu()), _bits(want))


def test_chip_smoke_stage_bound_is_pinned():
    """The yardstick of the gather's time on the card: ``chip_smoke.
    stage_bound`` counts the source stack once, the map once and the
    output once at the HBM rate, here at the GAT cell's layout (RMAT-40k
    on six fogs, P = 11,336)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ms, by = chip_smoke.stage_bound(8, 40_000, 6 * 11_336, 32)
    nbytes = 4 * (8 * (40_000 + 68_016) * 32 + 68_016)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
