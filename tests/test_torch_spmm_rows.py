"""The row-compacted operand of the port's f32 block-CSR kernels.

``compact_block_csr`` lists the nonzeros of an ELL-block-CSR operand's
tiles per output row (``TileRows``); the CUDA ``block_spmm`` /
``block_spmm_batched`` kernels read only that. These CPU tests hold the
operand to the tiles it is made from, its plain versions
(``ref.block_spmm_rows_ref`` and the batched form) to the JAX package's
Pallas kernel in interpret mode at rtol 1e-5 / atol 1e-4 (as
``tests/test_torch_kernels.py`` does, on its ``CASES``), and the executors
to building it once per layout. The kernels themselves are held to these
plain versions on the card by ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import Engine
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import models as tmodels
from repro_torch.kernels import gather_aggregate as tga
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.runtime import bsp as tbsp

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)
from test_torch_kernels import CASES, _case

RTOL, ATOL = 1e-5, 1e-4
FEATURES = [52, 64, 200]


def _rows(case):
    blocks, cols, mask = (torch.as_tensor(x) for x in _case(case, 52)[:3])
    return blocks, cols, mask, tga.compact_block_csr(blocks, cols, mask)


def _entries(rows):
    """(row, segment) of every entry, from the operand's pointers."""
    seg_of = torch.repeat_interleave(torch.arange(rows.n_seg),
                                     rows.seg_ptr.diff().long())
    row_of = torch.repeat_interleave(torch.arange(rows.n_rows),
                                     rows.row_ptr.diff().long())
    return row_of[seg_of], seg_of


@pytest.mark.parametrize("case", range(len(CASES)))
def test_compacted_entries_scatter_back_to_the_real_tiles(case):
    blocks, cols, mask, rows = _rows(case)
    vb, m = blocks.shape[:2]
    row, _ = _entries(rows)
    i, r = row // 128, row % 128
    col_block, k = rows.src.long() // 128, rows.src.long() % 128
    # The real slot of row-block i that reads column block col_block
    # (real slots of one row-block read distinct column blocks).
    slot = torch.full((vb, int(cols.max()) + 1), -1, dtype=torch.long)
    for ii, tt in zip(*torch.nonzero(mask != 0, as_tuple=True)):
        assert slot[ii, cols[ii, tt]] == -1
        slot[ii, cols[ii, tt]] = tt
    t = slot[i, col_block]
    assert (t >= 0).all()
    back = torch.zeros_like(blocks)
    back[i, t, r, k] = rows.val
    assert torch.equal(back, blocks * (mask != 0)[:, :, None, None])
    assert rows.nnz == int((back != 0).sum()) and rows.tiles == (vb, m)
    assert rows.max_src == int(rows.src.max())


@pytest.mark.parametrize("case", range(len(CASES)))
def test_segments_go_in_slot_order_and_entries_in_k_order(case):
    blocks, cols, mask, rows = _rows(case)
    row, seg = _entries(rows)
    # A segment is one (row, slot): one column block, weight = its mask.
    col_block = rows.src.long() // 128
    first = rows.seg_ptr[:-1].long()
    assert (rows.seg_ptr.diff() > 0).all()      # no empty segment
    assert torch.equal(col_block, col_block[first][seg])
    i = row[first] // 128
    slot_of = {(int(a), int(c)): int(t) for (a, t) in
               zip(*torch.nonzero(mask != 0, as_tuple=True))
               for c in [cols[a, t]]}
    slots = torch.tensor([slot_of[(int(a), int(c))]
                          for a, c in zip(i, col_block[first])])
    assert torch.equal(rows.seg_w, mask[i, slots])
    # Slot order within a row, k order within a segment.
    same_row = row[first][1:] == row[first][:-1]
    assert (slots[1:][same_row] > slots[:-1][same_row]).all()
    same_seg = seg[1:] == seg[:-1]
    assert (rows.src[1:][same_seg] > rows.src[:-1][same_seg]).all()
    # Every row is walked once: by a warp (rows of more than 32 entries
    # first, longest first) or by a CTA (more than 512 entries).
    counts = (rows.seg_ptr[rows.row_ptr[1:].long()]
              - rows.seg_ptr[rows.row_ptr[:-1].long()])
    walked = torch.cat([rows.warp_rows[:, 0], rows.split])
    assert torch.equal(walked.sort().values, torch.arange(rows.n_rows,
                                                         dtype=torch.int32))
    wr = rows.warp_rows.long()
    assert torch.equal(wr[:, 1], rows.row_ptr[wr[:, 0]].long())
    assert torch.equal(wr[:, 2], rows.seg_ptr[wr[:, 1]].long())
    assert torch.equal(wr[:, 3],
                       rows.seg_ptr[rows.row_ptr[wr[:, 0] + 1].long()].long())
    lead = counts[wr[:, 0]]
    n_long = int((lead > 32).sum())
    assert (lead[:n_long] > 32).all() and (lead[n_long:] <= 32).all()
    assert (lead[:n_long].diff() <= 0).all()
    assert (counts[rows.split.long()] > 512).all()


def test_long_rows_are_split_for_a_whole_cta():
    rng = np.random.default_rng(4)
    s = rng.integers(0, 20000, 3000).astype(np.int32)
    r = rng.integers(0, 200, 3000).astype(np.int32)
    s = np.concatenate([s, rng.integers(0, 20000, 900).astype(np.int32)])
    r = np.concatenate([r, np.full(900, 5, np.int32)])
    blocks, cols, mask, _ = tga.build_block_csr(s, r, 200)
    tb, tc, tm = (torch.as_tensor(x) for x in (blocks, cols, mask))
    rows = tga.compact_block_csr(tb, tc, tm)
    assert rows.split.tolist() == [5]
    assert rows.split_segs == int(rows.row_ptr[6] - rows.row_ptr[5]) > 32
    h = torch.as_tensor(rng.normal(size=(20096, 52)))
    np.testing.assert_allclose(
        tref.block_spmm_rows_ref(rows, h).numpy(),
        tref.block_spmm_ref(tb.double(), tc, tm.double(), h).numpy(),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("f", FEATURES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_rows_plain_version_matches_jax(case, f):
    blocks, cols, mask, pv, h, want = _case(case, f)
    rows = tga.compact_block_csr(*(torch.as_tensor(x)
                                   for x in (blocks, cols, mask)))
    th = torch.as_tensor(h)
    batched = tref.block_spmm_rows_batched_ref(rows, th).numpy()
    assert batched.shape == (3, pv, f)
    np.testing.assert_allclose(batched, want, rtol=RTOL, atol=ATOL)
    serial = tref.block_spmm_rows_ref(rows, th[0]).numpy()
    np.testing.assert_allclose(serial, want[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("f", FEATURES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_rows_plain_version_batched_is_serial(case, f):
    blocks, cols, mask, pv, h, _ = _case(case, f)
    rows = tga.compact_block_csr(*(torch.as_tensor(x)
                                   for x in (blocks, cols, mask)))
    th = torch.as_tensor(h)
    batched = tref.block_spmm_rows_batched_ref(rows, th)
    for b in range(len(th)):
        assert torch.equal(batched[b], tref.block_spmm_rows_ref(rows, th[b]))
    # In float64 the rows plain version is the dense one.
    dense = tref.block_spmm_batched_ref(
        *(torch.as_tensor(x).double() if x.dtype == np.float32
          else torch.as_tensor(x) for x in (blocks, cols, mask)), th.double())
    np.testing.assert_allclose(
        tref.block_spmm_rows_batched_ref(rows, th.double()).numpy(),
        dense.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bad", ["other_tiles", "max_src", "device"])
def test_wrappers_reject_rows_that_do_not_fit(bad):
    blocks, cols, mask, pv, h, _ = _case(0, 52)
    tb, tc, tm, th = (torch.as_tensor(x) for x in (blocks, cols, mask, h))
    rows = tga.compact_block_csr(tb, tc, tm)
    if bad == "other_tiles":          # another operand's rows
        ob, oc, om = (torch.as_tensor(x) for x in _case(1, 52)[:3])
        rows = tga.compact_block_csr(ob, oc, om)
        assert rows.tiles != tuple(tb.shape[:2])
    elif bad == "max_src":            # reads past the source table
        rows = dataclasses.replace(rows, max_src=th.shape[1])
    else:                             # an operand on another device
        rows = dataclasses.replace(rows, **{
            f.name: getattr(rows, f.name).to("meta")
            for f in dataclasses.fields(rows)
            if isinstance(getattr(rows, f.name), torch.Tensor)})
    with pytest.raises(ValueError):
        tga.block_spmm(tb, tc, tm, th[0], rows=rows)
    with pytest.raises(ValueError):
        tga.block_spmm_batched(tb, tc, tm, th, rows=rows)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "count"])
def test_tile_rows_check_themselves(bad):
    rows = _rows(0)[3]
    if bad == "dtype":
        kw = {"val": rows.val.double()}
    elif bad == "shape":
        kw = {"src": rows.src[:-1]}
    elif bad == "strided":
        kw = {"warp_rows": rows.warp_rows.t().contiguous().t()}
    else:
        kw = {"split": torch.cat([rows.split, rows.split.new_zeros(1)])}
    with pytest.raises((ValueError, TypeError)):
        dataclasses.replace(rows, **kw)


def test_cpu_wrappers_with_rows_give_the_dense_plain_version():
    blocks, cols, mask, pv, h, _ = _case(1, 64)
    tb, tc, tm, th = (torch.as_tensor(x) for x in (blocks, cols, mask, h))
    rows = tga.compact_block_csr(tb, tc, tm)
    assert torch.equal(tga.block_spmm(tb, tc, tm, th[0], rows=rows),
                       tref.block_spmm_ref(tb, tc, tm, th[0]))
    assert torch.equal(tga.block_spmm_batched(tb, tc, tm, th, rows=rows),
                       tref.block_spmm_batched_ref(tb, tc, tm, th))


class _CountCompactions:
    def __init__(self, monkeypatch):
        self.calls = 0
        real = tga.compact_block_csr

        def counted(*args):
            self.calls += 1
            return real(*args)
        for module in (tops, tbsp):
            monkeypatch.setattr(module, "compact_block_csr", counted)


def _siot():
    g = tdata.load("siot", 0.05, seed=0)
    return g, tmodels.gnn_init(torch.Generator().manual_seed(3), "gcn",
                               [g.feature_dim, 16, 8])


def test_block_csr_carries_rows_built_once_per_layout(monkeypatch):
    count = _CountCompactions(monkeypatch)
    g, params = _siot()
    tops.invalidate_block_csr(g)
    sess = Engine((params, "gcn"), device="cpu", aggregation="pallas",
                  compressor="none").compile(g).session()
    feats = sess.collect()
    first = sess.execute(feats)
    assert count.calls == 1
    assert np.array_equal(sess.execute(feats), first)
    sess.execute_many(np.stack([feats, feats]))
    assert count.calls == 1               # a second execute builds nothing
    csr = tops.block_csr_for(g, device="cpu")
    want = tga.compact_block_csr(csr.blocks, csr.cols, csr.mask)
    for name in ("row_ptr", "seg_ptr", "seg_w", "src", "val", "warp_rows",
                 "split"):
        assert torch.equal(getattr(csr.rows, name), getattr(want, name))


def test_folded_mesh_operands_carry_rows_built_once_per_layout(monkeypatch):
    count = _CountCompactions(monkeypatch)
    g, params = _siot()
    plan = Engine((params, "gcn"), device="cpu", executor="mesh-bsp",
                  cluster="1A+2B+1C", aggregation="pallas",
                  compressor="none").compile(g)
    sess = plan.session()
    first = sess.query().embeddings
    assert count.calls == 2               # the local and the halo operand
    assert np.array_equal(sess.query().embeddings, first)
    assert count.calls == 2
    local, halo = tbsp._folded_csrs(sess.partitioned(), plan.device)
    rng = np.random.default_rng(5)
    for op in (local, halo):
        assert op.rows.tiles == tuple(op.blocks.shape[:2])
        assert op.rows.max_src < op.src_rows
        h = torch.as_tensor(rng.normal(size=(op.src_rows, 16)))
        np.testing.assert_allclose(
            tref.block_spmm_rows_ref(op.rows, h).numpy(),
            tref.block_spmm_ref(op.blocks.double(), op.cols,
                                op.mask.double(), h).numpy(),
            rtol=1e-12, atol=1e-12)
    # The DAQ wire's halo product takes the halo operand's rows too: a DAQ
    # layout compacts its two operands once, and every halo product of its
    # queries and batches is handed the halo's rows.
    halo_rows = []
    inner = tbsp.dequant_spmm

    def spy(*args, **kwargs):
        halo_rows.append(kwargs.get("rows"))
        return inner(*args, **kwargs)
    monkeypatch.setattr(tbsp, "dequant_spmm", spy)
    daq = Engine((params, "gcn"), device="cpu", executor="mesh-bsp",
                 cluster="1A+2B+1C", aggregation="pallas",
                 compressor="daq").compile(g).session()
    first = daq.query().embeddings
    assert count.calls == 4
    assert np.array_equal(daq.query().embeddings, first)
    daq.execute_many(np.stack([daq.collect()] * 2))
    assert count.calls == 4
    _, halo = tbsp._folded_csrs(daq.partitioned(), plan.device)
    assert len(halo_rows) == 4 and all(r is halo.rows for r in halo_rows)
