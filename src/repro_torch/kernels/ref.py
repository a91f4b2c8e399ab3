"""Plain PyTorch versions of the kernels (the correctness yardstick).

Each function takes its kernel's exact input layout, so the CPU tests and
the on-card comparison in ``chip_smoke.py`` can hold kernel and plain
version side by side. The kernel wrappers fall back to these only for
tensors that lie on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def block_spmm_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                   block_mask: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Block-CSR (ELL-over-blocks) SpMM: out = A @ h.

    blocks:     f32[VB, M, B, B]  dense adjacency tiles (row-block major)
    block_cols: i32[VB, M]        column-block index of each tile
    block_mask: f32[VB, M]        1 for real tiles, 0 for padding
    h:          f32[SB*B, F]      source table (SB >= max col block + 1;
                                  SB == VB in the square case)
    returns     f32[VB*B, F]
    """
    vb, m, b, _ = blocks.shape
    f = h.shape[1]
    gathered = h.reshape(-1, b, f)[block_cols.long()]      # [VB, M, B, F]
    tiles = blocks * block_mask[:, :, None, None]
    out = torch.einsum("vmij,vmjf->vif", tiles, gathered)
    return out.reshape(vb * b, f)


def block_spmm_batched_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                           block_mask: torch.Tensor,
                           h: torch.Tensor) -> torch.Tensor:
    """Feature-stack SpMM: out[b] = A @ h[b] for h f32[B, SB*B, F]."""
    return torch.stack([block_spmm_ref(blocks, block_cols, block_mask, hb)
                        for hb in h])


def keep_row_blocks(out: torch.Tensor, sel: torch.Tensor,
                    block: int = 128) -> torch.Tensor:
    """``out`` [..., R, F] with every row outside the ``block``-row blocks
    ``sel`` set to 0: what a launch over a row subset writes (the rows it
    computes are the full product's, the rest stay at their zero fill)."""
    keep = torch.zeros(out.shape[-2] // block, dtype=torch.bool,
                       device=out.device)
    keep[sel.to(out.device).long()] = True
    return torch.where(keep.repeat_interleave(block)[:, None], out,
                       out.new_zeros(()))


def block_spmm_subset_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                          block_mask: torch.Tensor, h: torch.Tensor,
                          sel: torch.Tensor) -> torch.Tensor:
    """The row slice of ``block_spmm_ref`` over the row blocks ``sel``
    (the other rows 0)."""
    return keep_row_blocks(block_spmm_ref(blocks, block_cols, block_mask, h),
                           sel, blocks.shape[-1])


def block_spmm_batched_subset_ref(blocks: torch.Tensor,
                                  block_cols: torch.Tensor,
                                  block_mask: torch.Tensor, h: torch.Tensor,
                                  sel: torch.Tensor) -> torch.Tensor:
    """The row slice of ``block_spmm_batched_ref``."""
    return keep_row_blocks(
        block_spmm_batched_ref(blocks, block_cols, block_mask, h), sel,
        blocks.shape[-1])


def block_spmm_rows_ref(rows, h: torch.Tensor) -> torch.Tensor:
    """out = A @ h over the row-compacted operand (``gather_aggregate.
    compact_block_csr``): the gathered source rows times their entries,
    summed per segment, the segments weighted by ``seg_w`` and summed per
    output row. Computes in ``h``'s dtype (float64 for the on-card
    yardstick). h [S, F] -> [n_rows, F]."""
    return block_spmm_rows_batched_ref(rows, h[None])[0]


def block_spmm_rows_batched_ref(rows, h: torch.Tensor) -> torch.Tensor:
    """The batched form: out[b] = A @ h[b] for h [B, S, F]."""
    dev, dt = h.device, h.dtype
    seg_of = torch.repeat_interleave(
        torch.arange(rows.n_seg, device=dev), rows.seg_ptr.diff().long())
    row_of = torch.repeat_interleave(
        torch.arange(rows.n_rows, device=dev), rows.row_ptr.diff().long())
    b, f = h.shape[0], h.shape[2]
    gathered = h[:, rows.src.long()] * rows.val.to(dt)[None, :, None]
    seg = h.new_zeros((b, rows.n_seg, f)).index_add_(1, seg_of, gathered)
    return h.new_zeros((b, rows.n_rows, f)).index_add_(
        1, row_of, seg * rows.seg_w.to(dt)[None, :, None])


def dequant_ref(codes: torch.Tensor, scales: torch.Tensor,
                mins: torch.Tensor) -> torch.Tensor:
    """Row-wise linear dequantization: out[v, f] = codes[v, f]*scale[v]+min[v].

    codes: uint{8,16,32}[V, F];  scales/mins: f32[V]. The product and the
    sum are two roundings (two tensor ops), which the CUDA kernels repeat.
    A [B, V, F] stack with f32[B, V] parameters dequantizes per example.
    """
    return codes.to(torch.float32) * scales[..., None] + mins[..., None]


def dequant_spmm_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                     block_mask: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, mins: torch.Tensor) -> torch.Tensor:
    """Fused dequant + aggregate: out = A @ dequant(codes).

    The dequantized table is f32 and then takes the dtype of ``blocks``,
    so float64 ``blocks`` give the float64 product of the very f32 panel
    the kernel stages.
    """
    h = dequant_ref(codes, scales, mins).to(blocks.dtype)
    return block_spmm_ref(blocks, block_cols, block_mask, h)


def dequant_spmm_batched_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                             block_mask: torch.Tensor, codes: torch.Tensor,
                             scales: torch.Tensor,
                             mins: torch.Tensor) -> torch.Tensor:
    """Fused batched variant: out[b] = A @ dequant(codes[b]).

    codes uint[B, V, F]; scales/mins f32[B, V].
    """
    return torch.stack([dequant_spmm_ref(blocks, block_cols, block_mask,
                                         c, s, m)
                        for c, s, m in zip(codes, scales, mins)])


def dequant_spmm_subset_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                            block_mask: torch.Tensor, codes: torch.Tensor,
                            scales: torch.Tensor, mins: torch.Tensor,
                            sel: torch.Tensor) -> torch.Tensor:
    """The row slice of ``dequant_spmm_ref`` over the row blocks ``sel``."""
    return keep_row_blocks(dequant_spmm_ref(blocks, block_cols, block_mask,
                                            codes, scales, mins),
                           sel, blocks.shape[-1])


def dequant_spmm_batched_subset_ref(blocks: torch.Tensor,
                                    block_cols: torch.Tensor,
                                    block_mask: torch.Tensor,
                                    codes: torch.Tensor,
                                    scales: torch.Tensor, mins: torch.Tensor,
                                    sel: torch.Tensor) -> torch.Tensor:
    """The row slice of ``dequant_spmm_batched_ref``."""
    return keep_row_blocks(
        dequant_spmm_batched_ref(blocks, block_cols, block_mask, codes,
                                 scales, mins), sel, blocks.shape[-1])


def dequant_spmm_rows_ref(rows, codes: torch.Tensor, scales: torch.Tensor,
                          mins: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fused kernel's plain version over the row-compacted operand:
    ``block_spmm_rows_ref`` over the f32 dequantized table, computed in
    ``dtype`` (float64 for the on-card yardstick). codes [S, F] ->
    [n_rows, F]."""
    return block_spmm_rows_ref(rows, dequant_ref(codes, scales, mins).to(
        dtype))


def dequant_spmm_rows_batched_ref(rows, codes: torch.Tensor,
                                  scales: torch.Tensor, mins: torch.Tensor,
                                  dtype: torch.dtype = torch.float32
                                  ) -> torch.Tensor:
    """The batched form: out[b] = A @ dequant(codes[b]) for codes [B, S, F]
    and f32[B, S] row parameters."""
    return block_spmm_rows_batched_ref(
        rows, dequant_ref(codes, scales, mins).to(dtype))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """Plain-softmax version of the flash kernel: q [BH, S, dh], k/v
    [BH, T, dh] -> [BH, S, dh] in q's dtype.

    Computes in float32 for float32 and bfloat16 inputs, in float64 for
    float64 ones (the on-card yardstick). Masked scores are -1e30 and their
    probabilities re-zeroed, so a row with no visible key gives 0.
    """
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bsd,btd->bst", q.to(ct), k.to(ct)) / math.sqrt(
        q.shape[-1])
    sq, t = q.shape[1], k.shape[1]
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((sq, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    s = torch.where(ok[None], s, -1e30)
    p = torch.where(ok[None], torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bst,btd->bsd", p, v.to(ct)).to(q.dtype)


def gqa_flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """Model layout, causal: q [B, S, H, dh], k/v [B, T, KV, dh] ->
    [B, S, H, dh], each kv head repeated for its H / KV query heads and
    the heads folded into the batch, as the reference's ``gqa_flash``."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    kx = k.repeat_interleave(h // kv, dim=2)
    vx = v.repeat_interleave(h // kv, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, s, dh)
    kf = kx.transpose(1, 2).reshape(b * h, t, dh)
    vf = vx.transpose(1, 2).reshape(b * h, t, vx.shape[-1])
    o = flash_attention_ref(qf, kf, vf, window=window)
    return o.reshape(b, h, s, -1).transpose(1, 2)


def segment_sum_ref(x: torch.Tensor, order: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """Fixed-order segment sum: out[v] = 0 + x[order[o]] + ... over o in
    offsets[v] .. offsets[v + 1] - 1, left to right, for x [E] or [E, F]
    -> [V] or [V, F]. With ``order`` the edges stably sorted by receiver
    these are the floats of a serial ``index_add_`` into zeros."""
    return torch.segment_reduce(x.index_select(0, order.long()), "sum",
                                offsets=offsets.long(), axis=0)


def gather_segment_sum_ref(x: torch.Tensor, idx: torch.Tensor,
                           offsets: torch.Tensor, *,
                           order: Optional[torch.Tensor] = None,
                           w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused gather-and-sum: out[v] = 0 + (w[order[k]] *) x[idx[k]] +
    ... over k in offsets[v] .. offsets[v + 1] - 1, left to right. Gathers
    the terms (each product rounded on its own), then sums them with
    ``segment_sum_ref`` in their order."""
    terms = x.index_select(0, idx.long())
    if w is not None:
        wk = w.index_select(0, order.long())
        terms = terms * (wk[:, None] if terms.ndim == 2 else wk)
    every = torch.arange(terms.shape[0], dtype=torch.int32,
                         device=terms.device)
    return segment_sum_ref(terms, every, offsets)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, as JAX writes it: ``logaddexp(x, 0)`` =
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def selective_scan_ref(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       x: torch.Tensor, a: torch.Tensor,
                       h0: torch.Tensor):
    """Mamba-1's recurrence, the ``lax.scan`` of the reference's
    ``_mamba_inner`` (src/repro/models/ssm.py:68-80), one step at a time:

        h = exp(dt_t a) h + (dt_t b_t) x_t,   y_t = sum_s h[:, :, s] c_t[s]

    dt, x [B, S, di] (dt after softplus), b, c [B, S, st], a [di, st]
    (``-exp(a_log)``), h0 [B, di, st], all in one float type (f32 on the
    model's path, float64 for a yardstick). Every product and sum is one
    tensor op, rounded on its own. Returns (y [B, S, di], h_last)."""
    h = h0
    ys = []
    for t in range(dt.shape[1]):
        dt_t = dt[:, t, :, None]                          # [B, di, 1]
        da = torch.exp(dt_t * a)
        db = dt_t * b[:, t, None, :]
        h = da * h + db * x[:, t, :, None]
        ys.append(torch.einsum("bds,bs->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h


#: RG-LRU's constant c (arXiv:2402.19427 §2.4; src/repro/models/ssm.py:124).
LRU_C = 8.0


def rglru_scan_ref(xc: torch.Tensor, w_input_gate: torch.Tensor,
                   w_rec_gate: torch.Tensor, lambda_p: torch.Tensor,
                   h0: torch.Tensor):
    """The reference's ``_rglru_scan`` (src/repro/models/ssm.py:146-164):
    the input and recurrence gates of the conv output xc [B, S, w], then
    the diagonal recurrence h = a_t h + m_t (i_t x_t) one step at a time,
    from h0 [B, w]. All tensors in one float type (f32 on the model's
    path); the gate vectors are [w]. Returns (hs [B, S, w], h_last)."""
    i_gate = 1 / (1 + torch.exp(-(xc * w_input_gate)))   # jax.nn.sigmoid
    r_gate = 1 / (1 + torch.exp(-(xc * w_rec_gate)))
    log_a = -LRU_C * softplus(lambda_p) * r_gate
    a = torch.exp(log_a)
    gated_x = i_gate * xc
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    h = h0
    hs = []
    for t in range(xc.shape[1]):
        h = a[:, t] * h + mult[:, t] * gated_x[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
