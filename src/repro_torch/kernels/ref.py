"""Plain PyTorch versions of the kernels (the correctness yardstick).

Each function takes its kernel's exact input layout, so the CPU tests and
the on-card comparison in ``chip_smoke.py`` can hold kernel and plain
version side by side. The kernel wrappers fall back to these only for
tensors that lie on the CPU.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


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


def headed_segment_sum_ref(x: torch.Tensor, idx: torch.Tensor,
                           offsets: torch.Tensor, order: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """The per-head weighted gather-and-sum: x [N, H * D], w [E, H] ->
    [V, H * D] with out[v, k*D + j] = 0 + w[order[i], k] * x[idx[i], k*D +
    j] + ... over i in offsets[v] .. offsets[v + 1] - 1, left to right:
    each head's columns the weighted sum of ``gather_segment_sum_ref``
    with that head's weights."""
    terms = x.index_select(0, idx.long())
    e, heads = terms.shape[0], w.shape[1]
    wk = w.index_select(0, order.long())
    terms = (terms.view(e, heads, -1) * wk[:, :, None]).view(e, -1)
    every = torch.arange(e, dtype=torch.int32, device=terms.device)
    return segment_sum_ref(terms, every, offsets)


def edge_softmax_ref(a_src: torch.Tensor, a_dst: torch.Tensor,
                     senders: torch.Tensor, receivers: torch.Tensor,
                     mask: torch.Tensor, order: torch.Tensor,
                     offsets: torch.Tensor,
                     total: Optional[Callable] = None) -> torch.Tensor:
    """GAT's edge softmax as the PyTorch chain: scores a_src [M] or [M, H]
    (senders index them) and a_dst [V] or [V, H] (receivers) -> the
    coefficients [E] or [E, H] of every edge, per head: leaky_relu(a_src[s]
    + a_dst[r], 0.2), -inf on masked edges, the receiver's max
    (``scatter_reduce`` "amax", 0 where not finite), the exponents (0 on
    masked edges), their sums over the order, and the exponents over
    ``clamp_min(sum, 1e-16)``. ``total`` sums [E] or [E, H] terms per
    receiver left to right over the order (default ``segment_sum_ref``;
    the backward of ``kernels.edge_softmax`` passes the differentiable
    ``segment_sum``). Head-major inside: [H, E] tables gathered along
    their last axis ([E] at one head)."""
    if total is None:
        def total(x):
            return segment_sum_ref(x, order, offsets)
    alpha_src = a_src.movedim(-1, 0) if a_src.ndim == 2 else a_src
    alpha_dst = a_dst.movedim(-1, 0) if a_dst.ndim == 2 else a_dst
    v = offsets.shape[0] - 1
    s, r, m = senders, receivers, mask
    logits = F.leaky_relu(alpha_src[..., s] + alpha_dst[..., r], 0.2)
    logits = torch.where(m > 0, logits, -torch.inf)  # [H, E]
    seg_max = torch.full(logits.shape[:-1] + (v,), -torch.inf,
                         dtype=logits.dtype, device=logits.device)
    seg_max = seg_max.scatter_reduce(-1, r.long().expand_as(logits),
                                     logits, "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.where(m > 0, torch.exp(logits - seg_max[..., r]), 0.0)
    denom = total(ex.movedim(0, -1)).movedim(-1, 0)
    coef = ex / torch.clamp_min(denom[..., r], 1e-16)
    return coef.movedim(0, -1)


def stage_rows_ref(x: torch.Tensor, row_src: torch.Tensor) -> torch.Tensor:
    """The staging row gather: x [B, S, F], row_src int32[R] -> [B, R, F]
    with row r of every example x's row ``row_src[r]``, or +0.0 where it is
    -1 (an ``index_select`` over x with a +0.0 row appended at index S)."""
    b, s, f = x.shape
    padded = torch.cat([x, x.new_zeros((b, 1, f))], 1)
    idx = torch.where(row_src < 0, s, row_src).long()
    return padded.index_select(1, idx)


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


def selective_scan_bwd_ref(dt: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                           h0: torch.Tensor, dy: torch.Tensor,
                           dh_last: Optional[torch.Tensor] = None):
    """The gradient of ``selective_scan_ref`` for every input, one step at
    a time in reverse: the states h_t are recomputed forward, then, from
    g = dh_last (or 0), for t = S ... 1:

        g += dy_t c_t;  dc_t = sum_d dy_t h_t;  dx_t = sum_s g dt_t b_t
        ddt_t = sum_s g x_t b_t + sum_s (g h_{t-1} da_t) a
        db_t = sum_d g dt_t x_t;  da += g h_{t-1} da_t dt_t;  g <- g da_t

    with da_t = exp(dt_t a); dh0 is the last g. Shapes as the forward's
    (``dy`` as y, ``dh_last`` as h0). Returns (ddt, db, dc, dx, da,
    dh0)."""
    h = h0
    hs, das = [h0], []
    for t in range(dt.shape[1]):
        dt_t = dt[:, t, :, None]
        da_t = torch.exp(dt_t * a)
        h = da_t * h + (dt_t * b[:, t, None, :]) * x[:, t, :, None]
        hs.append(h)
        das.append(da_t)
    g = torch.zeros_like(h0) if dh_last is None else dh_last
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.zeros_like(a)
    for t in reversed(range(dt.shape[1])):
        dt_t = dt[:, t, :, None]                          # [B, di, 1]
        x_t = x[:, t, :, None]
        b_t, c_t = b[:, t, None, :], c[:, t, None, :]     # [B, 1, st]
        g = g + dy[:, t, :, None] * c_t
        dc[:, t] = torch.einsum("bd,bds->bs", dy[:, t], hs[t + 1])
        dx[:, t] = (g * dt_t * b_t).sum(-1)
        gh = g * hs[t] * das[t]
        ddt[:, t] = (g * x_t * b_t).sum(-1) + (gh * a).sum(-1)
        db[:, t] = (g * dt_t * x_t).sum(1)
        da = da + (gh * dt_t).sum(0)
        g = g * das[t]
    return ddt, db, dc, dx, da, g


def rglru_scan_bwd_ref(xc: torch.Tensor, w_input_gate: torch.Tensor,
                       w_rec_gate: torch.Tensor, lambda_p: torch.Tensor,
                       h0: torch.Tensor, hs: torch.Tensor, dhs: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None):
    """The gradient of ``rglru_scan_ref`` for every input, from its output
    ``hs`` (h_{t-1} is hs[t - 1], or h0): the reverse recurrence, from
    g = dh_last (or 0), for t = S ... 1: g += dhs_t; d a_t = g h_{t-1},
    d u_t = g; g <- a_t g (dh0 is the last g). Then the gate derivatives
    per (t, channel): u = m (i x) with m = sqrt(max(1 - e^{2 log a},
    1e-12)) (no gradient where the clamp holds), a = e^{log a}, log a =
    -8 softplus(lambda) r, and the two sigmoids (derivative s (1 - s)).
    Returns (dxc, dw_input_gate, dw_rec_gate, dlambda_p, dh0)."""
    i_gate = 1 / (1 + torch.exp(-(xc * w_input_gate)))
    r_gate = 1 / (1 + torch.exp(-(xc * w_rec_gate)))
    neg_c_sp = -LRU_C * softplus(lambda_p)
    log_a = neg_c_sp * r_gate
    a = torch.exp(log_a)
    gx = i_gate * xc
    e2 = torch.exp(2.0 * log_a)
    v = 1.0 - e2
    m = torch.sqrt(torch.clamp_min(v, 1e-12))
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    g = torch.zeros_like(h0) if dh_last is None else dh_last
    gs = torch.empty_like(hs)
    for t in reversed(range(xc.shape[1])):
        g = g + dhs[:, t]
        gs[:, t] = g
        g = a[:, t] * g
    d_m = gs * gx
    d_gx = gs * m
    d_v = torch.where(v > 1e-12, d_m * 0.5 / m, torch.zeros_like(m))
    d_log_a = gs * h_prev * a - 2.0 * d_v * e2
    d_zr = d_log_a * neg_c_sp * r_gate * (1 - r_gate)
    d_zi = d_gx * xc * i_gate * (1 - i_gate)
    dxc = d_gx * i_gate + d_zr * w_rec_gate + d_zi * w_input_gate
    sig_lam = 1 / (1 + torch.exp(-lambda_p))
    d_lam = (d_log_a * r_gate).sum((0, 1)) * -LRU_C * sig_lam
    return (dxc, (d_zi * xc).sum((0, 1)), (d_zr * xc).sum((0, 1)), d_lam, g)
