"""Plain PyTorch versions of the kernels (the correctness yardstick).

Each function takes its kernel's exact input layout, so the CPU tests and
the on-card comparison in ``chip_smoke.py`` can hold kernel and plain
version side by side. The kernel wrappers fall back to these only for
tensors that lie on the CPU.
"""
from __future__ import annotations

import math

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


def dequant_ref(codes: torch.Tensor, scales: torch.Tensor,
                mins: torch.Tensor) -> torch.Tensor:
    """Row-wise linear dequantization: out[v, f] = codes[v, f]*scale[v]+min[v].

    codes: uint{8,16,32}[V, F];  scales/mins: f32[V]. The product and the
    sum are two roundings (two tensor ops), which the CUDA kernels repeat.
    """
    return codes.to(torch.float32) * scales[:, None] + mins[:, None]


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
