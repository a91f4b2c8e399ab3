"""Plain PyTorch versions of the block-CSR kernels (the correctness yardstick).

Each function takes its kernel's exact input layout, so the CPU tests and
the on-card comparison in ``chip_smoke.py`` can hold kernel and plain
version side by side. The kernel wrappers fall back to these only for
tensors that lie on the CPU.
"""
from __future__ import annotations

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
