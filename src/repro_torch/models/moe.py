"""Mixture-of-Experts FFN with capacity-based scatter dispatch.

The port of ``repro/models/moe.py``: a top-k router with
softmax-after-topk normalisation (DeepSeek-V3 style), an optional shared
expert (always on), and a Switch-style load-balance loss. Each expert
takes at most C = int(max(1, T k / E * capacity_factor)) (token, slot)
pairs; a pair's place in its expert's queue is its rank among the pairs
routed there, in the flattened [T * k] order, and pairs past C are
dropped (they contribute 0).

What must match the reference exactly, and how:

  * the router runs in f32 (``xf.float() @ router``; the router stays f32
    in every parameter copy);
  * ``jax.lax.top_k`` breaks ties toward the lower expert index; the port
    takes the first k of a stable descending sort, which does the same on
    every device (``torch.topk`` promises no order for ties), so the same
    pairs are kept and dropped;
  * the kept (expert, position) pairs are unique, so the reference's
    ``.at[].add`` scatter is a plain index assignment of the kept rows
    here (no atomics, no accumulation; a dropped row adds exactly 0 there).

The expert FFN is a batched product over the [E, C, D] buffer
(``torch.bmm``), as the reference leaves it to XLA.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import init_mlp, mlp, scaled_normal, silu


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype):
    d, fe, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    sc = (2.0 / (d + fe)) ** 0.5
    p = {"router": scaled_normal(gen, (d, e), torch.float32, 0.02),
         "w_gate": scaled_normal(gen, (e, d, fe), dtype, sc),
         "w_up": scaled_normal(gen, (e, d, fe), dtype, sc),
         "w_down": scaled_normal(gen, (e, fe, d), dtype, sc)}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, fe * cfg.num_shared_experts, dtype)
    return p


#: Parameters the served copy keeps in their dtype: the router, f32 by
#: design.
MOE_KEPT = frozenset({"router"})


class Routing(NamedTuple):
    """Where each (token, slot) pair goes, in the flattened [T * k] order."""
    weights: torch.Tensor    # f32 [T, k] normalised top-k probabilities
    experts: torch.Tensor    # int64 [T * k] expert of each pair
    position: torch.Tensor   # int64 [T * k] place in the expert's queue
    keep: torch.Tensor       # bool [T * k] position < capacity
    capacity: int
    aux: torch.Tensor        # f32 [] load-balance loss


def route(router: torch.Tensor, xf: torch.Tensor, cfg: ArchConfig,
          capacity_factor: float) -> Routing:
    """The router's decisions for tokens xf [T, D]."""
    t = xf.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(xf.float() @ router, dim=-1)            # [T, E]
    # lax.top_k: ties go to the lower index, as a stable sort keeps them.
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # Load-balance auxiliary loss (Switch-style).
    me = probs.mean(dim=0)                                        # [E]
    ce = F.one_hot(top_i[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)

    cap = int(max(1, (t * k) / e * capacity_factor))
    flat_e = top_i.reshape(-1)                                    # [T*k]
    # Rank of each pair among its expert's pairs in flattened order: the
    # reference's exclusive cumsum of the one-hot, without the [T*k, E]
    # table (integers: exact on any device).
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    position = torch.empty_like(flat_e)
    position[order] = (torch.arange(flat_e.numel(), device=flat_e.device)
                       - starts[flat_e[order]])
    return Routing(top_p, flat_e, position, position < cap, cap, aux)


def moe_ffn(params, x: torch.Tensor, cfg: ArchConfig, *,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss [])."""
    b, s, d = x.shape
    t, k = b * s, cfg.experts_per_token
    xf = x.reshape(t, d)
    r = route(params["router"], xf, cfg, capacity_factor)
    safe_pos = torch.where(r.keep, r.position, r.capacity - 1)

    # Kept pairs into the [E, C, D] buffers (unique slots: an assignment).
    xe = x.new_zeros((cfg.num_experts, r.capacity, d))
    kept = torch.nonzero(r.keep).squeeze(1)
    xe[r.experts[kept], r.position[kept]] = xf[kept // k]
    w_flat = (r.weights.reshape(-1) * r.keep).to(x.dtype)         # [T*k]

    dt = x.dtype
    act = silu(torch.bmm(xe, params["w_gate"].to(dt)))
    up = torch.bmm(xe, params["w_up"].to(dt))
    ye = torch.bmm(act * up, params["w_down"].to(dt))             # [E, C, D]

    # Combine: each pair's expert output, weighted, summed over the slots.
    out_slots = ye[r.experts, safe_pos] * w_flat[:, None]         # [T*k, D]
    out = out_slots.reshape(t, k, d).sum(dim=1)
    if "shared" in params:
        out = out + mlp(params["shared"], xf)
    return out.reshape(b, s, d), r.aux
