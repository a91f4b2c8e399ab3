"""GQA attention (RoPE, QKV bias, sliding window) for the dense decoders.

The GQA half of ``repro/models/attention.py``, with the same parameter
layout (wq [D, H, dh], wk/wv [D, KV, dh], wo [H, dh, D]) and numerics:

  * ``gqa_forward``: full-sequence causal attention (prefill, forward). With
    ``cfg.attn_impl == "flash"`` it runs the hand-written flash kernel
    (``kernels.flash_attention.gqa_flash``); with ``"chunked"`` the plain
    query-chunked softmax below, as the reference leaves it to XLA.
  * ``gqa_decode``: one token against a ``KVCache``, a ring buffer of
    ``window`` entries when ``window > 0``. Its attention (``_sdpa``) is
    plain torch, as the reference computes it outside any Pallas kernel.

The port updates a decode cache in place (the reference returns a new
one): the caller's cache is the one returned, and no second cache-sized
buffer is written per step. MLA and the int8 ``QuantKVCache`` are not
ported (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import gqa_flash
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, scaled_normal

NEG_INF = -2.0e38


def init_gqa(gen: torch.Generator, cfg: ArchConfig, dtype):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sc = (2.0 / (d + h * dh)) ** 0.5
    p = {"wq": scaled_normal(gen, (d, h, dh), dtype, sc),
         "wk": scaled_normal(gen, (d, kv, dh), dtype, sc),
         "wv": scaled_normal(gen, (d, kv, dh), dtype, sc),
         "wo": scaled_normal(gen, (h, dh, d), dtype, sc)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, dh), dtype=dtype, device=gen.device)
        p["bk"] = torch.zeros((kv, dh), dtype=dtype, device=gen.device)
        p["bv"] = torch.zeros((kv, dh), dtype=dtype, device=gen.device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    dt = x.dtype   # projections stay in the activation dtype
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.to(out.dtype).reshape(
        h * k, d)


def _sdpa(q, k, v, mask, num_kv_groups: int):
    """q [B,S,H,dh], k/v [B,T,KV,dh], additive f32 mask broadcastable to
    [B,KV,G,S,T]. Direct (unchunked) path, used for decode (S = 1). Scores
    are f32 (bf16 products are exact in f32, summed in f32), probabilities
    take v's dtype."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, s, kvh, num_kv_groups, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    scores = scores / math.sqrt(dh) + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


DEFAULT_Q_CHUNK = 512


def chunked_causal_attention(q, k, v, num_kv_groups: int, *, window: int = 0,
                             q_chunk: int = DEFAULT_Q_CHUNK):
    """Blockwise causal attention over query chunks, so the peak score
    memory is [B,KV,G,QC,T] instead of [B,KV,G,S,S]; the mask comes from
    position arithmetic (never an S x S table)."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = num_kv_groups
    qc = min(q_chunk, s)
    if s % qc:
        qc = s   # irregular sizes go unchunked
    qs = q.reshape(b, s // qc, qc, kvh, g, dh)
    kf = k.float()
    j = torch.arange(t, device=q.device)
    outs = []
    for ci in range(s // qc):
        i = ci * qc + torch.arange(qc, device=q.device)
        ok = j[None, :] <= i[:, None]
        if window:
            ok &= j[None, :] > (i[:, None] - window)
        m = torch.where(ok, 0.0, NEG_INF)[None, None, None]   # [1,1,1,QC,T]
        scores = torch.einsum("bskgd,btkd->bkgst", qs[:, ci].float(),
                              kf) / math.sqrt(dh)
        probs = torch.softmax(scores + m, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgst,btkd->bskgd", probs, v))
    return torch.cat(outs, dim=1).reshape(b, s, h, v.shape[-1])


def causal_mask(s: int, window: int = 0, device=None) -> torch.Tensor:
    """[1,1,1,S,S] additive causal (optionally banded) mask."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    ok = j <= i
    if window:
        ok &= j > i - window
    return torch.where(ok, 0.0, NEG_INF)[None, None, None]


def _attend(q, k, v, cfg: ArchConfig, window: int) -> torch.Tensor:
    if cfg.attn_impl == "flash":
        return gqa_flash(q, k, v, window=window)
    if cfg.attn_impl == "chunked":
        return chunked_causal_attention(q, k, v,
                                        cfg.num_heads // cfg.num_kv_heads,
                                        window=window)
    raise ValueError(f"attn_impl must be 'flash' or 'chunked', got "
                     f"{cfg.attn_impl!r}")


def gqa_forward_kv(params, x: torch.Tensor, cfg: ArchConfig, *,
                   window: int = 0,
                   positions: Optional[torch.Tensor] = None):
    """``gqa_forward`` that also returns the layer's k and v [B,S,KV,dh]
    (the reference's prefill recomputes them for the cache: the same
    numbers, computed once here)."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions)
    out = _attend(q, k, v, cfg, window)
    return _out_proj(out, params["wo"]), k, v


def gqa_forward(params, x: torch.Tensor, cfg: ArchConfig, *,
                window: int = 0,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    return gqa_forward_kv(params, x, cfg, window=window,
                          positions=positions)[0]


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor       # [B, T, KV, dh]
    v: torch.Tensor       # [B, T, KV, dh]

    @classmethod
    def zeros(cls, b, t, kv, dh, dtype, device=None):
        return cls(torch.zeros((b, t, kv, dh), dtype=dtype, device=device),
                   torch.zeros((b, t, kv, dh), dtype=dtype, device=device))


def gqa_decode(params, x: torch.Tensor, cache: KVCache, pos: int,
               cfg: ArchConfig, *, window: int = 0):
    """One-token decode at absolute position ``pos``. With ``window > 0``
    the cache is a ring buffer of ``window`` entries. Writes the token's
    k/v into ``cache`` in place and returns (y, cache)."""
    if not isinstance(cache, KVCache):
        raise NotImplementedError("only KVCache is ported; QuantKVCache "
                                  "waits for ROADMAP Queue 1 item 6, the "
                                  "rest of the transformer substrate")
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)          # [B,1,·,dh]
    t = cache.k.shape[1]
    slot = (pos % window) if window else pos
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    idx = torch.arange(t, device=x.device)
    valid = idx < min(pos + 1, window) if window else idx <= pos
    mask = torch.where(valid, 0.0, NEG_INF)[None, None, None, None, :]
    out = _sdpa(q, cache.k, cache.v, mask,
                cfg.num_heads // cfg.num_kv_heads)
    return _out_proj(out, params["wo"]), cache
