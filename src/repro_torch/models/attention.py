"""Attention mixers: GQA (RoPE, QKV bias, sliding window, local banding)
and MLA (DeepSeek-V3 latent attention with a compressed KV cache).

The port of ``repro/models/attention.py``, with the same parameter layout
(GQA: wq [D, H, dh], wk/wv [D, KV, dh], wo [H, dh, D]; MLA: wq_a/wq_b or
wq, wkv_a, wk_b, wv_b, wo) and numerics:

  * ``gqa_forward``: full-sequence causal attention (prefill, forward). With
    ``cfg.attn_impl == "flash"`` it runs the hand-written flash kernel
    (``kernels.flash_attention.gqa_flash``); with ``"chunked"`` the plain
    query-chunked softmax below, as the reference leaves it to XLA.
  * ``gqa_decode``: one token against a ``KVCache`` or an int8
    ``QuantKVCache`` (per-(token, head) scales), a ring buffer of
    ``window`` entries when ``window > 0``. Its attention (``_sdpa``) is
    plain torch, as the reference computes it outside any Pallas kernel.
  * ``mla_forward``: full-sequence MLA, always through the chunked path
    (q/k head dim qk_nope + qk_rope, v head dim v_head_dim), as in the
    reference whatever ``attn_impl`` says; ``mla_decode``: the
    weight-absorbed decode against an ``MLACache`` of the latent and the
    shared rope key.

The port updates a decode cache in place (the reference returns a new
one): the caller's cache is the one returned, and no second cache-sized
buffer is written per step. An int8 cache's codes and scales are updated
in place too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import gqa_flash
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, promoted_matmul,
                                       scaled_normal)

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


@dataclasses.dataclass
class QuantKVCache:
    """int8 KV cache with per-(token, head) scales: Fograph's degree-aware
    quantization (SSIII-D) applied to the serving cache: half the bytes
    of a bf16 ``KVCache``'s k and v (a quarter of f32's), plus an f32
    scale a token and head."""
    k_q: torch.Tensor       # int8 [B, T, KV, dh]
    v_q: torch.Tensor       # int8 [B, T, KV, dh]
    k_scale: torch.Tensor   # f32  [B, T, KV]
    v_scale: torch.Tensor   # f32  [B, T, KV]

    @classmethod
    def zeros(cls, b, t, kv, dh, dtype=None, device=None):
        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)
        return cls(z((b, t, kv, dh), torch.int8), z((b, t, kv, dh), torch.int8),
                   z((b, t, kv), torch.float32), z((b, t, kv), torch.float32))


def _quantize_heads(x: torch.Tensor):
    """x [B,S,KV,dh] -> (int8 codes, f32 scales [B,S,KV]): symmetric, each
    head's max |x| at 127, rounded half to even as ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_heads(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def gqa_decode(params, x: torch.Tensor, cache, pos: int, cfg: ArchConfig, *,
               window: int = 0):
    """One-token decode at absolute position ``pos``. With ``window > 0``
    the cache is a ring buffer of ``window`` entries. Takes a ``KVCache``
    or a ``QuantKVCache`` (the token's k/v quantized, the whole cache
    dequantized to the activation dtype for the step). Writes the token
    into ``cache`` in place and returns (y, cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)          # [B,1,·,dh]
    slot = (pos % window) if window else pos
    if isinstance(cache, QuantKVCache):
        t = cache.k_q.shape[1]
        kq, ks = _quantize_heads(k)
        vq, vs = _quantize_heads(v)
        cache.k_q[:, slot] = kq[:, 0]
        cache.v_q[:, slot] = vq[:, 0]
        cache.k_scale[:, slot] = ks[:, 0]
        cache.v_scale[:, slot] = vs[:, 0]
        k_full = _dequantize_heads(cache.k_q, cache.k_scale, x.dtype)
        v_full = _dequantize_heads(cache.v_q, cache.v_scale, x.dtype)
    elif isinstance(cache, KVCache):
        t = cache.k.shape[1]
        cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
        k_full, v_full = cache.k, cache.v
    else:
        raise TypeError(f"gqa_decode takes a KVCache or a QuantKVCache, "
                        f"got {type(cache).__name__}")
    idx = torch.arange(t, device=x.device)
    valid = idx < min(pos + 1, window) if window else idx <= pos
    mask = torch.where(valid, 0.0, NEG_INF)[None, None, None, None, :]
    out = _sdpa(q, k_full, v_full, mask, cfg.num_heads // cfg.num_kv_heads)
    return _out_proj(out, params["wo"]), cache


# ----------------------------------------------------------------------------
# MLA (DeepSeek-V3, arXiv:2412.19437 §2.1)
# ----------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype):
    d, h = cfg.d_model, cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank or 0, cfg.kv_lora_rank
    qk_n, qk_r, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    def sc(i, o):
        return (2.0 / (i + o)) ** 0.5

    p = {}
    if r_q:
        p["wq_a"] = scaled_normal(gen, (d, r_q), dtype, sc(d, r_q))
        p["wq_b"] = scaled_normal(gen, (r_q, h, qk_n + qk_r), dtype,
                                  sc(r_q, h * (qk_n + qk_r)))
    else:
        p["wq"] = scaled_normal(gen, (d, h, qk_n + qk_r), dtype,
                                sc(d, h * (qk_n + qk_r)))
    # KV joint compression: c_kv = x @ wkv_a[:, :r_kv]; k_rope shared 1 head.
    p["wkv_a"] = scaled_normal(gen, (d, r_kv + qk_r), dtype,
                               sc(d, r_kv + qk_r))
    p["wk_b"] = scaled_normal(gen, (r_kv, h, qk_n), dtype, sc(r_kv, h * qk_n))
    p["wv_b"] = scaled_normal(gen, (r_kv, h, dv), dtype, sc(r_kv, h * dv))
    p["wo"] = scaled_normal(gen, (h, dv, d), dtype, sc(h * dv, d))
    return p


#: Parameters the served copy keeps in their dtype: ``wkv_a``, uncast in
#: the prefill cache.
MLA_KEPT = frozenset({"wkv_a"})


def _mla_q(params, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor):
    qk_n = cfg.qk_nope_head_dim
    if "wq_a" in params:
        q = _project(x @ params["wq_a"].to(x.dtype), params["wq_b"])
    else:
        q = _project(x, params["wq"])
    q_nope, q_rope = q[..., :qk_n], q[..., qk_n:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_latent(ckv: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """Split x @ wkv_a [B,S,r_kv + qk_r] into the latent c_kv and the
    shared rope key, rotated: (c_kv [B,S,r_kv], k_rope [B,S,qk_r])."""
    r_kv = cfg.kv_lora_rank
    k_rope = apply_rope(ckv[..., r_kv:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return ckv[..., :r_kv], k_rope


def mla_forward(params, x: torch.Tensor, cfg: ArchConfig, *,
                window: int = 0,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence MLA (naive / uncompressed materialisation) through the
    chunked path, as in the reference under either ``attn_impl``."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    c_kv, k_rope = mla_latent(x @ params["wkv_a"].to(x.dtype), cfg,
                              positions)
    k_nope = _project(c_kv, params["wk_b"])
    v = _project(c_kv, params["wv_b"])
    # The rope part joins a combined head dim; its 1/sqrt(qk_n + qk_r)
    # scale is exactly MLA's.
    h = q_nope.shape[2]
    q_all = torch.cat([q_nope, q_rope], dim=-1)
    k_all = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_head_dim)], dim=-1)
    out = chunked_causal_attention(q_all, k_all, v, 1, window=window)
    return _out_proj(out, params["wo"])


@dataclasses.dataclass
class MLACache:
    c_kv: torch.Tensor     # [B, T, r_kv]   compressed latent
    k_rope: torch.Tensor   # [B, T, qk_rope]

    @classmethod
    def zeros(cls, b, t, r_kv, qk_r, dtype, device=None):
        return cls(torch.zeros((b, t, r_kv), dtype=dtype, device=device),
                   torch.zeros((b, t, qk_r), dtype=dtype, device=device))


def mla_prefill_latent(params, h: torch.Tensor, cfg: ArchConfig):
    """The latent and rope key the reference's prefill recomputes for the
    cache (``_prefill_cache``, transformer.py:424): from ``wkv_a`` used
    uncast, so an f32 ``wkv_a`` gives an f32 product of a bf16 h."""
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    return mla_latent(promoted_matmul(h, params["wkv_a"]), cfg, positions)


def mla_decode(params, x: torch.Tensor, cache: MLACache, pos: int,
               cfg: ArchConfig, *, window: int = 0):
    """Weight-absorbed decode: attention runs in the latent space, so the
    cache holds only (r_kv + qk_rope) numbers a token. Writes the token
    into ``cache`` in place and returns (y, cache)."""
    b = x.shape[0]
    dt = x.dtype
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(params, x, cfg, positions)      # [B,1,H,·]
    c_new, kr_new = mla_latent(x @ params["wkv_a"].to(dt), cfg, positions)
    t = cache.c_kv.shape[1]
    slot = (pos % window) if window else pos
    cache.c_kv[:, slot] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, slot] = kr_new[:, 0].to(cache.k_rope.dtype)
    c_kv, k_rope = cache.c_kv, cache.k_rope
    # Absorb wk_b into the query: q_lat [B,1,H,r_kv].
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["wk_b"].to(dt))
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_kv.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             k_rope.float())) * scale
    idx = torch.arange(t, device=x.device)
    valid = idx < min(pos + 1, window) if window else idx <= pos
    scores = scores + torch.where(valid, 0.0, NEG_INF)[None, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(dt)
    attn_lat = torch.einsum("bhst,btr->bshr", probs, c_kv)   # [B,1,H,r_kv]
    out = torch.einsum("bshr,rhk->bshk", attn_lat, params["wv_b"].to(dt))
    return _out_proj(out, params["wo"]), cache
