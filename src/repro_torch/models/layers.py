"""Shared neural layers: norms, positional encodings, dense FFNs.

Pure functions over explicit parameter dictionaries, as in the JAX
package (``repro/models/layers.py``), with the same numerics: every
parameter is cast to the activation dtype at its matmul (a copy already in
that dtype gives the same numbers), ``rms_norm`` rounds to the activation
dtype before the scale, and ``apply_rope`` rotates in f32. ``init_*`` draw
from a ``torch.Generator``; the JAX package's weights carry across through
``models.transformer.params_from_numpy``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return out.to(dt) * scale.to(dt)


def init_rms(d: int, dtype, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# ----------------------------------------------------------------------------
# Rotary position embedding
# ----------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] integer."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)         # [Dh/2]
    angles = positions[..., None].float() * freqs         # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]                 # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """[..., S] -> [..., S, D] fixed sinusoidal table (musicgen-style)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------------
# Dense FFN (gated SwiGLU/GeGLU or plain 2-matrix MLP)
# ----------------------------------------------------------------------------

def scaled_normal(gen: torch.Generator, shape, dtype,
                  scale: float) -> torch.Tensor:
    """``scale`` times standard normal draws from ``gen``, on its device."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * scale


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             gated: bool = True):
    sc_in = (2.0 / (d_model + d_ff)) ** 0.5
    p = {"w_up": scaled_normal(gen, (d_model, d_ff), dtype, sc_in),
         "w_down": scaled_normal(gen, (d_ff, d_model), dtype, sc_in)}
    if gated:
        p["w_gate"] = scaled_normal(gen, (d_model, d_ff), dtype, sc_in)
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {"silu": F.silu, "gelu": _gelu}


def mlp(params, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    act = _ACTIVATIONS[activation]
    dt = x.dtype
    up = x @ params["w_up"].to(dt)
    if "w_gate" in params:
        up = act(x @ params["w_gate"].to(dt)) * up
    else:
        up = act(up)
    return up @ params["w_down"].to(dt)


# ----------------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d_model: int, dtype):
    return {"table": scaled_normal(gen, (vocab, d_model), dtype, 0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """x @ table.T in the promoted dtype of the two, as JAX promotes a
    bf16 activation against an f32 table (the table is not cast down)."""
    dt = torch.promote_types(x.dtype, params["table"].dtype)
    return x.to(dt) @ params["table"].to(dt).T


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                bias: bool = False):
    sc = (2.0 / (d_in + d_out)) ** 0.5
    p = {"w": scaled_normal(gen, (d_in, d_out), dtype, sc)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y
