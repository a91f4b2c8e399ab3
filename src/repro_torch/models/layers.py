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

import functools
import math

import torch

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
    """``scale`` times standard normal draws from ``gen``, on its device
    (scaled in place: a full-width expert stack is gigabytes)."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).mul_(scale)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             gated: bool = True):
    sc_in = (2.0 / (d_model + d_ff)) ** 0.5
    p = {"w_up": scaled_normal(gen, (d_model, d_ff), dtype, sc_in),
         "w_down": scaled_normal(gen, (d_ff, d_model), dtype, sc_in)}
    if gated:
        p["w_gate"] = scaled_normal(gen, (d_model, d_ff), dtype, sc_in)
    return p


# Activations as JAX writes them, op by op in the input's dtype (a bf16
# input rounds after each op, as XLA's bf16 ops do, and a constant is first
# rounded to that dtype): bitwise ``jax.nn`` in bf16 on the CPU but where
# XLA flushes a subnormal to zero, within an ulp in f32. PyTorch's fused
# ``F.silu`` / ``F.gelu`` round once and differ from JAX in the last bf16
# bit of some outputs. Each op is a pass over the tensor: on the card the
# op-by-op silu costs the dense long prefill about a tenth of its time
# (PERF.md), the price of the reference's numbers.

def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)) (``reciprocal`` rounds as the
    divide does, in one pass where ``1 / t`` takes two)."""
    return torch.reciprocal(1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * sigmoid(x)


@functools.lru_cache(maxsize=None)
def _rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as JAX rounds a weakly typed constant (a
    Python number: no copy to the card)."""
    return torch.tensor(v, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (approximate=True, its default), the tanh form."""
    c0 = _rounded(math.sqrt(2 / math.pi), x.dtype)
    c1 = _rounded(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c0 * (x + c1 * x ** 3)))
    return x * cdf


_ACTIVATIONS = {"silu": silu, "gelu": gelu}


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


def promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two, as JAX computes a product
    of mixed types (a bf16 activation against an f32 weight is an f32
    product; neither operand is cast down)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """x @ table.T in the promoted dtype of the two (the table is not cast
    down)."""
    return promoted_matmul(x, params["table"].T)


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
