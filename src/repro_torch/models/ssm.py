"""Recurrent mixers: Mamba-1's selective SSM (falcon-mamba) and the RG-LRU
(recurrentgemma), each with a full-sequence and a one-token decode path.

The port of ``repro/models/ssm.py`` with the same parameter names, shapes
and dtype flow. A bf16 activation times an f32 parameter is an f32 tensor
in both packages, so with ``param_dtype="float32"`` the causal conv (whose
``conv_w`` is used uncast) lifts the activations to f32 and Mamba's
``x_proj``, ``dt_proj`` and ``out_proj`` products run in f32, as in the
reference. The conv is the reference's Python ``sum`` over shifted slices,
in its order. The time recurrences run through the hand-written kernels of
``kernels.recurrence`` (``selective_scan``, ``rglru_scan``) on the card,
one launch a layer for a whole sequence or a decode step; on the CPU
through their plain step loops. Both are autograd Functions: in training
their gradients come from the hand-written backward kernels (one launch a
layer), and ``xc.float()`` and ``softplus(dt.float())`` carry the
gradients on to the projections, the conv and ``a_log``.

A decode returns a new state (the reference's NamedTuples become
dataclasses); the transformer's ``decode_step`` puts it in the caller's
cache list.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.recurrence import rglru_scan, selective_scan
from repro_torch.kernels.ref import softplus
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import gelu, scaled_normal, silu


def _sc(i: int, o: int) -> float:
    return (2.0 / (i + o)) ** 0.5


def causal_conv(xin: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time of xin [B, S, C] with taps
    conv_w [dc, C]: the reference's ``sum(xp[:, i:i + s] * conv_w[i])`` over
    the front-padded input, in its order (the product promotes to the
    wider of the two dtypes)."""
    s, dc = xin.shape[1], conv_w.shape[0]
    xp = F.pad(xin, (0, 0, dc - 1, 0))
    return sum(xp[:, i:i + s] * conv_w[i] for i in range(dc))


# ----------------------------------------------------------------------------
# Mamba-1 (arXiv:2312.00752; falcon-mamba arXiv:2410.05355)
# ----------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, cfg: ArchConfig, dtype):
    d, di = cfg.d_model, cfg.ssm_d_inner
    st, dc, dtr = cfg.ssm_state, cfg.ssm_conv, cfg.ssm_dt_rank
    dev = gen.device
    a = torch.arange(1, st + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": scaled_normal(gen, (d, 2 * di), dtype, _sc(d, 2 * di)),
        "conv_w": scaled_normal(gen, (dc, di), dtype, 0.2),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": scaled_normal(gen, (di, dtr + 2 * st), dtype,
                                _sc(di, dtr + 2 * st)),
        "dt_proj": scaled_normal(gen, (dtr, di), dtype, _sc(dtr, di)),
        "dt_bias": torch.zeros((di,), dtype=dtype, device=dev),
        "a_log": torch.log(a.repeat(di, 1)),                   # [di, st]
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": scaled_normal(gen, (di, d), dtype, _sc(di, d)),
    }


#: Parameters the served copy keeps in their dtype (``cast_params``): all
#: of Mamba's. The conv taps are used uncast, so the projections after the
#: conv are f32 products, and the prefill state recomputes ``in_proj``
#: uncast.
MAMBA_KEPT = frozenset({"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                        "dt_bias", "a_log", "d_skip", "out_proj"})


@dataclasses.dataclass
class MambaState:
    conv: torch.Tensor   # [B, dc-1, di] rolling conv inputs
    ssm: torch.Tensor    # [B, di, st] float32

    @classmethod
    def zeros(cls, b, cfg: ArchConfig, dtype, device=None):
        return cls(torch.zeros((b, cfg.ssm_conv - 1, cfg.ssm_d_inner),
                               dtype=dtype, device=device),
                   torch.zeros((b, cfg.ssm_d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=device))


def mamba_scan(params, xc: torch.Tensor, cfg: ArchConfig,
               h0: torch.Tensor):
    """The selective scan of post-conv activations xc [B, S, di]:
    projections to dt, B and C, then the recurrence (``selective_scan``).
    Returns (ys [B, S, di] f32, h_last [B, di, st])."""
    st, dtr = cfg.ssm_state, cfg.ssm_dt_rank
    xdbc = xc @ params["x_proj"].to(xc.dtype)                # [B,S,dtr+2st]
    dt = (xdbc[..., :dtr] @ params["dt_proj"].to(xdbc.dtype)
          + params["dt_bias"])
    dt = softplus(dt.float())                                 # [B,S,di]
    bmat = xdbc[..., dtr:dtr + st].float()                    # [B,S,st]
    cmat = xdbc[..., dtr + st:].float()                       # [B,S,st]
    a = -torch.exp(params["a_log"])                           # [di,st]
    return selective_scan(dt, bmat, cmat, xc.float(), a, h0)


def _mamba_inner(params, xc: torch.Tensor, z: torch.Tensor,
                 cfg: ArchConfig, h0: torch.Tensor):
    """xc: post-conv activations [B,S,di]; returns (y [B,S,di], h_last)."""
    ys, h_last = mamba_scan(params, xc, cfg, h0)
    y = ys + xc.float() * params["d_skip"]
    return y.to(xc.dtype) * silu(z), h_last


def mamba_forward(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    b = x.shape[0]
    xz = x @ params["in_proj"].to(x.dtype)
    xin, z = xz.chunk(2, dim=-1)
    xc = silu(causal_conv(xin, params["conv_w"]) + params["conv_b"])
    h0 = torch.zeros((b, cfg.ssm_d_inner, cfg.ssm_state),
                     dtype=torch.float32, device=x.device)
    y, _ = _mamba_inner(params, xc, z, cfg, h0)
    return y @ params["out_proj"].to(y.dtype)


def mamba_decode(params, x: torch.Tensor, state: MambaState,
                 cfg: ArchConfig) -> Tuple[torch.Tensor, MambaState]:
    """x: [B,1,D] one token; constant-size state update."""
    dc = cfg.ssm_conv
    xz = x @ params["in_proj"].to(x.dtype)
    xin, z = xz.chunk(2, dim=-1)                              # [B,1,di]
    hist = torch.cat([state.conv, xin], dim=1)                # [B,dc,di]
    xc = sum(hist[:, i] * params["conv_w"][i] for i in range(dc))[:, None]
    xc = silu(xc + params["conv_b"])
    y, h_last = _mamba_inner(params, xc, z, cfg, state.ssm)
    out = y @ params["out_proj"].to(y.dtype)
    return out, MambaState(conv=hist[:, 1:], ssm=h_last)


# ----------------------------------------------------------------------------
# RG-LRU (recurrentgemma, arXiv:2402.19427 §2.4)
# ----------------------------------------------------------------------------

def init_rglru(gen: torch.Generator, cfg: ArchConfig, dtype):
    d, w, dc = cfg.d_model, cfg.rglru_width, cfg.ssm_conv
    dev = gen.device
    return {
        "in_x": scaled_normal(gen, (d, w), dtype, _sc(d, w)),
        "in_gate": scaled_normal(gen, (d, w), dtype, _sc(d, w)),
        "conv_w": scaled_normal(gen, (dc, w), dtype, 0.2),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "w_input_gate": scaled_normal(gen, (w,), torch.float32, 0.5),
        "w_rec_gate": scaled_normal(gen, (w,), torch.float32, 0.5),
        "lambda_p": torch.full((w,), 2.0, dtype=torch.float32, device=dev),
        "out": scaled_normal(gen, (w, d), dtype, _sc(w, d)),
    }


#: Parameters the served copy keeps in their dtype: the conv taps and the
#: f32 gates, used uncast, and ``in_x``, uncast in the prefill state.
RGLRU_KEPT = frozenset({"in_x", "conv_w", "conv_b", "w_input_gate",
                        "w_rec_gate", "lambda_p"})


@dataclasses.dataclass
class RGLRUState:
    conv: torch.Tensor   # [B, dc-1, w]
    h: torch.Tensor      # [B, w] float32

    @classmethod
    def zeros(cls, b, cfg: ArchConfig, dtype, device=None):
        return cls(torch.zeros((b, cfg.ssm_conv - 1, cfg.rglru_width),
                               dtype=dtype, device=device),
                   torch.zeros((b, cfg.rglru_width), dtype=torch.float32,
                               device=device))


def _rglru_scan(params, xc: torch.Tensor, h0: torch.Tensor):
    """xc: [B,S,w] conv output; the gated diagonal recurrence
    (``rglru_scan``). Returns (hs [B,S,w], h_last [B,w]), f32."""
    return rglru_scan(xc.float(), params["w_input_gate"],
                      params["w_rec_gate"], params["lambda_p"], h0)


def rglru_forward(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    b = x.shape[0]
    xb = x @ params["in_x"].to(x.dtype)
    gate = x @ params["in_gate"].to(x.dtype)
    xc = causal_conv(xb, params["conv_w"]) + params["conv_b"]
    h0 = torch.zeros((b, cfg.rglru_width), dtype=torch.float32,
                     device=x.device)
    hs, _ = _rglru_scan(params, xc, h0)
    y = hs.to(x.dtype) * gelu(gate)
    return y @ params["out"].to(y.dtype)


def rglru_decode(params, x: torch.Tensor, state: RGLRUState,
                 cfg: ArchConfig) -> Tuple[torch.Tensor, RGLRUState]:
    dc = cfg.ssm_conv
    xb = x @ params["in_x"].to(x.dtype)                       # [B,1,w]
    gate = x @ params["in_gate"].to(x.dtype)
    hist = torch.cat([state.conv, xb], dim=1)
    xc = (sum(hist[:, i] * params["conv_w"][i] for i in range(dc))
          + params["conv_b"])[:, None]
    hs, h_last = _rglru_scan(params, xc, state.h)
    y = hs.to(x.dtype) * gelu(gate)
    return (y @ params["out"].to(y.dtype),
            RGLRUState(conv=hist[:, 1:], h=h_last))
