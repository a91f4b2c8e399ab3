"""The plain reference: a GNN forward over the whole graph, and the check.

Plain PyTorch over the benchmark's own arrays: the graph from
``graphgen``, the weights and snapshots that ``run.py`` draws from the
seed. It imports nothing of the program and reads nothing the program
made. A model kind's layer lives in its own file (``bench/models/<kind>.py``,
``layer``), which follows Table I of the paper as the port states it
(``gnn/layers.py``); ``forward`` runs the layers, with no activation after
the last one.

With ``wire`` (the 8-bit halo wire of a DAQ plan) a message whose source
and receiver sit on different fogs carries the source row quantized per
row to uint8 codes with one f32 (scale, min) pair, rounding half to even,
the arithmetic done in f32 as the wire does it; every other message is
exact. A kind models the wire only where its file has ``wire_slack``.

The wire's rounding of a row is only as exact as the row: where the
program's float32 layer input and the reference's differ in the last bit
and a value sits on a code's rounding edge, either code is right. Layer 1
reads the snapshot itself, the same floats on both sides, so its codes
agree; for a last layer linear in its messages, ``slack`` bounds what
those edge codes can move each output (``excess`` is the gap beyond it).
The model has to be two layers deep for that.

``precision``: ``"float64"`` for the reference; ``"tf32"`` for the control,
float32 with every matrix product's operands rounded to TF32 (10 explicit
mantissa bits), the precision a float32 deployment would be tempted to
drop to. The rounding is explicit so that the control is the same on any
device.
"""
from __future__ import annotations

from types import ModuleType
from typing import Sequence

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32: 13 low mantissa bits dropped, to
    nearest (ties away from zero, as the conversion of the tensor cores)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        return tf32_round(a) @ tf32_round(b)
    return a @ b


def wire_roundtrip(h: torch.Tensor, levels: float = 255.0) -> torch.Tensor:
    """Rows of ``h`` as the 8-bit wire delivers them: quantized per row in
    float32 (codes clamp(round((h - min) / scale)), scale = max(max - min,
    1e-12) / 255), dequantized as code * scale + min in ``h``'s dtype."""
    hf = h.float()
    mins = hf.amin(dim=-1)
    scales = torch.clamp_min(hf.amax(dim=-1) - mins, 1e-12) / levels
    codes = torch.clamp(torch.round((hf - mins[:, None]) / scales[:, None]),
                        0, levels)
    return (codes.to(h.dtype) * scales.to(h.dtype)[:, None]
            + mins.to(h.dtype)[:, None])


class Graph:
    """The edges of ``graphgen``'s arrays on ``device``: receivers'
    in-degrees, and with ``assignment`` the edges that cross fogs."""

    def __init__(self, g: dict, device, assignment=None):
        self.v = int(g["num_vertices"])
        self.s = torch.as_tensor(g["senders"], device=device).long()
        self.r = torch.as_tensor(g["receivers"], device=device).long()
        self.deg = torch.bincount(self.r, minlength=self.v)
        self.cross = None
        if assignment is not None:
            a = torch.as_tensor(assignment, device=device)
            self.cross = a[self.s] != a[self.r]
        loop = torch.arange(self.v, device=device)
        self.s_loop = torch.cat([self.s, loop])
        self.r_loop = torch.cat([self.r, loop])


#: how near (in code units) to a rounding edge a quantized value counts
#: as on it: far above what a last-bit difference of the row moves it
#: (255 x a few float32 ulps of the row's range, ~1e-4).
EDGE = 1e-3


def wire_slack(h: torch.Tensor, w: torch.Tensor, g: Graph,
               levels: float = 255.0) -> torch.Tensor:
    """[V, D]: for a last layer linear in its messages, with input ``h``
    and weight ``w`` (a neighbour sum over ``|N(v)| + 1`` before ``w``),
    the most by which codes on a rounding edge (see ``EDGE``) can move
    each output: one code step (the row's scale) through ``|w|`` for every
    such feature of every row that reaches the receiver over the wire."""
    hf = h.float()
    mins = hf.amin(dim=-1)
    scales = torch.clamp_min(hf.amax(dim=-1) - mins, 1e-12) / levels
    x = (h - mins.to(h.dtype)[:, None]) / scales.to(h.dtype)[:, None]
    edge = (x - torch.floor(x) - 0.5).abs() < EDGE
    per_row = (edge.to(h.dtype) @ w.abs().to(h.dtype)) \
        * scales.to(h.dtype)[:, None]
    out = torch.zeros((g.v, w.shape[1]), dtype=h.dtype, device=h.device)
    out.index_add_(0, g.r[g.cross], per_row[g.s[g.cross]])
    return out / (g.deg.to(h.dtype) + 1.0)[:, None]


def forward(kind: ModuleType, params: Sequence[dict], x: torch.Tensor,
            g: Graph, *, wire: bool = False, precision: str = "float64",
            with_slack: bool = False):
    """[V, F] features -> [V, D] embeddings through the layers of ``kind``
    (a model file, ``bench/models/<kind>.py``) and, ``with_slack``, the
    wire's slack of the last layer (``kind.wire_slack``), zeros without
    the wire."""
    if precision not in ("float64", "tf32"):
        raise ValueError(precision)
    if wire and not hasattr(kind, "wire_slack"):
        raise ValueError(f"{kind.__name__}: the 8-bit wire is modelled only "
                         f"for a kind whose file has wire_slack")
    if wire and g.cross is None:
        raise ValueError("the 8-bit wire needs the fog assignment")
    if wire and len(params) != 2:
        raise ValueError("the wire's slack is modelled for two layers")
    tf32 = precision == "tf32"
    dtype = torch.float32 if tf32 else torch.float64
    h = x.to(dtype)
    slack = None
    for li, p in enumerate(params):
        p = {k: v.to(dtype) for k, v in p.items()}
        last = li == len(params) - 1
        if last and with_slack and wire:
            slack = kind.wire_slack(p, h, g)
        h = kind.layer(p, h, g, last=last, wire=wire, tf32=tf32)
    if with_slack and slack is None:
        slack = torch.zeros_like(h)
    return (h, slack) if with_slack else h


def excess(got: torch.Tensor, want: torch.Tensor,
           slack: torch.Tensor) -> float:
    """The widest gap between two embedding tables beyond ``slack``, as a
    share of the reference's largest magnitude."""
    want = want.double()
    over = torch.clamp_min((got.double() - want).abs() - slack.double(), 0)
    return float(over.max() / torch.clamp_min(want.abs().max(), 1e-30))
