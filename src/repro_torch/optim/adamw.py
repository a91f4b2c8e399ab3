"""AdamW with decoupled weight decay and a warmup-cosine schedule.

The port of ``repro/optim/adamw.py``, as plain tensor code over the
port's nested parameter dictionaries (``torch.optim.AdamW`` places ``eps``
and the decay otherwise). The schedule and the bias corrections are f32
tensors on the parameters' device, as in the reference; every division by
one of them is a true division (a Python-number divisor would be a
product with its reciprocal on the card).

Unlike the reference, ``apply`` updates the parameters and the moments in
place and returns them: a full-width model holds its parameters, their
gradients and two moments, and a second copy of any of them would not fit
beside them on one card. A caller that needs the old values copies them
first.

The decay rule, and a trap: the reference decays a leaf when
``p.ndim >= 2`` (adamw.py:69), and it stacks every stage parameter on a
leading repeat axis (``jax.vmap(init_one)``, transformer.py:77-83). So the
reference decays every leaf of every layer, the norm scales, biases,
``conv_b``, ``lambda_p``, ``d_skip`` and gate vectors included, and leaves
``final_norm`` and the MTP block's 1-D leaves (which are not stacked)
undecayed. The port keeps its layers apart (``params["layers"][i]``), so it
decides on the reference's stacked rank: ``p.ndim + 1`` for a leaf under
``layers``, ``p.ndim`` elsewhere (``decayed``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.models.config import ArchConfig


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 []
    m: Any
    v: Any


def decayed(path: tuple, p: torch.Tensor) -> bool:
    """Whether the reference decays the leaf at ``path`` (a pytree key
    path): its rank in the reference's tree (one more under ``layers``,
    whose leaves the reference stacks) is at least 2."""
    stacked = bool(path) and getattr(path[0], "key", None) == "layers"
    return p.ndim + stacked >= 2


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable:
    """lr(step): linear warmup to ``base_lr`` over ``warmup`` steps, then a
    cosine down to ``final_frac * base_lr`` at ``total``; an f32 tensor on
    the step's device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        dev = step.device
        step = step.float()
        warm = base_lr * step / torch.tensor(float(max(warmup, 1)),
                                             device=dev)
        prog = torch.clamp((step - warmup) / torch.tensor(
            float(max(total - warmup, 1)), device=dev), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Any = 3e-4          # float or schedule fn
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"

    def _mdtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.moment_dtype]

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self._mdtype(), device=p.device)

        device = pytree.tree_leaves(params)[0].device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=pytree.tree_map(zeros, params),
            v=pytree.tree_map(zeros, params))

    def apply(self, params, grads, state: AdamWState):
        """One AdamW step: updates the parameters and moments in place
        (the reference's arithmetic, each operation rounded alike) and
        returns (params, state)."""
        step = state.step + 1
        dev = step.device
        lr = (self.learning_rate(step) if callable(self.learning_rate)
              else torch.tensor(self.learning_rate, dtype=torch.float32,
                                device=dev))
        b1, b2 = self.b1, self.b2
        stepf = step.float()
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        f32 = torch.float32
        for (path, p), g, m, v in zip(
                pytree.tree_flatten_with_path(params)[0],
                pytree.tree_leaves(grads), pytree.tree_leaves(state.m),
                pytree.tree_leaves(state.v)):
            g = g.float()
            # m32 = m b1 + (1 - b1) g;  v32 = v b2 + ((1 - b2) g) g
            m32 = m.mul_(b1) if m.dtype == f32 else m.float().mul_(b1)
            m32.add_(g * (1 - b1))
            v32 = v.mul_(b2) if v.dtype == f32 else v.float().mul_(b2)
            v32.add_((g * (1 - b2)).mul_(g))
            # delta = (m32 / bc1) / (sqrt(v32 / bc2) + eps)
            delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(self.eps))
            if decayed(path, p):
                delta.add_(p.float() * self.weight_decay)
            delta.mul_(lr)
            if p.dtype == f32:
                p.sub_(delta)
            else:
                p.copy_((p.float() - delta).to(p.dtype))
            if m.dtype != f32:
                m.copy_(m32.to(m.dtype))
                v.copy_(v32.to(v.dtype))
        return params, AdamWState(step=step, m=state.m, v=state.v)


def state_from_numpy(state, cfg: ArchConfig, device="cpu") -> AdamWState:
    """The port's optimizer state from the JAX package's ``AdamWState``
    turned to numpy (``jax.tree_util.tree_map(np.asarray, state)``): the
    moments unstacked as ``params_from_numpy`` unstacks parameters."""
    from repro_torch.models.transformer import params_from_numpy
    return AdamWState(
        step=torch.tensor(int(state.step), dtype=torch.int32, device=device),
        m=params_from_numpy(state.m, cfg, device),
        v=params_from_numpy(state.v, cfg, device))
