"""What a run feeds the program, drawn from ``--seed``: the GNN's weights
and the sensor snapshots, made on the run's device in a few large calls,
and the traffic's stacked micro-batches.

Weights are Glorot draws laid out as the port's per-layer dicts, in the
order and shapes the model kind's file gives (``bench/models/<kind>.py``,
``weight_shapes``). A snapshot is one reading of every sensor: every row
is drawn anew, so every vertex is dirty. The configuration names the
snapshot's kind:

  ``onehot_blocks``  categorical attributes, one-hot in ``blocks`` equal
                     blocks (SIoT's device type / brand / mobility fields)
  ``around_graph``   the graph's own features plus ``sigma`` times a
                     standard normal draw (RMAT's Node2Vec-like features)

The traffic's ``pool`` snapshots are cut into ``stacks`` float32
[``batch``, V, F] host arrays, each a seed-drawn choice of distinct
snapshots: what a ``Server`` hands ``Session.execute_many``.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch


def generators(seed: int, device) -> Tuple[torch.Generator,
                                           np.random.Generator]:
    """The device generator and the host generator of a run's ``seed``
    (any whole number; taken modulo 2**63)."""
    seed = int(seed) % (1 << 63)
    return (torch.Generator(device=device).manual_seed(seed),
            np.random.default_rng(seed))


def make_weights(shapes: Sequence[Tuple[int, str, tuple, float]],
                 gen: torch.Generator) -> List[dict]:
    """One uniform draw for every weight of ``shapes`` ([(layer, name,
    shape, glorot limit)] in draw order), cut into the per-layer dicts;
    a bias is zero (its limit)."""
    sizes = [math.prod(s) for _, _, s, _ in shapes]
    flat = torch.rand(sum(sizes), generator=gen, device=gen.device,
                      dtype=torch.float32) * 2.0 - 1.0
    params = [{} for _ in range(1 + max(li for li, _, _, _ in shapes))]
    for (li, name, shape, lim), part in zip(shapes, flat.split(sizes)):
        params[li][name] = (part * lim).reshape(shape).clone()
    return params


def make_snapshots(spec: dict, features: np.ndarray, count: int,
                   gen: torch.Generator) -> torch.Tensor:
    """[count, V, F] float32 snapshots on the generator's device."""
    v, f = features.shape
    dev = gen.device
    if spec["kind"] == "onehot_blocks":
        blocks = int(spec["blocks"])
        if f % blocks:
            raise ValueError(f"{f} features do not cut into {blocks} blocks")
        width = f // blocks
        cat = torch.randint(0, width, (count, v, blocks), generator=gen,
                            device=dev)
        cat = cat + torch.arange(blocks, device=dev) * width
        out = torch.zeros((count, v, f), dtype=torch.float32, device=dev)
        return out.scatter_(2, cat, 1.0)
    if spec["kind"] == "around_graph":
        base = torch.as_tensor(features, device=dev)
        noise = torch.randn((count, v, f), generator=gen, device=dev,
                            dtype=torch.float32)
        return base + float(spec["sigma"]) * noise
    raise ValueError(f"unknown snapshot kind {spec['kind']!r}")


def make_stacks(pool: torch.Tensor, traffic: dict,
                rng: np.random.Generator):
    """[(pool indices, host [batch, V, F] float32 array)] of the traffic:
    ``stacks`` micro-batches of ``batch`` distinct snapshots each."""
    n, batch = pool.shape[0], int(traffic["batch"])
    if batch > n:
        raise ValueError(f"a batch of {batch} from a pool of {n}")
    out = []
    for _ in range(int(traffic["stacks"])):
        idx = rng.choice(n, size=batch, replace=False)
        feats = pool[torch.as_tensor(idx, device=pool.device)].cpu().numpy()
        out.append((idx, feats))
    return out
