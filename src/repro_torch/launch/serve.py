"""Model serving with Fograph-style request placement, on a CUDA card.

The paper's technique applied to the transformer substrate: generation
requests are the data points and serving pods the fog nodes.

  * each pod is profiled with the paper's proxy-guided profiler (latency
    ~ beta . <batch, total cache tokens> + eps, the transformer analogue of
    omega(<|V|, |N_V|>));
  * request batches are matched to heterogeneous pods through the same
    PLACEMENTS registry as the GNN fog path: "iep" resolves to the LBAP
    bottleneck solver (min-max completion, Eq. 7), "metis+greedy" and
    "random" to the paper's baselines;
  * every batch runs a real prefill plus greedy decode loop on the device.

``serve(cfg, ...)`` runs it; ``main`` parses the reference's flags
(plus ``--device``) into it:

  python -m repro_torch.launch.serve --full            # qwen1.5-0.5b, card
  python -m repro_torch.launch.serve --device cpu      # reduced, CPU
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --full

``--arch`` takes any of the ten configs; a full config must fit the card
(deepseek-v3-671b and grok-1-314b do not: a caller cuts their depth with
``dataclasses.replace(cfg, num_layers=...)`` and calls ``serve``).

Runs eagerly under ``torch.inference_mode()``. The model's attention runs
``cfg.attn_impl``; the command line's config keeps the reference's default
(``"chunked"``), and a caller picks the flash kernel with
``dataclasses.replace(cfg, attn_impl="flash")``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.engine import resolve_device
from repro_torch.configs import registry
from repro_torch.core.placement import PLACEMENTS  # registers strategies
from repro_torch.core.profiler import LatencyModel, fit_latency_model
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig


@dataclass
class Pod:
    """A serving pod: the capability factor models heterogeneous hardware
    generations (the paper's type A/B/C fogs)."""
    name: str
    speed: float                     # relative decode throughput
    queue: List[int] = field(default_factory=list)
    model: LatencyModel = None


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    done: List[int] = field(default_factory=list)


def profile_pods(pods: List[Pod], base_step_s: float) -> None:
    """Offline profiling: fit omega(<batch, cache_tokens>) per pod."""
    cards, all_lat = [], {p.name: [] for p in pods}
    for b in (1, 2, 4, 8):
        for t in (64, 256, 1024):
            cards.append((b, t))
            for p in pods:
                lat = base_step_s * (0.5 + 0.05 * b + t / 4096) / p.speed
                all_lat[p.name].append(lat)
    for p in pods:
        p.model = fit_latency_model(cards, all_lat[p.name])


def place_batches(batches, pods, placement: str = "iep",
                  seed: int = 0) -> np.ndarray:
    """Batch -> pod matching via a PLACEMENTS registry strategy (Eq. 7/8).
    Rows past the batches and columns past the pods are zero-cost
    padding of the square assignment."""
    n = max(len(batches), len(pods))
    cost = np.zeros((n, n))
    for k in range(n):
        for j in range(n):
            if k >= len(batches) or j >= len(pods):
                cost[k, j] = 0.0
            else:
                b = batches[k]
                cache = sum(len(r.prompt) + r.max_new for r in b)
                cost[k, j] = pods[j].model.predict((len(b), cache))
    return PLACEMENTS.resolve(placement).match(cost, seed=seed)


def make_requests(cfg: ArchConfig, n: int, tokens: int,
                  seed: int = 0) -> List[Request]:
    """The reference's requests: prompts of 4-16 random token ids."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(4, 17))).astype(
        np.int32), tokens) for i in range(n)]


def serve(cfg: ArchConfig, *, requests: int = 24, tokens: int = 16,
          pods: str = "1.0,1.6,2.4", batch_size: int = 4,
          placement: str = "iep", device="cuda", params=None,
          log: Optional[Callable[[str], None]] = print) -> Dict:
    """Serve ``requests`` generation requests of ``tokens`` tokens each with
    ``cfg`` on ``device``: greedy batches of ``batch_size``, matched to the
    pods (comma-separated speed factors) round by round, each batch a
    prefill of its left-padded prompts plus ``tokens - 1`` decode steps.

    ``params`` are the model's parameters (``transformer.init_params`` /
    ``params_from_numpy``); by default they are drawn from a
    ``torch.Generator`` seeded with 0 on ``device``. They are served as a
    copy in the activation dtype (``transformer.cast_params``). The
    requests are the reference's, from a numpy generator seeded with 0.

    Returns the requests (each with its generated ``done`` tokens),
    per-batch prefill and decode times (host clock ending in a device
    sync), tokens per second and the simulated pods' busy seconds with
    their bottleneck / mean ratio.
    """
    dev = resolve_device(device)
    say = log or (lambda _msg: None)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = tf.init_params(cfg, gen)
    params = tf.cast_params(params, cfg)
    reqs = make_requests(cfg, requests, tokens)
    pod_list = [Pod(f"pod{i}({s})", float(s))
                for i, s in enumerate(pods.split(","))]
    profile_pods(pod_list, base_step_s=0.02)

    # Greedy batching, then heterogeneity-aware placement rounds.
    batches = [reqs[i:i + batch_size]
               for i in range(0, len(reqs), batch_size)]
    say(f"serving {len(reqs)} requests in {len(batches)} batches over "
        f"{len(pod_list)} heterogeneous pods ({cfg.name})")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings = []
    sim_pod_busy = np.zeros(len(pod_list))
    round_idx = 0
    sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        while batches:
            take = batches[:len(pod_list)]
            mapping = place_batches(take, pod_list, placement=placement,
                                    seed=round_idx)
            for k, batch in enumerate(take):
                j = int(mapping[k]) if int(mapping[k]) < len(pod_list) else 0
                pod = pod_list[j]
                # Real decode: prompts left-padded with token 0, no mask.
                plen = max(len(r.prompt) for r in batch)
                toks = np.zeros((len(batch), plen), np.int32)
                for bi, r in enumerate(batch):
                    toks[bi, plen - len(r.prompt):] = r.prompt
                tb = time.perf_counter()
                logits, caches = tf.prefill(
                    params, cfg, torch.as_tensor(toks, device=dev),
                    cache_len=plen + tokens)
                tok = torch.argmax(logits[:, -1:], dim=-1)
                out = [tok]
                sync()
                tp = time.perf_counter()
                for step in range(tokens - 1):
                    logits, caches = tf.decode_step(params, cfg, caches, tok,
                                                    plen + step)
                    tok = torch.argmax(logits[:, -1:], dim=-1)
                    out.append(tok)
                generated = torch.cat(out, dim=1).cpu().numpy()
                td = time.perf_counter()
                for r, row in zip(batch, generated):
                    r.done.extend(int(t) for t in row)
                timings.append({"batch": len(timings), "pod": j,
                                "requests": len(batch), "prompt_len": plen,
                                "prefill_ms": (tp - tb) * 1e3,
                                "decode_ms": (td - tp) * 1e3,
                                "decode_steps": tokens - 1})
                # Simulated pod wall-time accounting (heterogeneity).
                cache = sum(len(r.prompt) + r.max_new for r in batch)
                sim_pod_busy[j] += tokens * pod.model.predict(
                    (len(batch), cache))
            batches = batches[len(pod_list):]
            round_idx += 1
    wall = time.perf_counter() - t0

    done = sum(len(r.done) for r in reqs)
    ratio = float(sim_pod_busy.max() / max(sim_pod_busy.mean(), 1e-9))
    say(f"generated {done} tokens in {wall:.1f}s wall "
        f"({done / wall:.1f} tok/s real decode)")
    say(f"simulated pod busy-seconds (balance): {np.round(sim_pod_busy, 3)}")
    say(f"bottleneck/mean ratio: {ratio:.3f} (1.0 = perfectly balanced)")
    return {"requests": reqs, "batches": timings,
            "tokens": done, "wall_s": wall, "tokens_per_s": done / wall,
            "sim_pod_busy_s": sim_pod_busy, "bottleneck_ratio": ratio,
            "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--full", action="store_true",
                    help="full config; default reduced")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--pods", default="1.0,1.6,2.4",
                    help="comma-separated pod speed factors")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--placement", default="iep",
                    help="PLACEMENTS registry key for batch->pod matching "
                         f"(available: {', '.join(PLACEMENTS.keys())})")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (the default) needs a card")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if not args.full:
        cfg = registry.reduced(cfg)
    serve(cfg, requests=args.requests, tokens=args.tokens, pods=args.pods,
          batch_size=args.batch_size, placement=args.placement,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
