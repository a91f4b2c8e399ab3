"""End-to-end training loop, on a CUDA card.

The port of ``repro/launch/train.py``: a real training loop (synthetic
corpus -> train step -> checkpoints) for any ``--arch`` at the reduced
scale or at a ~25m / ~100m variant of the same family. It runs the whole
substrate: data pipeline, AdamW, remat and micro-batches, checkpoint and
resume. The parameters are drawn from a seeded ``torch.Generator`` on
the device; the loop runs eagerly.

  python -m repro_torch.launch.train --arch granite-3-2b \\
      --steps 200 --seq 256 --batch 8 --size 100m
  python -m repro_torch.launch.train --size reduced --steps 4 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.api.engine import resolve_device
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import registry
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models import transformer as tf
from repro_torch.models.config import InputShape
from repro_torch.optim.adamw import AdamW, warmup_cosine


def size_config(cfg, size: str):
    """Derive a ~25m / ~100m parameter variant of the same family."""
    presets = {
        "reduced": {},
        "25m": dict(num_layers=4, d_model=512, num_heads=8, num_kv_heads=4,
                    head_dim=64, d_ff=1536, vocab_size=8192),
        "100m": dict(num_layers=8, d_model=768, num_heads=12,
                     num_kv_heads=4, head_dim=64, d_ff=3072,
                     vocab_size=16384),
    }
    base = registry.reduced(cfg)
    if size == "reduced":
        return base
    kw = dict(presets[size])
    if cfg.num_heads == 0:  # SSM: no heads
        kw.update(num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0)
    if cfg.hybrid_pattern:
        kw["num_layers"] = max(len(cfg.hybrid_pattern),
                               kw["num_layers"] // len(cfg.hybrid_pattern)
                               * len(cfg.hybrid_pattern))
    if cfg.num_experts:
        kw.update(moe_d_ff=kw.get("d_ff", 1536) // 2)
    return dataclasses.replace(base, name=f"{cfg.name}-{size}", **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--size", default="25m",
                    choices=["reduced", "25m", "100m"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = size_config(registry.get(args.arch), args.size)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{n_dev} device(s)")
    shape = InputShape("train", seq_len=args.seq, global_batch=args.batch,
                       kind="train")
    corpus = SyntheticCorpus(cfg, shape, seed=0)
    opt = AdamW(learning_rate=warmup_cosine(args.lr, warmup=20,
                                            total=args.steps))
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    state = opt.init(params)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        start = ckpt.latest_step(args.ckpt_dir)
        restored = ckpt.restore(args.ckpt_dir,
                                {"params": params, "opt": state})
        params, state = restored["params"], restored["opt"]
        print(f"resumed from step {start}")

    step_fn = tf.make_train_step(cfg, opt, microbatches=args.microbatches)
    t0 = time.time()
    tokens = 0
    for i in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in corpus.batch(i).items()}
        params, state, metrics = step_fn(params, state, batch)
        tokens += args.batch * args.seq
        if (i + 1) % args.log_every == 0 or i == start:
            dt = time.time() - t0
            print(f"step {i + 1:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"tok/s {tokens / max(dt, 1e-9):,.0f}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i + 1,
                      {"params": params, "opt": state})
    print(f"done: {args.steps - start} steps in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
