"""Architecture registry: ``get(name)`` / ``list_archs()`` resolve the 10
assigned architectures (one module per arch) plus test configs.

``reduced(cfg)`` derives the CI smoke variant mandated by the harness:
<=2 layers (hybrids keep one full pattern period), d_model<=512, <=4
experts — same family/code paths, laptop-scale shapes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "deepseek-67b", "qwen1_5-0_5b", "falcon-mamba-7b", "grok-1-314b",
    "internvl2-26b", "starcoder2-3b", "deepseek-v3-671b",
    "recurrentgemma-9b", "granite-3-2b", "musicgen-medium",
]

_ALIASES = {
    "qwen1.5-0.5b": "qwen1_5-0_5b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace(".", "_"))


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{canonical(name).replace('-', '_')}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ARCH_IDS)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Reduced smoke variant of the same family."""
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4) or 0
    kv = min(cfg.num_kv_heads, heads) or 0
    if heads and heads % max(kv, 1):
        kv = 1
    layers = len(cfg.hybrid_pattern) if cfg.hybrid_pattern else 2
    changes = dict(
        num_layers=max(2, layers),
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=min(cfg.head_dim, 64),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        local_window=min(cfg.local_window, 32),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        lru_width=min(cfg.rglru_width, d_model) if cfg.lru_width else 0,
        param_dtype="float32",
        activation_dtype="float32",
    )
    if cfg.num_experts:
        changes.update(num_experts=4, experts_per_token=2,
                       moe_d_ff=min(cfg.expert_d_ff, 128),
                       num_shared_experts=min(cfg.num_shared_experts, 1),
                       first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.use_mla:
        changes.update(q_lora_rank=64 if cfg.q_lora_rank else 0,
                       kv_lora_rank=64, qk_nope_head_dim=32,
                       qk_rope_head_dim=16, v_head_dim=32)
    if cfg.mtp_depth:
        changes.update(mtp_depth=1)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **changes)
