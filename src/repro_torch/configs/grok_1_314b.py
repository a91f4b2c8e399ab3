"""Grok-1 314B: MoE 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe", source="hf:xai-org/grok-1",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=32768, vocab_size=131072,
    num_experts=8, experts_per_token=2, moe_d_ff=32768,
    sliding_window=4096, param_dtype="bfloat16",
)
