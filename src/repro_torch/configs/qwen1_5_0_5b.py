"""Qwen1.5-0.5B: dense decoder with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense", source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    head_dim=64, d_ff=2816, vocab_size=151936, qkv_bias=True,
    rope_theta=1_000_000.0, sliding_window=4096,
)
