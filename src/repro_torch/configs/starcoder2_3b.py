"""StarCoder2-3B: dense GQA kv=2, RoPE, non-gated GELU MLP
[arXiv:2402.19173]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense", source="arXiv:2402.19173",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    head_dim=128, d_ff=12288, vocab_size=49152,
    rope_theta=100000.0, sliding_window=4096,
)
