"""DeepSeek-67B: dense llama-arch decoder [arXiv:2401.02954]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense", source="arXiv:2401.02954",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=22016, vocab_size=102400,
    rope_theta=10000.0, sliding_window=4096,  # serve variant for long_500k
)
