"""RecurrentGemma-9B: RG-LRU + local attention 1:2 hybrid (Griffin)
[arXiv:2402.19427]. MQA (kv=1) with head_dim 256; window 2048."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", source="arXiv:2402.19427",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000,
    hybrid_pattern=("rglru", "rglru", "local_attn"), local_window=2048,
    lru_width=4096, ssm_conv=4,
)
