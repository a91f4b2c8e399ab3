"""InternVL2-26B language decoder (InternLM2-20B backbone) with stubbed
InternViT-6B frontend [arXiv:2404.16821]. input_specs() supplies patch
embeddings — the harness VLM carve-out."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm", source="arXiv:2404.16821",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=16384, vocab_size=92553,
    input_mode="embeddings", sliding_window=4096,
)
