"""Falcon-Mamba-7B: attention-free Mamba-1 SSM [arXiv:2410.05355]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm", source="arXiv:2410.05355",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024, pos_embedding="none",
    ssm_state=16, ssm_conv=4, ssm_expand=2, dt_rank=256,
)
