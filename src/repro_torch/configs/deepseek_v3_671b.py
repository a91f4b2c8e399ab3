"""DeepSeek-V3 671B: MLA + 1 shared / 256 routed top-8 MoE + MTP
[arXiv:2412.19437]. First 3 layers dense (d_ff 18432); expert width 2048.

bf16 params + bf16 moments: 671B at f32 AdamW (12 B/param = 8 TB) exceeds a
256-chip v5e pod's 4 TB HBM — physically, not as an artifact of sharding.
See EXPERIMENTS.md §Dry-run notes."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe", source="arXiv:2412.19437",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=18432, vocab_size=129280,
    num_experts=256, experts_per_token=8, num_shared_experts=1,
    moe_d_ff=2048, first_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mtp_depth=1, sliding_window=4096, param_dtype="bfloat16",
)
