"""MusicGen-medium decoder over EnCodec tokens [arXiv:2306.05284].
Sinusoidal positions, non-gated GELU MLP; the EnCodec frontend is a stub —
input_specs() supplies codec token ids (the decoder's true input)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio", source="arXiv:2306.05284",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    head_dim=64, d_ff=6144, vocab_size=2048,
    pos_embedding="sinusoidal", sliding_window=4096,
)
