"""Architecture configuration schema for the serving/training substrate.

One ``ArchConfig`` describes any of the assigned architecture families:
dense GQA decoders, MoE (top-k routed, optional shared expert, optional MLA
latent attention, optional MTP head), SSM (Mamba-1), hybrid (RG-LRU + local
attention), and the VLM/audio decoders whose modality frontends are stubs
(the harness carve-out: ``input_specs`` hands the decoder precomputed
patch/frame embeddings of the right shape).

Layers are described as a sequence of *stages*: ``(group, repeats)`` where
``group`` is a short tuple of LayerSpecs. The port runs the layers in a
Python loop over per-layer parameters; the stages survive as the layout
of the JAX package's stacked parameters, which
``models.transformer.params_from_numpy`` unstacks.

A copy of ``repro/models/config.py``: the port keeps its own, so it never
imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: a temporal mixer + an optional FFN."""
    mixer: str          # 'gqa' | 'mla' | 'mamba' | 'rglru' | 'local_attn'
    ffn: Optional[str]  # 'mlp' | 'moe' | None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    source: str                  # citation (paper / model card)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    pos_embedding: str = "rope"  # rope | sinusoidal | none
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0            # per-expert FFN width (defaults to d_ff)
    first_dense_layers: int = 0  # leading dense layers before MoE (dsv3: 3)
    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0         # 0 = no Q compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- MTP (deepseek-v3) ---
    mtp_depth: int = 0
    # --- SSM (mamba-1) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)
    # --- hybrid (recurrentgemma) ---
    hybrid_pattern: Tuple[str, ...] = ()   # e.g. ('rglru','rglru','local_attn')
    local_window: int = 2048
    lru_width: int = 0           # 0 -> d_model
    # --- serving ---
    sliding_window: int = 0      # >0: windowed-attention serve variant
    # --- modality frontend stub ---
    input_mode: str = "tokens"   # tokens | embeddings
    # --- numerics ---
    param_dtype: str = "float32"     # giants use bfloat16 (HBM budget)
    activation_dtype: str = "bfloat16"
    # --- attention implementation ---
    attn_impl: str = "chunked"   # chunked (XLA) | flash (Pallas kernel)

    # ------------------------------------------------------------------
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def rglru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def mlp_gated(self) -> bool:
        """SwiGLU/GeGLU (3 matrices) vs plain GELU MLP (2 matrices)."""
        return self.family != "audio" and not self.name.startswith(
            "starcoder2")

    def layer_specs(self) -> List[LayerSpec]:
        """Expanded per-layer specs."""
        out: List[LayerSpec] = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                out.append(LayerSpec("mamba", None))
            elif self.hybrid_pattern:
                mixer = self.hybrid_pattern[i % len(self.hybrid_pattern)]
                out.append(LayerSpec(mixer, "mlp"))
            elif self.num_experts:
                mixer = "mla" if self.use_mla else "gqa"
                ffn = "mlp" if i < self.first_dense_layers else "moe"
                out.append(LayerSpec(mixer, ffn))
            else:
                mixer = "mla" if self.use_mla else "gqa"
                out.append(LayerSpec(mixer, "mlp"))
        return out

    def stages(self) -> List[Tuple[Tuple[LayerSpec, ...], int]]:
        """Group layers into scan-able (group, repeats) stages.

        Periodic patterns (hybrid 1:2) group a full period; otherwise runs of
        identical specs form one stage each.
        """
        specs = self.layer_specs()
        if self.hybrid_pattern:
            p = len(self.hybrid_pattern)
            full = self.num_layers // p
            stages: List[Tuple[Tuple[LayerSpec, ...], int]] = []
            if full:
                stages.append((tuple(specs[:p]), full))
            rem = self.num_layers - full * p
            if rem:
                stages.append((tuple(specs[full * p:]), 1))
            return stages
        stages = []
        i = 0
        while i < len(specs):
            j = i
            while j < len(specs) and specs[j] == specs[i]:
                j += 1
            stages.append(((specs[i],), j - i))
            i = j
        return stages

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND model-FLOP accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for spec in self.layer_specs():
            if spec.mixer == "gqa" or spec.mixer == "local_attn":
                hd = self.head_dim
                total += d * self.num_heads * hd          # q
                total += 2 * d * self.num_kv_heads * hd    # k, v
                total += self.num_heads * hd * d           # o
            elif spec.mixer == "mla":
                r_kv, r_q = self.kv_lora_rank, self.q_lora_rank or self.d_model
                qk = self.qk_nope_head_dim + self.qk_rope_head_dim
                total += d * r_q + r_q * self.num_heads * qk
                total += d * (r_kv + self.qk_rope_head_dim)
                total += r_kv * self.num_heads * (self.qk_nope_head_dim
                                                  + self.v_head_dim)
                total += self.num_heads * self.v_head_dim * d
            elif spec.mixer == "mamba":
                di, st = self.ssm_d_inner, self.ssm_state
                total += d * 2 * di + self.ssm_conv * di
                total += di * self.ssm_dt_rank + self.ssm_dt_rank * di
                total += di * 2 * st + di + di * d
            elif spec.mixer == "rglru":
                w = self.rglru_width
                total += 2 * d * w + 2 * w * 4 + w * d + 3 * w
            if spec.ffn == "mlp":
                total += (3 if self.mlp_gated else 2) * d * f
            elif spec.ffn == "moe":
                fe = self.expert_d_ff
                total += 3 * d * fe * (self.num_experts
                                       + self.num_shared_experts)
                total += d * self.num_experts  # router
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        if not self.num_experts:
            return self.param_count()
        d, fe = self.d_model, self.expert_d_ff
        dense_all = self.param_count()
        moe_layers = sum(1 for s in self.layer_specs() if s.ffn == "moe")
        inactive = 3 * d * fe * (self.num_experts - self.experts_per_token)
        return int(dense_all - moe_layers * inactive)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
