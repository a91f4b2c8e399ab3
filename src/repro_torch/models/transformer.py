"""Decoder transformer for every configuration: parameters, forward,
prefill and decode.

The port of ``repro/models/transformer.py``. A layer is one temporal mixer
(``gqa``, ``local_attn``, ``mla``, ``mamba`` or ``rglru``) and an optional
FFN (``mlp`` or ``moe``), by ``cfg.layer_specs()``; DeepSeek-V3's MTP head
(``params["mtp"]``) is built with the trunk. Entry points share one
parameter dictionary:

  * ``forward``      full-sequence logits (and the MoE auxiliary loss)
  * ``prefill``      full-sequence pass that returns the last token's
                     logits and the decode caches
  * ``decode_step``  one token against the caches

Parameters are per layer (``params["layers"][i]``, its kind
``cfg.layer_specs()[i]``) and the layers run in a Python loop: the
reference's stacked stages exist only to keep XLA's program small.
``params_from_numpy`` unstacks the JAX package's tree. The VLM / audio
frontends are stubs that hand over [B, S, D] embeddings. Training
(``loss_fn``, ``make_train_step``, the MTP loss) is not ported: ROADMAP
Queue 1 item 6b. The reference's ``constrain_batch`` is a no-op without
a device mesh and is dropped.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.layers import (dtype_of, embed, init_embed,
                                       init_linear, init_mlp, init_rms,
                                       linear, mlp, promoted_matmul,
                                       rms_norm, silu, sinusoidal_embedding,
                                       unembed)


def _activation(ffn_params) -> str:
    return "silu" if "w_gate" in ffn_params else "gelu"


def _mtp_spec(cfg: ArchConfig) -> LayerSpec:
    return LayerSpec("mla" if cfg.use_mla else "gqa", "mlp")


# ----------------------------------------------------------------------------
# Parameter construction
# ----------------------------------------------------------------------------

def _init_mixer(gen: torch.Generator, spec: LayerSpec, cfg: ArchConfig,
                dtype):
    if spec.mixer in ("gqa", "local_attn"):
        return attn.init_gqa(gen, cfg, dtype)
    if spec.mixer == "mla":
        return attn.init_mla(gen, cfg, dtype)
    if spec.mixer == "mamba":
        return ssm_lib.init_mamba(gen, cfg, dtype)
    if spec.mixer == "rglru":
        return ssm_lib.init_rglru(gen, cfg, dtype)
    raise ValueError(spec.mixer)


def _init_block(gen: torch.Generator, spec: LayerSpec, cfg: ArchConfig,
                dtype):
    p = {"norm1": init_rms(cfg.d_model, dtype, gen.device),
         "mixer": _init_mixer(gen, spec, cfg, dtype)}
    if spec.ffn is not None:
        p["norm2"] = init_rms(cfg.d_model, dtype, gen.device)
        p["ffn"] = (moe_lib.init_moe(gen, cfg, dtype) if spec.ffn == "moe"
                    else init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                  gated=cfg.mlp_gated))
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters of ``cfg`` in ``cfg.param_dtype`` from ``gen``, on
    the generator's device: the reference's shapes, dtypes and scales,
    other numbers (a ``torch.Generator``)."""
    dtype = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dtype),
        "layers": [_init_block(gen, spec, cfg, dtype)
                   for spec in cfg.layer_specs()],
        "final_norm": init_rms(cfg.d_model, dtype, gen.device)}
    if not cfg.tie_embeddings:
        params["head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, dtype)
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": init_linear(gen, 2 * cfg.d_model, cfg.d_model, dtype),
            "block": _init_block(gen, _mtp_spec(cfg), cfg, dtype),
            "norm": init_rms(cfg.d_model, dtype, gen.device)}
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_numpy(tree, cfg: ArchConfig, device="cpu") -> Dict[str, Any]:
    """The port's parameters from the JAX package's ``init_params`` tree
    turned to numpy (``jax.tree_util.tree_map(np.asarray, params)``).

    The reference stacks each stage's layers on a leading repeat axis
    (``jax.vmap`` over the stage's keys, one dict per spec of the stage's
    group); they are unstacked here into the per-layer list, in layer
    order, so both packages compute the same function of the same numbers.
    The MTP sub-tree (one block, not stacked) carries across as it is.
    """
    def to_torch(a):
        return torch.tensor(np.asarray(a), device=device)

    layers: List[dict] = []
    for (group, repeats), stage in zip(cfg.stages(), tree["stages"]):
        for r in range(repeats):
            for block in stage:   # one dict per spec of the group
                layers.append(_tree_map(lambda a: to_torch(a[r]), block))
    out = {"embed": _tree_map(to_torch, tree["embed"]), "layers": layers,
           "final_norm": to_torch(tree["final_norm"])}
    for key in ("head", "mtp"):
        if key in tree:
            out[key] = _tree_map(to_torch, tree[key])
    return out


#: Per (block key, kind), the parameters that the reference uses uncast
#: somewhere (or casts to an f32 tensor's dtype): they keep their dtype in
#: the served copy. Each module lists its own, beside their uses.
_KEPT = {("mixer", "mamba"): ssm_lib.MAMBA_KEPT,
         ("mixer", "rglru"): ssm_lib.RGLRU_KEPT,
         ("mixer", "mla"): attn.MLA_KEPT,
         ("ffn", "moe"): moe_lib.MOE_KEPT}


def _cast_block(p: dict, spec: LayerSpec, dt) -> dict:
    def cast(t):
        return t.to(dt) if t.is_floating_point() else t

    kinds = {"mixer": spec.mixer, "ffn": spec.ffn}
    out = {}
    for key, value in p.items():
        kept = _KEPT.get((key, kinds.get(key)), frozenset())
        out[key] = ({k: v if k in kept else _tree_map(cast, v)
                     for k, v in value.items()} if kept
                    else _tree_map(cast, value))
    return out


def cast_params(params: Dict[str, Any], cfg: ArchConfig) -> Dict[str, Any]:
    """A copy of ``params`` for serving, each parameter that every use in
    the reference casts to the activation dtype cast to it once: the copy
    gives bitwise the numbers of ``params`` without a cast per step. The
    rest keep their dtype: a tied embedding table (``unembed`` promotes)
    and what ``_KEPT`` lists (the MoE router among them)."""
    dt = dtype_of(cfg.activation_dtype)

    def cast(t):
        return t.to(dt) if t.is_floating_point() else t

    out = {k: _tree_map(cast, v) for k, v in params.items()
           if k not in ("embed", "layers", "mtp")}
    out["layers"] = [_cast_block(p, spec, dt)
                     for p, spec in zip(params["layers"], cfg.layer_specs())]
    if "mtp" in params:
        mtp = params["mtp"]
        out["mtp"] = {"proj": _tree_map(cast, mtp["proj"]),
                      "norm": cast(mtp["norm"]),
                      "block": _cast_block(mtp["block"], _mtp_spec(cfg), dt)}
    table = params["embed"]["table"]
    out["embed"] = {"table": table if cfg.tie_embeddings else table.to(dt)}
    return out


# ----------------------------------------------------------------------------
# Block application
# ----------------------------------------------------------------------------

def _mixer_forward(p, spec: LayerSpec, x: torch.Tensor, cfg: ArchConfig,
                   window: int) -> torch.Tensor:
    if spec.mixer == "gqa":
        return attn.gqa_forward(p, x, cfg, window=window)
    if spec.mixer == "local_attn":
        return attn.gqa_forward(p, x, cfg, window=cfg.local_window)
    if spec.mixer == "mla":
        return attn.mla_forward(p, x, cfg, window=window)
    if spec.mixer == "mamba":
        return ssm_lib.mamba_forward(p, x, cfg)
    if spec.mixer == "rglru":
        return ssm_lib.rglru_forward(p, x, cfg)
    raise ValueError(spec.mixer)


def _ffn(p, spec: LayerSpec, x: torch.Tensor, cfg: ArchConfig,
         capacity_factor=None):
    """x + the layer's FFN of rms_norm(x) -> (x, MoE aux loss or None)."""
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    aux = None
    if spec.ffn == "moe":
        kw = {} if capacity_factor is None else {
            "capacity_factor": capacity_factor}
        y, aux = moe_lib.moe_ffn(p["ffn"], h, cfg, **kw)
    else:
        y = mlp(p["ffn"], h, activation=_activation(p["ffn"]))
    return x + y.to(x.dtype), aux


def _embed_inputs(params, cfg: ArchConfig, inputs: torch.Tensor,
                  positions: Sequence[int] = None) -> torch.Tensor:
    dtype = dtype_of(cfg.activation_dtype)
    if inputs.dtype in (torch.int32, torch.int64):
        x = embed(params["embed"], inputs).to(dtype)
    else:
        x = inputs.to(dtype)
    if cfg.pos_embedding == "sinusoidal":
        pos = (torch.arange(x.shape[1], device=x.device) if positions is None
               else torch.as_tensor(positions, device=x.device))
        x = x + sinusoidal_embedding(pos, cfg.d_model)[None].to(dtype)
    return x


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return linear(params["head"], x)


def forward(params, cfg: ArchConfig, inputs: torch.Tensor, *,
            window: int = 0, capacity_factor=None):
    """inputs: int tokens [B,S] or embeddings [B,S,D] -> (logits, aux);
    aux is the sum of the MoE layers' auxiliary losses (0 without MoE).
    ``capacity_factor`` overrides the MoE layers' default (1.25)."""
    x = _embed_inputs(params, cfg, inputs)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, spec in zip(params["layers"], cfg.layer_specs()):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + _mixer_forward(p["mixer"], spec, h, cfg, window).to(x.dtype)
        if spec.ffn is not None:
            x, a = _ffn(p, spec, x, cfg, capacity_factor)
            if a is not None:
                aux = aux + a
    return _logits(params, cfg, x), aux


# ----------------------------------------------------------------------------
# Serving: prefill + decode
# ----------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               window: int = 0, quantized: bool = False,
               device=None) -> List[Any]:
    """One zeroed decode cache per layer: a ``KVCache`` (an int8
    ``QuantKVCache`` with ``quantized=True``) for attention, a ring of
    ``window`` entries when ``window > 0`` and of ``cfg.local_window`` for
    local attention; an ``MLACache`` for MLA; the recurrent state for
    Mamba and the RG-LRU."""
    dtype = dtype_of(cfg.activation_dtype)
    kv_cls = attn.QuantKVCache if quantized else attn.KVCache
    t_global = min(window, cache_len) if window else cache_len
    caches: List[Any] = []
    for spec in cfg.layer_specs():
        if spec.mixer == "gqa":
            caches.append(kv_cls.zeros(batch, t_global, cfg.num_kv_heads,
                                       cfg.head_dim, dtype, device))
        elif spec.mixer == "local_attn":
            caches.append(kv_cls.zeros(
                batch, min(cfg.local_window, cache_len), cfg.num_kv_heads,
                cfg.head_dim, dtype, device))
        elif spec.mixer == "mla":
            caches.append(attn.MLACache.zeros(
                batch, t_global, cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                dtype, device))
        elif spec.mixer == "mamba":
            caches.append(ssm_lib.MambaState.zeros(batch, cfg, dtype, device))
        elif spec.mixer == "rglru":
            caches.append(ssm_lib.RGLRUState.zeros(batch, cfg, dtype, device))
        else:
            raise ValueError(spec.mixer)
    return caches


def _pad_time(x: torch.Tensor, t: int) -> torch.Tensor:
    """Zero-pad axis 1 (time) up to t entries."""
    if x.shape[1] >= t:
        return x
    pad = x.new_zeros((x.shape[0], t - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def _ring_pack(x: torch.Tensor, w: int) -> torch.Tensor:
    """Place the last w timesteps at their ring-buffer slots (pos % w) so
    a later windowed decode continues seamlessly."""
    s = x.shape[1]
    if s <= w:
        return _pad_time(x, w)
    tail = x[:, s - w:]
    return torch.roll(tail, (s - w) % w, dims=1)


def _fit_time(x: torch.Tensor, window: int, cache_len: int,
              dtype) -> torch.Tensor:
    """A prefill's [B, S, ...] cache entries in the decode layout: a ring
    of min(window, cache_len) slots when ``window > 0``, else padded to
    ``cache_len``."""
    if window:
        return _ring_pack(x, min(window, cache_len)).to(dtype)
    return _pad_time(x, cache_len).to(dtype)


def _prefill_state(p, spec: LayerSpec, h: torch.Tensor, cfg: ArchConfig):
    """Final recurrent state after a full-sequence pass, recomputed as the
    reference does (transformer.py:464): its input projection takes the
    parameter uncast (``h @ p["in_proj"]``), so with f32 parameters and
    bf16 activations the state's conv history and scan come from an f32
    product, where the forward's come from a bf16 one. Decode continues
    from these numbers in both packages."""
    b = h.shape[0]
    dc = cfg.ssm_conv
    cdt = dtype_of(cfg.activation_dtype)
    if spec.mixer == "mamba":
        xin = promoted_matmul(h, p["in_proj"]).chunk(2, dim=-1)[0]
        xc = silu(ssm_lib.causal_conv(xin, p["conv_w"]) + p["conv_b"])
        h0 = torch.zeros((b, cfg.ssm_d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=h.device)
        _, h_last = ssm_lib.mamba_scan(p, xc, cfg, h0)
        return ssm_lib.MambaState(conv=xin[:, -(dc - 1):].to(cdt),
                                  ssm=h_last)
    if spec.mixer == "rglru":
        xb = promoted_matmul(h, p["in_x"])
        xc = ssm_lib.causal_conv(xb, p["conv_w"]) + p["conv_b"]
        h0 = torch.zeros((b, cfg.rglru_width), dtype=torch.float32,
                         device=h.device)
        _, h_last = ssm_lib._rglru_scan(p, xc, h0)
        return ssm_lib.RGLRUState(conv=xb[:, -(dc - 1):].to(cdt), h=h_last)
    raise ValueError(spec.mixer)


def prefill(params, cfg: ArchConfig, inputs: torch.Tensor, *,
            window: int = 0, cache_len: int = 0):
    """Full-sequence prefill: returns (last-token logits [B,1,V], caches
    filled for positions [0, S)). ``cache_len`` > S pre-allocates decode
    headroom. MoE layers run at their default capacity (1.25), as in the
    reference."""
    s = inputs.shape[1]
    cache_len = max(cache_len, s)
    cdt = dtype_of(cfg.activation_dtype)
    x = _embed_inputs(params, cfg, inputs)
    caches: List[Any] = []
    for p, spec in zip(params["layers"], cfg.layer_specs()):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if spec.mixer in ("gqa", "local_attn"):
            w = cfg.local_window if spec.mixer == "local_attn" else window
            y, k, v = attn.gqa_forward_kv(p["mixer"], h, cfg, window=w)
            caches.append(attn.KVCache(_fit_time(k, w, cache_len, cdt),
                                       _fit_time(v, w, cache_len, cdt)))
        elif spec.mixer == "mla":
            y = attn.mla_forward(p["mixer"], h, cfg, window=window)
            c_kv, k_rope = attn.mla_prefill_latent(p["mixer"], h, cfg)
            caches.append(attn.MLACache(
                _fit_time(c_kv, window, cache_len, cdt),
                _fit_time(k_rope, window, cache_len, cdt)))
        else:
            y = _mixer_forward(p["mixer"], spec, h, cfg, window)
            caches.append(_prefill_state(p["mixer"], spec, h, cfg))
        x = x + y.to(x.dtype)
        if spec.ffn is not None:
            x, _ = _ffn(p, spec, x, cfg)
    return _logits(params, cfg, x[:, -1:]), caches


def decode_step(params, cfg: ArchConfig, caches: List[Any],
                tokens: torch.Tensor, pos: int, *, window: int = 0):
    """One serving step: tokens [B,1] int (or [B,1,D] embeddings) at
    absolute position ``pos`` -> (logits [B,1,V], caches). Attention
    caches are updated in place, recurrent states replaced in the
    ``caches`` list; the list is returned. MoE layers are dropless here
    (capacity factor E / k), as in the reference."""
    x = _embed_inputs(params, cfg, tokens, positions=[pos])
    cf = cfg.num_experts / max(cfg.experts_per_token, 1)
    for i, (p, spec) in enumerate(zip(params["layers"], cfg.layer_specs())):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if spec.mixer == "gqa":
            y, caches[i] = attn.gqa_decode(p["mixer"], h, caches[i], pos, cfg,
                                           window=window)
        elif spec.mixer == "local_attn":
            y, caches[i] = attn.gqa_decode(p["mixer"], h, caches[i], pos, cfg,
                                           window=cfg.local_window)
        elif spec.mixer == "mla":
            y, caches[i] = attn.mla_decode(p["mixer"], h, caches[i], pos, cfg,
                                           window=window)
        elif spec.mixer == "mamba":
            y, caches[i] = ssm_lib.mamba_decode(p["mixer"], h, caches[i], cfg)
        elif spec.mixer == "rglru":
            y, caches[i] = ssm_lib.rglru_decode(p["mixer"], h, caches[i], cfg)
        else:
            raise ValueError(spec.mixer)
        x = x + y.to(x.dtype)
        if spec.ffn is not None:
            x, _ = _ffn(p, spec, x, cfg, capacity_factor=cf)
    return _logits(params, cfg, x), caches
