"""Dense decoder transformer: parameters, forward, prefill and decode.

The dense path of ``repro/models/transformer.py``: every layer is
``("gqa", "mlp")`` (qwen1.5, starcoder2, granite, deepseek-67b and the
VLM / audio decoders, whose frontends are stubs that hand over [B, S, D]
embeddings). Entry points share one parameter dictionary:

  * ``forward``      full-sequence logits
  * ``prefill``      full-sequence pass that returns the last token's
                     logits and the decode caches
  * ``decode_step``  one token against the caches

Parameters are per layer (``params["layers"][i]``) and the layers run in
a Python loop: the reference's stacked stages exist only to keep XLA's
program small. ``params_from_numpy`` unstacks the JAX package's tree.
Other layer kinds (MLA, MoE, Mamba, RG-LRU, local attention) raise
``NotImplementedError``; so do training (``loss_fn``, ``make_train_step``)
and the int8 KV cache, which wait for ROADMAP Queue 1 item 6. The
reference's ``constrain_batch`` is a no-op without a device mesh and is
dropped.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.layers import (dtype_of, embed, init_embed,
                                       init_linear, init_mlp, init_rms,
                                       linear, mlp, rms_norm,
                                       sinusoidal_embedding, unembed)

_DENSE = LayerSpec("gqa", "mlp")
#: The ROADMAP Queue 1 item that holds everything off the dense GQA path.
_SUBSTRATE = "the rest of the transformer substrate"


def check_dense(cfg: ArchConfig) -> None:
    """Raise unless every layer of ``cfg`` is a dense GQA + MLP layer."""
    other = sorted({f"{s.mixer}/{s.ffn}" for s in cfg.layer_specs()
                    if s != _DENSE})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {other} are not ported yet (only "
            f"gqa/mlp): ROADMAP Queue 1 item 6, {_SUBSTRATE}")


def _activation(ffn_params) -> str:
    return "silu" if "w_gate" in ffn_params else "gelu"


# ----------------------------------------------------------------------------
# Parameter construction
# ----------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, dtype):
    return {"norm1": init_rms(cfg.d_model, dtype, gen.device),
            "mixer": attn.init_gqa(gen, cfg, dtype),
            "norm2": init_rms(cfg.d_model, dtype, gen.device),
            "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                            gated=cfg.mlp_gated)}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters of ``cfg`` in ``cfg.param_dtype`` from ``gen``, on
    the generator's device: the reference's shapes and scales, other
    numbers (a ``torch.Generator``)."""
    check_dense(cfg)
    dtype = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dtype),
        "layers": [_init_block(gen, cfg, dtype)
                   for _ in range(cfg.num_layers)],
        "final_norm": init_rms(cfg.d_model, dtype, gen.device)}
    if not cfg.tie_embeddings:
        params["head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, dtype)
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
    (``jax.vmap`` over the stage's keys); they are unstacked here into the
    per-layer list, in layer order, so both packages compute the same
    function of the same numbers.
    """
    check_dense(cfg)

    def to_torch(a):
        return torch.tensor(np.asarray(a), device=device)

    layers: List[dict] = []
    for (group, repeats), stage in zip(cfg.stages(), tree["stages"]):
        for r in range(repeats):
            for block in stage:   # one dict per spec of the group
                layers.append(_tree_map(lambda a: to_torch(a[r]), block))
    out = {"embed": _tree_map(to_torch, tree["embed"]), "layers": layers,
           "final_norm": to_torch(tree["final_norm"])}
    if "head" in tree:
        out["head"] = _tree_map(to_torch, tree["head"])
    return out


def cast_params(params: Dict[str, Any], cfg: ArchConfig) -> Dict[str, Any]:
    """A copy of ``params`` in the activation dtype, for serving: every
    use casts a parameter to that dtype at its matmul, so the copy gives
    the same numbers without a cast per step. A tied embedding table keeps
    its dtype (``unembed`` promotes instead of casting)."""
    dt = dtype_of(cfg.activation_dtype)
    out = _tree_map(lambda t: t.to(dt) if t.is_floating_point() else t,
                    {k: v for k, v in params.items() if k != "embed"})
    table = params["embed"]["table"]
    out["embed"] = {"table": table if cfg.tie_embeddings else table.to(dt)}
    return out


# ----------------------------------------------------------------------------
# Block application
# ----------------------------------------------------------------------------

def _ffn(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp(p["ffn"], h, activation=_activation(p["ffn"])).to(x.dtype)


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
            window: int = 0):
    """inputs: int tokens [B,S] or embeddings [B,S,D] -> (logits, aux);
    aux is the MoE auxiliary loss, 0 on the dense path."""
    check_dense(cfg)
    x = _embed_inputs(params, cfg, inputs)
    for p in params["layers"]:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attn.gqa_forward(p["mixer"], h, cfg,
                                 window=window).to(x.dtype)
        x = _ffn(p, x, cfg)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


# ----------------------------------------------------------------------------
# Serving: prefill + decode
# ----------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               window: int = 0, quantized: bool = False,
               device=None) -> List[attn.KVCache]:
    """One zeroed ``KVCache`` per layer (a ring of ``window`` entries when
    ``window > 0``). ``quantized=True`` (the int8 cache) is not ported."""
    check_dense(cfg)
    if quantized:
        raise NotImplementedError(f"QuantKVCache is not ported yet: ROADMAP "
                                  f"Queue 1 item 6, {_SUBSTRATE}")
    t = min(window, cache_len) if window else cache_len
    dtype = dtype_of(cfg.activation_dtype)
    return [attn.KVCache.zeros(batch, t, cfg.num_kv_heads, cfg.head_dim,
                               dtype, device)
            for _ in range(cfg.num_layers)]


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


def _prefill_cache(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig,
                   window: int, cache_len: int) -> attn.KVCache:
    """The decode cache of one layer from its prefill k/v [B,S,KV,dh]."""
    cdt = dtype_of(cfg.activation_dtype)
    k, v = k.to(cdt), v.to(cdt)
    if window:
        w = min(window, cache_len)
        return attn.KVCache(_ring_pack(k, w), _ring_pack(v, w))
    return attn.KVCache(_pad_time(k, cache_len), _pad_time(v, cache_len))


def prefill(params, cfg: ArchConfig, inputs: torch.Tensor, *,
            window: int = 0, cache_len: int = 0):
    """Full-sequence prefill: returns (last-token logits [B,1,V], caches
    filled for positions [0, S)). ``cache_len`` > S pre-allocates decode
    headroom."""
    check_dense(cfg)
    s = inputs.shape[1]
    cache_len = max(cache_len, s)
    x = _embed_inputs(params, cfg, inputs)
    caches = []
    for p in params["layers"]:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        y, k, v = attn.gqa_forward_kv(p["mixer"], h, cfg, window=window)
        caches.append(_prefill_cache(k, v, cfg, window, cache_len))
        x = _ffn(p, x + y.to(x.dtype), cfg)
    return _logits(params, cfg, x[:, -1:]), caches


def decode_step(params, cfg: ArchConfig, caches: List[attn.KVCache],
                tokens: torch.Tensor, pos: int, *, window: int = 0):
    """One serving step: tokens [B,1] int (or [B,1,D] embeddings) at
    absolute position ``pos`` -> (logits [B,1,V], caches). The caches are
    updated in place and returned."""
    check_dense(cfg)
    x = _embed_inputs(params, cfg, tokens, positions=[pos])
    for p, cache in zip(params["layers"], caches):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        y, _ = attn.gqa_decode(p["mixer"], h, cache, pos, cfg, window=window)
        x = _ffn(p, x + y.to(x.dtype), cfg)
    return _logits(params, cfg, x), caches
