"""Synthetic-corpus data pipeline: deterministic, stateless, shaped like
``input_specs``.

The port of ``repro/data/pipeline.py``. No tokenizer or corpus ships
offline, so the pipeline generates a mixture of Zipfian token streams with
Markov locality (a real model can reduce its loss on it) plus per-arch
input adapters:

  * tokens archs   -> {"inputs": int32 [B,S], "targets": int32 [B,S]}
  * embeddings archs (VLM stub) -> {"inputs": f32 [B,S,D], "targets": ...}

The batches are host numpy, the reference's generator draw for draw:
batch i is a function of (seed, i) alone, so a run resumes from a
checkpointed step with the batches it would have seen, and both packages
train on the same numbers. A caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ArchConfig, InputShape


@dataclasses.dataclass
class SyntheticCorpus:
    cfg: ArchConfig
    shape: InputShape
    seed: int = 0
    zipf_a: float = 1.3
    markov_jump: float = 0.15

    def _rng(self, batch_idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, batch_idx))

    def _token_batch(self, rng, b: int, s: int) -> np.ndarray:
        v = self.cfg.vocab_size
        # Zipf marginals, re-mapped into vocab range.
        base = rng.zipf(self.zipf_a, size=(b, s + 1)).astype(np.int64)
        base = base % v
        # Markov locality: with prob 1-jump, next token = prev + small delta
        # (gives learnable bigram structure).
        stay = rng.random((b, s + 1)) > self.markov_jump
        delta = rng.integers(1, 17, size=(b, s + 1))
        toks = base.copy()
        for t in range(1, s + 1):
            toks[:, t] = np.where(stay[:, t],
                                  (toks[:, t - 1] + delta[:, t]) % v,
                                  base[:, t])
        return toks

    def batch(self, batch_idx: int) -> Dict[str, np.ndarray]:
        rng = self._rng(batch_idx)
        b, s = self.shape.global_batch, self.shape.seq_len
        toks = self._token_batch(rng, b, s)
        if self.cfg.input_mode == "embeddings":
            # VLM/audio stub frontend: project the token stream to
            # embeddings deterministically (stands in for ViT patches or
            # codec frames).
            d = self.cfg.d_model
            proj_rng = np.random.default_rng((self.seed, 2 ** 31))
            proj = proj_rng.normal(size=(64, d)).astype(np.float32) * 0.02
            inputs = proj[toks[:, :-1] % 64]
            return {"inputs": inputs,
                    "targets": toks[:, 1:].astype(np.int32)}
        return {"inputs": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape, *,
                batch_override=None) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype stand-ins (``device="meta"`` tensors: nothing is
    allocated) for every model input of (cfg, shape):

    train   -> {"inputs", "targets"}
    prefill -> {"inputs"}
    decode  -> {"tokens" [B,1], "pos" scalar} (the caches come from
               ``transformer.init_cache``).
    """
    b = batch_override or shape.global_batch
    s = shape.seq_len
    if cfg.input_mode == "embeddings" and shape.kind != "decode":
        inp = _spec((b, s, cfg.d_model), torch.float32)
    else:
        inp = _spec((b, s), torch.int32)
    if shape.kind == "train":
        return {"inputs": inp, "targets": _spec((b, s), torch.int32)}
    if shape.kind == "prefill":
        return {"inputs": inp}
    return {"tokens": _spec((b, 1), torch.int32),
            "pos": _spec((), torch.int32)}
