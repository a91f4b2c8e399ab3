"""Flash attention (forward) on Hopper: online-softmax tiling, so the
[S, T] probability matrix never reaches device memory.

``flash_attention`` takes the reference's folded layout, q [BH, S, dh] and
k/v [BH, T, dh]; ``gqa_flash`` the model layout, q [B, S, H, dh] and k/v
[B, T, KV, dh]. Both keep the JAX package's signatures and argument
checks (its assertions raise ``ValueError`` here). On CUDA tensors both
launch the hand-written kernels of ``csrc/flash_attention.cu``, which read
the model layout in place through strides and index the GQA kv head as
``h // group`` (no repeated K/V copy): bf16 on the tensor cores (wgmma,
K/V by TMA), f32 in IEEE f32 on the CUDA cores. On CPU tensors they run
the plain versions of ``kernels.ref``. f32 softmax statistics, output in
q's dtype; head_dim 32, 64, 128 or 256 (recurrentgemma's). TMA reads bf16
tensors in place, so on CUDA they need 16-byte aligned data and strides
(``check_tma_layout``).

The kernel counts its launches in ``flash_attention.launches``, raised by
one at every launch (from either wrapper) and nowhere else.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH_HEADS = 65535   # grid.y limit of the launch geometry

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of flash_attention_launch: q, k, v, o, strides, then
#: dtype_code, head_dim, batch, heads, group, s_len, t_len, scale, causal,
#: window, q_offset, stream.
_SIGNATURE = [_P] * 5 + [_I] * 7 + [ctypes.c_float] + [_I] * 3 + [_P]


def _kernel():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k, v, name: str) -> None:
    """What both layouts share: one device, one supported dtype, a head
    dim the kernel takes, V as wide as K, a contiguous last axis."""
    for t_name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {t_name} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {t_name} is {t.dtype}, q {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    dh = q.shape[-1]
    if dh not in HEAD_DIMS or k.shape[-1] != dh or v.shape[-1] != dh:
        raise ValueError(f"{name}: head dims must agree and be one of "
                         f"{HEAD_DIMS}, got q {q.shape[-1]}, k "
                         f"{k.shape[-1]}, v {v.shape[-1]}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head_dim axis must be contiguous")


def check_tma_layout(name: str, *tensors: torch.Tensor) -> None:
    """What the bf16 kernel's TMA reads need of each [B, S, H, dh] view:
    a 16-byte aligned first element and batch, position and head strides
    that are whole multiples of 16 bytes. Raises ``ValueError`` otherwise
    (pure pointer and stride arithmetic: CPU tensors reach it too)."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(st * size % 16 for st in t.stride()[:3]):
            raise ValueError(
                f"{name}: the bf16 kernel reads by TMA and needs a 16-byte "
                f"aligned base and 16-byte multiple strides, got offset "
                f"{t.data_ptr() % 16} and strides {t.stride()[:3]} "
                f"(elements of {size} bytes); pass a contiguous copy")


def _check_blocks(s: int, t: int, bq: int, bk: int, q_offset: int) -> None:
    """The reference's block checks (flash_attention.py:81-83)."""
    bq, bk = min(bq, s), min(bk, t)
    if bq < 1 or bk < 1 or s % bq or t % bk:
        raise ValueError(f"S={s} and T={t} must be multiples of the blocks "
                         f"bq={bq} and bk={bk}")
    if q_offset % bq:
        raise ValueError(f"q_offset={q_offset} must be a multiple of "
                         f"bq={bq}")


def _launch(q, k, v, out, *, heads: int, group: int, causal: bool,
            window: int, q_offset: int) -> None:
    """Launch over 4-d views [B, S, H, dh] (k/v [B, T, H / group, dh])."""
    b, s, _, dh = q.shape
    t = k.shape[1]
    if b * heads > _MAX_BATCH_HEADS:
        raise ValueError(f"batch x heads = {b * heads} exceeds the launch "
                         f"limit {_MAX_BATCH_HEADS}")
    if q.dtype == torch.bfloat16:
        check_tma_layout("flash_attention", q, k, v)
    strides = (ctypes.c_longlong * 12)(*(st for x in (q, k, v, out)
                                         for st in x.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.cast(strides, ctypes.c_void_p), _DTYPE_CODES[q.dtype],
            dh, b, heads, group, s, t, float(np.float32(1.0 / np.sqrt(dh))),
            int(causal), int(window), int(q_offset), ctypes.c_void_p(stream))
        flash_attention.launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")


def _on_cpu(q: torch.Tensor, name: str) -> bool:
    """True for CPU tensors (the plain version runs); False for CUDA ones
    (the kernel launches); raise for any other device."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return False


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bq: int = 128, bk: int = 128, causal: bool = True,
                    window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """q [BH, S, dh], k/v [BH, T, dh] -> [BH, S, dh] in q's dtype.

    ``q_offset`` shifts query positions (chunked prefill: queries at
    absolute positions q_offset..q_offset+S attending a length-T cache);
    ``window > 0`` keeps keys with position > q_pos - window. ``bq``/``bk``
    are the reference's block sizes: they set which shapes are accepted
    (S, T and q_offset multiples of them); the CUDA kernel tiles by 64 and
    masks the ragged edge itself.
    """
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash_attention takes q [BH, S, dh] and k/v "
                         "[BH, T, dh]")
    _check_inputs(q, k, v, "flash_attention")
    bh, s, _ = q.shape
    if k.shape[0] != bh or tuple(v.shape[:2]) != tuple(k.shape[:2]):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    _check_blocks(s, k.shape[1], bq, bk, q_offset)
    if _on_cpu(q, "flash_attention"):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q[:, :, None], k[:, :, None], v[:, :, None], out[:, :, None],
            heads=1, group=1, causal=causal, window=window,
            q_offset=q_offset)
    return out


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int = 0, bq: int = 128,
              bk: int = 128) -> torch.Tensor:
    """Model layout: q [B, S, H, dh], k/v [B, T, KV, dh] -> [B, S, H, dh],
    causal. The kernel reads the layout in place and each query head h
    reads kv head h // (H / KV)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("gqa_flash takes q [B, S, H, dh] and k/v "
                         "[B, T, KV, dh]")
    _check_inputs(q, k, v, "gqa_flash")
    b, s, h, _ = q.shape
    t, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or tuple(v.shape[:3]) != tuple(k.shape[:3]):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not split into {kv} kv groups")
    _check_blocks(s, t, bq, bk, 0)
    if _on_cpu(q, "gqa_flash"):
        return ref.gqa_flash_ref(q, k, v, window=window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, heads=h, group=h // kv, causal=True, window=window,
            q_offset=0)
    return out


flash_attention.launches = 0
