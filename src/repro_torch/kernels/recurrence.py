"""Recurrence scans on Hopper: Mamba-1's selective scan and the RG-LRU's
gated scan, one launch a layer for a whole sequence.

The reference runs both time loops as ``jax.lax.scan`` inside XLA
(``_mamba_inner`` and ``_rglru_scan``, src/repro/models/ssm.py); eagerly,
a step loop would make about eight launches a step for each layer. On CUDA
tensors ``selective_scan`` and ``rglru_scan`` launch the hand-written
kernels of ``csrc/recurrence.cu``; on CPU tensors they run the plain step
loops of ``kernels.ref``. Both take any S >= 1 and any width, so a decode
step (S = 1) launches them too.

The kernels stream the time axis through shared memory in chunks (cp.async,
several chunks in flight) and take the work that does not depend on the
state off the chain: the RG-LRU's gate warps compute a chunk's a_t and
m_t (i_t x_t) while one chain warp runs the previous chunk (32 channels a
CTA), and the selective scan runs one thread per (channel, state), 16
channels a CTA, with y summed over the states from a shared tile. Each
(channel[, state]) chain runs its steps in time order in one thread and
every operation is rounded on its own as the plain version rounds it, so
the last state is bitwise the plain step loop's. The RG-LRU's gates and
the selective scan's exp and shared-memory traffic bound them, not the
chain (``csrc/recurrence.cu`` says how far).

Each kernel counts its launches in ``selective_scan.launches`` and
``rglru_scan.launches``, raised by one at every launch and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: The Mamba state size the kernel is built for (falcon-mamba's).
STATE = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signatures: selective_scan_launch(dt, b, c, x, a, h0, y, h_last, batch,
#: s_len, di, state, stream) and rglru_scan_launch(xc, w_in, w_rec,
#: lambda_p, h0, hs, h_last, batch, s_len, width, stream).
_SIGNATURES = {"selective_scan_launch": [_P] * 8 + [_I] * 4 + [_P],
               "rglru_scan_launch": [_P] * 7 + [_I] * 3 + [_P]}


def _kernel(name: str):
    fn = getattr(build.load("recurrence"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, device: torch.device, **tensors) -> bool:
    """True for CPU tensors (the plain version runs), False for CUDA ones
    (the kernel launches); raises for mixed devices, another device type,
    or, on CUDA, a tensor that is not f32."""
    for t_name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {t_name} is on {t.device}, not "
                             f"{device}")
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    for t_name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t_name} must be float32, got "
                            f"{t.dtype}")
    return False


def _run(name: str, device: torch.device, *args) -> None:
    ptrs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(name)(*ptrs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def selective_scan(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """Mamba-1's recurrence over a sequence (the reference's
    ``_mamba_inner`` scan): dt (after softplus), x [B, S, di]; b, c
    [B, S, st]; a = -exp(a_log) [di, st]; h0 [B, di, st]; f32 on the card.
    Returns (y [B, S, di], h_last [B, di, st]) with
    h = exp(dt a) h + dt b x and y = sum over the states of h c."""
    bsz, s, di = dt.shape
    st = a.shape[1]
    if (tuple(x.shape) != (bsz, s, di) or tuple(b.shape) != (bsz, s, st)
            or tuple(c.shape) != (bsz, s, st) or tuple(a.shape) != (di, st)
            or tuple(h0.shape) != (bsz, di, st)):
        raise ValueError(f"selective_scan: shapes disagree: dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, h0 {tuple(h0.shape)}")
    if _check("selective_scan", dt.device, dt=dt, b=b, c=c, x=x, a=a, h0=h0):
        return ref.selective_scan_ref(dt, b, c, x, a, h0)
    if st != STATE:
        raise ValueError(f"selective_scan: state size {st}; the kernel is "
                         f"built for {STATE}")
    dt, b, c, x, a, h0 = (t.contiguous() for t in (dt, b, c, x, a, h0))
    y = torch.empty_like(dt)
    h_last = torch.empty_like(h0)
    _run("selective_scan_launch", dt.device, dt, b, c, x, a, h0, y, h_last,
         bsz, s, di, st)
    selective_scan.launches += 1
    return y, h_last


def rglru_scan(xc: torch.Tensor, w_input_gate: torch.Tensor,
               w_rec_gate: torch.Tensor, lambda_p: torch.Tensor,
               h0: torch.Tensor):
    """The RG-LRU's gates and recurrence over a sequence (the reference's
    ``_rglru_scan``): xc [B, S, w] (the conv output in f32), the gate
    vectors [w], h0 [B, w]; f32 on the card. Returns (hs [B, S, w],
    h_last [B, w])."""
    bsz, s, w = xc.shape
    if (any(tuple(t.shape) != (w,) for t in (w_input_gate, w_rec_gate,
                                             lambda_p))
            or tuple(h0.shape) != (bsz, w)):
        raise ValueError(f"rglru_scan: shapes disagree: xc "
                         f"{tuple(xc.shape)}, gates "
                         f"{tuple(w_input_gate.shape)} / "
                         f"{tuple(w_rec_gate.shape)} / "
                         f"{tuple(lambda_p.shape)}, h0 {tuple(h0.shape)}")
    if _check("rglru_scan", xc.device, xc=xc, w_input_gate=w_input_gate,
              w_rec_gate=w_rec_gate, lambda_p=lambda_p, h0=h0):
        return ref.rglru_scan_ref(xc, w_input_gate, w_rec_gate, lambda_p, h0)
    xc, w_input_gate, w_rec_gate, lambda_p, h0 = (
        t.contiguous() for t in (xc, w_input_gate, w_rec_gate, lambda_p, h0))
    hs = torch.empty_like(xc)
    h_last = torch.empty_like(h0)
    _run("rglru_scan_launch", xc.device, xc, w_input_gate, w_rec_gate,
         lambda_p, h0, hs, h_last, bsz, s, w)
    rglru_scan.launches += 1
    return hs, h_last


selective_scan.launches = 0
rglru_scan.launches = 0
