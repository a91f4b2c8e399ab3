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

Both scans are differentiable (``_SelectiveScan``, ``_RGLRUScan``:
``torch.autograd.Function``s). Their backward on a CUDA tensor is one
launch of a hand-written backward kernel (``selective_scan_bwd_launch``,
``rglru_scan_bwd_launch`` in the same source), on a CPU tensor the plain
reverse step loop (``ref.selective_scan_bwd_ref``, ``ref.rglru_scan_bwd_ref``).
Both backward kernels stream time from the last chunk through the same
kind of cp.async ring as the forwards. The selective scan's recomputes the
states (the forward keeps none): a forward sweep keeps h at every
``SS_BWD_CHUNK``-th step, and the reverse sweep rebuilds each chunk's
states and their exps from its boundary into registers, once. The
RG-LRU's reads the forward's ``hs``, which autograd keeps, and computes the
gates once, in gate warps beside the warp that runs the reverse chain. The
sums that cross CTAs (over channels for ``db`` and ``dc``, over batch rows
for the gate vectors and ``a``) go through per-CTA partials summed by
``torch.sum`` over the partials' axis: a fixed order, no atomics, so a
backward is the same on every run.

Each kernel counts its launches in ``selective_scan.launches`` and
``rglru_scan.launches``, raised by one at every forward launch and nowhere
else, and its backward launches in ``selective_scan.backward_launches``
and ``rglru_scan.backward_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: The Mamba state size the kernel is built for (falcon-mamba's).
STATE = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
#: Steps between two states the selective scan's backward keeps (the
#: kernel's chunk; its launch refuses another).
SS_BWD_CHUNK = 16
#: Channels a CTA of the selective scan's backward owns (the kernel's
#: kSbG): its db / dc partials are one per such group.
SS_BWD_CHANNELS = 16

#: C signatures: selective_scan_launch(dt, b, c, x, a, h0, y, h_last, batch,
#: s_len, di, state, stream); rglru_scan_launch(xc, w_in, w_rec, lambda_p,
#: h0, hs, h_last, batch, s_len, width, stream);
#: selective_scan_bwd_launch(dt, b, c, x, a, h0, dy, dh_last, h_keep, ddt,
#: dx, db_part, dc_part, da_part, dh0, batch, s_len, di, state, chunk,
#: stream); rglru_scan_bwd_launch(xc, w_in, w_rec, lambda_p, h0, hs, dhs,
#: dh_last, dxc, dwi_part, dwr_part, dlam_part, dh0, batch, s_len, width,
#: stream). A null dh_last is a zero one.
_SIGNATURES = {"selective_scan_launch": [_P] * 8 + [_I] * 4 + [_P],
               "rglru_scan_launch": [_P] * 7 + [_I] * 3 + [_P],
               "selective_scan_bwd_launch": [_P] * 15 + [_I] * 5 + [_P],
               "rglru_scan_bwd_launch": [_P] * 13 + [_I] * 3 + [_P]}


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
    """Launch ``name`` on the current stream; tensors go as pointers, None
    as a null pointer."""
    ptrs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else ctypes.c_void_p(None) if a is None else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(name)(*ptrs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def _selective_fwd(dt, b, c, x, a, h0):
    bsz, s, di = dt.shape
    st = a.shape[1]
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


def _selective_bwd(dt, b, c, x, a, h0, dy, dh_last):
    """(ddt, db, dc, dx, da, dh0): one backward launch on the card, the
    plain reverse step loop on the CPU."""
    if dy is None:
        dy = torch.zeros_like(dt)
    if _check("selective_scan", dt.device, dt=dt, dy=dy):
        return ref.selective_scan_bwd_ref(dt, b, c, x, a, h0, dy, dh_last)
    bsz, s, di = dt.shape
    st = a.shape[1]
    dt, b, c, x, a, h0, dy = (t.contiguous()
                              for t in (dt, b, c, x, a, h0, dy))
    if dh_last is not None:
        _check("selective_scan", dt.device, dh_last=dh_last)
        dh_last = dh_last.contiguous()
    groups = -(-di // SS_BWD_CHANNELS)
    h_keep = dt.new_empty((bsz, -(-s // SS_BWD_CHUNK), di, st))
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db_part = dt.new_empty((groups, bsz, s, st))
    dc_part = dt.new_empty((groups, bsz, s, st))
    da_part = dt.new_empty((bsz, di, st))
    dh0 = torch.empty_like(h0)
    _run("selective_scan_bwd_launch", dt.device, dt, b, c, x, a, h0, dy,
         dh_last, h_keep, ddt, dx, db_part, dc_part, da_part, dh0, bsz, s,
         di, st, SS_BWD_CHUNK)
    selective_scan.backward_launches += 1
    return (ddt, db_part.sum(0), dc_part.sum(0), dx, da_part.sum(0), dh0)


class _SelectiveScan(torch.autograd.Function):
    """``selective_scan`` with its gradient (``_selective_bwd``); only the
    inputs in ``needs_input_grad`` get one, and a gradient of h_last that
    nobody asked for is taken as 0."""

    @staticmethod
    def forward(ctx, dt, b, c, x, a, h0):
        ctx.save_for_backward(dt, b, c, x, a, h0)
        ctx.set_materialize_grads(False)
        return _selective_fwd(dt, b, c, x, a, h0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dh_last):
        grads = _selective_bwd(*ctx.saved_tensors, dy, dh_last)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """Mamba-1's recurrence over a sequence (the reference's
    ``_mamba_inner`` scan): dt (after softplus), x [B, S, di]; b, c
    [B, S, st]; a = -exp(a_log) [di, st]; h0 [B, di, st]; f32 on the card.
    Returns (y [B, S, di], h_last [B, di, st]) with
    h = exp(dt a) h + dt b x and y = sum over the states of h c. Where
    autograd wants a gradient of any input the call goes through
    ``_SelectiveScan``."""
    bsz, s, di = dt.shape
    st = a.shape[1]
    if (tuple(x.shape) != (bsz, s, di) or tuple(b.shape) != (bsz, s, st)
            or tuple(c.shape) != (bsz, s, st) or tuple(a.shape) != (di, st)
            or tuple(h0.shape) != (bsz, di, st)):
        raise ValueError(f"selective_scan: shapes disagree: dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, h0 {tuple(h0.shape)}")
    args = (dt, b, c, x, a, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SelectiveScan.apply(*args)
    return _selective_fwd(*args)


def _rglru_fwd(xc, w_input_gate, w_rec_gate, lambda_p, h0):
    bsz, s, w = xc.shape
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


def _rglru_bwd(xc, w_input_gate, w_rec_gate, lambda_p, h0, hs, dhs,
               dh_last):
    """(dxc, dw_input_gate, dw_rec_gate, dlambda_p, dh0): one backward
    launch on the card, the plain version on the CPU."""
    if dhs is None:
        dhs = torch.zeros_like(hs)
    if _check("rglru_scan", xc.device, xc=xc, dhs=dhs):
        return ref.rglru_scan_bwd_ref(xc, w_input_gate, w_rec_gate,
                                      lambda_p, h0, hs, dhs, dh_last)
    bsz, s, w = xc.shape
    xc, w_input_gate, w_rec_gate, lambda_p, h0, hs, dhs = (
        t.contiguous() for t in (xc, w_input_gate, w_rec_gate, lambda_p, h0,
                                 hs, dhs))
    if dh_last is not None:
        _check("rglru_scan", xc.device, dh_last=dh_last)
        dh_last = dh_last.contiguous()
    dxc = torch.empty_like(xc)
    parts = xc.new_empty((3, bsz, w))
    dh0 = torch.empty_like(h0)
    _run("rglru_scan_bwd_launch", xc.device, xc, w_input_gate, w_rec_gate,
         lambda_p, h0, hs, dhs, dh_last, dxc, parts[0], parts[1], parts[2],
         dh0, bsz, s, w)
    rglru_scan.backward_launches += 1
    dwi, dwr, dlam = parts.sum(1)
    return dxc, dwi, dwr, dlam, dh0


class _RGLRUScan(torch.autograd.Function):
    """``rglru_scan`` with its gradient (``_rglru_bwd``, which reads the
    saved ``hs``); only the inputs in ``needs_input_grad`` get one."""

    @staticmethod
    def forward(ctx, xc, w_input_gate, w_rec_gate, lambda_p, h0):
        hs, h_last = _rglru_fwd(xc, w_input_gate, w_rec_gate, lambda_p, h0)
        ctx.save_for_backward(xc, w_input_gate, w_rec_gate, lambda_p, h0, hs)
        ctx.set_materialize_grads(False)
        return hs, h_last

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dhs, dh_last):
        grads = _rglru_bwd(*ctx.saved_tensors, dhs, dh_last)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def rglru_scan(xc: torch.Tensor, w_input_gate: torch.Tensor,
               w_rec_gate: torch.Tensor, lambda_p: torch.Tensor,
               h0: torch.Tensor):
    """The RG-LRU's gates and recurrence over a sequence (the reference's
    ``_rglru_scan``): xc [B, S, w] (the conv output in f32), the gate
    vectors [w], h0 [B, w]; f32 on the card. Returns (hs [B, S, w],
    h_last [B, w]). Where autograd wants a gradient of any input the call
    goes through ``_RGLRUScan``."""
    bsz, s, w = xc.shape
    if (any(tuple(t.shape) != (w,) for t in (w_input_gate, w_rec_gate,
                                             lambda_p))
            or tuple(h0.shape) != (bsz, w)):
        raise ValueError(f"rglru_scan: shapes disagree: xc "
                         f"{tuple(xc.shape)}, gates "
                         f"{tuple(w_input_gate.shape)} / "
                         f"{tuple(w_rec_gate.shape)} / "
                         f"{tuple(lambda_p.shape)}, h0 {tuple(h0.shape)}")
    args = (xc, w_input_gate, w_rec_gate, lambda_p, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _RGLRUScan.apply(*args)
    return _rglru_fwd(*args)


selective_scan.launches = 0
selective_scan.backward_launches = 0
rglru_scan.launches = 0
rglru_scan.backward_launches = 0
