"""Spans of the serving path, on the profiler's clock.

``span(name)`` marks a stretch of host work as ``fog.<name>``. While a
``torch.profiler`` records, it is a ``torch.profiler.record_function``,
so the span lands in the profiler's own trace (a ``user_annotation``
event) on the same clock as the kernels and copies it enqueued, and a
span's parent is the innermost enclosing span of its thread. Otherwise it
is one shared no-op context: a site costs one check of the profiler's
state (a bare ``record_function`` costs some twenty times that with no
profiler running). Spans are on exactly when a profiler records; they
never synchronize the device, change no numerics and keep no state of
their own: the profiler holds them until its caller exports the trace.

The spans of the batched multi-fog path, outermost first (a batch is one
``fog.execute_many``):

  fog.execute_many / fog.execute   ``api.session.Session`` call
  fog.stage                        host features -> the folded device table
    fog.scatter                    numpy scatter into [n, (B,) P, F]
    fog.h2d                        the host-to-device copy and the fold
  fog.layer                        one BSP superstep (``bsp._run_layers``)
    fog.exchange                   one sync, or the stale table read
    fog.kernel.<wrapper>           one call of a hand-written kernel's
                                   wrapper: its checks and launch
  fog.unfold                       unpermute, device-to-host copy, and the
                                   host's wait for the queued forward
"""
from __future__ import annotations

import contextlib

import torch

#: prefix of every span name.
PREFIX = "fog."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``fog.<name>`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
