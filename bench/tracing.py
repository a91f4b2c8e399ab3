"""What a ``torch.profiler`` trace of the card says: device intervals, the
busy share, time by operation, and what the host did while the card idled.

The trace arithmetic is ``scripts/profile_query.py``'s: device events are
kernels, copies and fills; busy time is the union of their intervals.
Host spans are the benchmark's own ``record_function`` names around its
calls into the program, beside the profiler's operator events.
"""
from __future__ import annotations

import json
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
#: prefix of the benchmark's own host spans.
SPAN = "bench."


@dataclass
class Trace:
    """One traced stretch: device events (start us, end us, category,
    name), host events (start us, end us, name), and its host-clock
    window."""
    device: List[Tuple[float, float, str, str]]
    host: List[Tuple[float, float, str]]
    window_us: float
    start_us: float

    def busy_us(self) -> float:
        return union_us(self.device)

    def named(self, part: str, cat: str = "kernel"):
        """Device events of ``cat`` whose name holds ``part``."""
        return [e for e in self.device if e[2] == cat and part in e[3]]


def union_us(intervals) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e, *_ in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _events(prof):
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def record(fn: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``fn`` under the profiler, ending in ``sync``."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN + "window"):
            t0 = time.perf_counter()
            fn()
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in _events(prof) if e.get("ph") == "X"]
    device = [(e["ts"], e["ts"] + e["dur"], e["cat"], e["name"])
              for e in events if e.get("cat") in DEVICE_CATS]
    host = [(e["ts"], e["ts"] + e["dur"], e["name"])
            for e in events if e.get("cat") in HOST_CATS]
    window = [h for h in host if h[2] == SPAN + "window"]
    start = window[0][0] if window else min(
        [d[0] for d in device] + [h[0] for h in host], default=0.0)
    return Trace(device, host, wall_us, start)


def top_device_ops(trace: Trace, k: int = 10, width: int = 160):
    """[[name, seconds]] of the device operations that took most time
    (names cut to ``width`` characters: template arguments run long)."""
    by = defaultdict(float)
    for s, e, cat, name in trace.device:
        by[f"{cat}:{name}"] += e - s
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[n if len(n) <= width else n[:width - 3] + "...", t / 1e6]
            for n, t in top]


def idle_gaps(trace: Trace):
    """(start us, end us) of each stretch of the window with no device
    event running."""
    lo, hi = trace.start_us, trace.start_us + trace.window_us
    gaps, cur = [], lo
    for s, e, *_ in sorted(trace.device):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def _innermost(events, times):
    """For each of the sorted ``times``: the name of the latest-starting
    of the nested ``events`` (start, end, name) that holds it, or None."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(events) and events[k][0] <= t:
            while stack and stack[-1][1] <= events[k][0]:
                stack.pop()
            stack.append(events[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def top_idle_gaps(trace: Trace, k: int = 10):
    """[[host activity, seconds]] of the idle time, summed by what the host
    was doing at each gap's middle (the innermost benchmark span and the
    innermost operator around it), longest first."""
    gaps = idle_gaps(trace)
    mids = [(s + e) / 2 for s, e in gaps]
    spans = _innermost([h for h in trace.host if h[2].startswith(SPAN)
                        and h[2] != SPAN + "window"], mids)
    ops = _innermost([h for h in trace.host
                      if not h[2].startswith(SPAN)], mids)
    by = defaultdict(float)
    for (s, e), span, op in zip(gaps, spans, ops):
        parts = [span[len(SPAN):] if span else None, op]
        by["/".join(p for p in parts if p) or "host"] += e - s
    return [[n, t / 1e6] for n, t in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:k]]
