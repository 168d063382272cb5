"""The traced window: ``torch.profiler`` over a stretch of the cell's own
work, reduced to the device's busy time, its idle gaps and the device
operations by name and kind.

Device intervals are the CUDA kernels, copies and sets that the profiler
records.  Busy time is their union; an idle gap is a stretch of the
window between them, and is put down to what the host was doing then:
the innermost of the benchmark's own spans (``span``, a
``record_function`` named ``bench:<what>``) and the deepest host
operation running at the gap's midpoint.
"""
from __future__ import annotations

import heapq
import time
from contextlib import contextmanager

import torch

from harness.kinds import kind

SPAN = "bench:"


def span(what: str):
    return torch.profiler.record_function(SPAN + what)


class Traced:
    """What a traced window holds once it has closed: ``device``
    [(name, start_s, end_s)] and ``host`` [(name, start_s, end_s)], on the
    profiler's clock; ``window_s`` from the host's clock, ``t0_s`` the
    window's start on the profiler's clock."""

    def __init__(self):
        self.device, self.host = [], []
        self.window_s = 0.0
        self.t0_s = 0.0

    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return busy

    def kernel_seconds(self, pattern) -> float:
        """Device seconds of the operations whose name matches the compiled
        regular expression ``pattern``."""
        return sum(b - a for n, a, b in self.device if pattern.search(n))

    def gaps(self) -> list:
        """[(start_s, end_s)] of the window with no device operation."""
        out, end = [], self.t0_s
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.t0_s + self.window_s > end:
            out.append((end, self.t0_s + self.window_s))
        return out

    def gap_labels(self) -> dict:
        """Idle seconds by what the host was doing at each gap's midpoint:
        "<benchmark span> / <deepest host operation>"."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] + g[1])
        host = sorted(self.host, key=lambda e: e[1])
        active, i, out = [], 0, {}
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(active, (host[i][2], host[i][1], host[i][0]))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            spans = [e for e in active if e[2].startswith(SPAN)]
            ops = [e for e in active if not e[2].startswith(SPAN)]
            where = max(spans, key=lambda e: e[1])[2][len(SPAN):] \
                if spans else "outside"
            op = max(ops, key=lambda e: e[1])[2] if ops else "no host op"
            label = f"{where} / {op}"
            out[label] = out.get(label, 0.0) + (g1 - g0)
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for n, a, b in self.device:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gap_labels().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[f"{kind(n)}: {n[:120]}", s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps[:top]]}

    def by_kind(self) -> dict:
        out = {}
        for n, a, b in self.device:
            out[kind(n)] = out.get(kind(n), 0.0) + (b - a)
        return out


def idle_percent(run):
    """The share of a run's traced stretch, in %, in which no operation ran
    on the device: one less the union of the device intervals over the
    stretch's length; None where the run traced nothing."""
    traced = getattr(run, "traced", None)
    if traced is None or not traced.device:
        return None
    return 100.0 * (1.0 - traced.busy_s() / traced.window_s)


@contextmanager
def window(device):
    """Profile the body on ``device`` (synchronised at both ends) and yield
    the ``Traced`` that it fills when the body ends."""
    from torch.profiler import ProfilerActivity, profile
    out = Traced()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SPAN + "window"):
            t0 = time.perf_counter()
            yield out
            torch.cuda.synchronize(device)
            out.window_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        rec = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type != cuda:
            out.host.append(rec)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(SPAN)):
            out.device.append(rec)     # a span's copy on the device's
            #                            timeline is no device operation
    starts = [a for n, a, _ in out.host if n == SPAN + "window"]
    out.t0_s = starts[0] if starts else min(
        (a for _, a, _ in out.device), default=0.0)
