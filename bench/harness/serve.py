"""A serving cell: requests against the port's ``BatchServer``.

Requests arrive in an open loop: they are due at the mix's fixed
``rate``, evenly spaced, whether or not earlier ones have ended.  A
request waits in a queue on the host until a slot is free, and its time
to first token runs from when it was due to the moment its first token
is on the host (``submit`` returns after the token's ``int``), so the
wait counts.  Requests are admitted (prefilled) in the order they came,
and every admitted request advances with the batch, one decode step at a
time.

Set-up makes the weights and builds the server.  ``start: "staggered"``
then admits one request to every slot, each with a seeded part of its
output still to come, so that they end one after another from the
window's first step; ``start: "warm"`` serves ``warm_requests`` requests
to their end, so that the window starts with every shape it uses warm
and the server empty.
"""
from __future__ import annotations

import gc
import math
import time
from collections import deque
from contextlib import contextmanager

import numpy as np

from harness import check, port, traffic, weights
from harness import device as dev
from harness.trace import span, window


class Loop:
    """The server, the requests' stream and the requests in flight."""

    def __init__(self, srv, stream: traffic.RequestStream, mix: dict):
        self.srv, self.stream, self.mix = srv, stream, mix
        self.waiting = deque()       # (time due, ids, output tokens)
        self.live = {}               # rid -> (Request, record)
        self.finished = []           # records of requests that ended
        self.rid = 0
        self.due = None              # the open loop's next arrival
        self.step_s = []             # host seconds of each decode step

    def admit(self, ids, want: int, due=None):
        """Prefill one request into a free slot; (seconds, record), or None
        where no slot is free."""
        req = port.Request(self.rid, ids, max_new_tokens=want)
        t1 = time.perf_counter()
        with span("prefill"):
            if not self.srv.submit(req):
                return None
        t2 = time.perf_counter()
        slot = next((s for s, q in self.srv.active.items() if q is req), None)
        rec = {"prompt": ids, "want": want, "due": due, "first": t2,
               "out": req.out_tokens, "slot": slot}
        self.live[self.rid] = (req, rec)
        self.rid += 1
        return t2 - t1, rec

    def _arrivals(self, now: float) -> None:
        gap = 1.0 / self.mix["rate"]
        if self.due is None:
            self.due = now
        while self.due <= now:
            self.waiting.append((self.due, *self.stream.next()))
            self.due += gap

    def run(self, deadline: float, prefills: list, ttft: list) -> int:
        """Admit and step until ``deadline``; the number of requests
        admitted.  Each admission appends (seconds, prompt length) to
        ``prefills`` and its time to first token to ``ttft``."""
        n = 0
        while (now := time.perf_counter()) < deadline:
            self._arrivals(now)
            if not self.live and not self.waiting:
                with span("idle"):          # nothing to do until the next
                    time.sleep(max(0.0, min(self.due, deadline) - now))
                continue
            while self.waiting and time.perf_counter() < deadline:
                due, ids, want = self.waiting[0]
                got = self.admit(ids, want, due)
                if got is None:
                    break
                self.waiting.popleft()
                prefills.append((got[0], len(ids)))
                ttft.append(got[1]["first"] - due)
                n += 1
            t1 = time.perf_counter()
            with span("decode_step"):
                self.srv.step()
            now = time.perf_counter()
            self.step_s.append(now - t1)
            for rid in [r for r, (q, _) in self.live.items() if q.done]:
                _, rec = self.live.pop(rid)
                rec["done"] = now
                self.finished.append(rec)
        return n


@contextmanager
def gc_pauses():
    """The Python collector's pauses while the block runs: a list of
    (generation, seconds), filled as they come."""
    pauses, start = [], [0.0]

    def note(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           time.perf_counter() - start[0]))
    gc.callbacks.append(note)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(note)


def host_record(loop: Loop, prefills: list, ttft: list, pauses: list,
                worst: int = 5) -> dict:
    """What the host did in the window, for a tail that reads far off:
    the slowest decode steps, the collector's pauses, and the ``worst``
    times to first token, each as (seconds, prompt length, seconds of its
    own prefill)."""
    slow = sorted(zip(ttft, prefills), key=lambda x: -x[0])[:worst]
    return {"steps": len(loop.step_s),
            "step_s_max": max(loop.step_s, default=0.0),
            "step_s_median": float(np.median(loop.step_s))
            if loop.step_s else 0.0,
            "gc_pauses": len(pauses),
            "gc_s_max": max((t for _, t in pauses), default=0.0),
            "gc_s_total": sum(t for _, t in pauses),
            "ttft_worst": [[t, n, p] for t, (p, n) in slow]}


def setup(cell, seed: int, device):
    """(params, server, loop) with the slots filled or warmed as the mix's
    ``start`` says."""
    cfg, tr = cell.config, cell.traffic
    a = port.arch(cfg)
    params = weights.make(port.param_shapes(a, "bfloat16"), seed, device)
    srv = port.server(a, params, tr["slots"], tr["max_len"], device)
    stream = traffic.RequestStream(tr, cfg["vocab_size"], seed)
    loop = Loop(srv, stream, tr)
    if tr["loop"] != "open":
        raise ValueError(f"no driver for a {tr['loop']!r} loop")
    if tr["start"] == "staggered":
        for frac in stream.staggered(tr["slots"]):
            ids, want = stream.next()
            loop.admit(ids, max(2, math.ceil(want * frac)))
        srv.step()
    elif tr["start"] == "warm":
        for _ in range(tr["warm_requests"]):
            loop.admit(*stream.next())
        while loop.live:
            srv.step()
            loop.live = {r: v for r, v in loop.live.items() if not v[0].done}
    else:
        raise ValueError(f"unknown start {tr['start']!r}")
    dev.sync(device)
    return params, srv, loop


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool = False) -> dict:
    """The window's records, its end-to-end metrics (``e2e``) and the
    comparison's readings; with ``control``, the control's reading too."""
    cfg, tr = cell.config, cell.traffic
    params, srv, loop = setup(cell, seed, device)
    stats0 = dict(srv.stats)
    prefills, ttft = [], []
    loop.step_s = []
    with gc_pauses() as pauses:
        t0 = time.perf_counter()
        admitted = loop.run(t0 + seconds, prefills, ttft)
        t_end = time.perf_counter()
    stats1 = dict(srv.stats)
    in_window = [r for r in loop.finished if t0 <= r["done"] <= t_end]
    tokens = len(prefills) + stats1["tokens_out"] - stats0["tokens_out"]

    rec = {"t0": t0, "window_s": t_end - t0, "prefills": prefills,
           "ttft": ttft, "tokens": tokens,
           "decode_seconds": stats1["decode_seconds"]
           - stats0["decode_seconds"],
           "decode_steps": stats1["decode_steps"] - stats0["decode_steps"],
           "attempted": admitted, "failed": 0, "queued": len(loop.waiting),
           "e2e": {"output_tokens_per_s": tokens / (t_end - t0)},
           "host": host_record(loop, prefills, ttft, pauses),
           "traced": None}
    if ttft:
        rec["e2e"]["ttft_p95_ms"] = float(np.percentile(ttft, 95)) * 1e3
    if trace:
        port.reset_launches()
        lens = []
        with window(device) as traced:
            loop.run(time.perf_counter() + tr.get("trace_seconds", 3),
                     lens, [])
        rec.update(traced=traced, trace_launches=port.launches(),
                   trace_prefills=[n for _, n in lens])
    rec["memory_peak_bytes"] = dev.peak(device)

    srv.cache = None
    del srv, loop
    dev.free(device)
    picked = check.sample(in_window, tr["check_tokens"],
                          np.random.default_rng(traffic.mix(seed, "check")),
                          tr.get("check_prefix"))
    gaps = check.served_gaps(cfg, params, picked, device, control=control)
    rec["readings"] = {k: gaps[k] for k in ("gap_max", "gap_mean")}
    rec["gaps"] = gaps["gaps"]
    if control and "control" in gaps:
        rec["control"] = {k: gaps["control"][k]
                          for k in ("gap_max", "gap_mean")}
        rec["control_gaps"] = gaps["control"]["gaps"]
    rec["checked"] = {"requests": len(picked),
                      "tokens": sum(r["upto"] for r in picked),
                      "slots": len({r["slot"] for r in picked}),
                      "finished": len(in_window), "queued": rec["queued"]}
    return rec
