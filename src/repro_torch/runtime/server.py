"""Batched LM serving with continuous slot management (``BatchServer``).

The port of ``repro.runtime.server.BatchServer``: a fixed-capacity decode
batch over a shared cache.  Incoming requests are prefilled one at a time
into free slots (each prefill writes its cache rows), decode steps advance
ALL active slots together, and finished slots (EOS, max-tokens or a full
cache) are released.

The cache is a dict of tensors on the serving device.  ``_write_rows``
copies a prefilled request's rows into its slot IN PLACE, and the decode
function updates the cache in place too (the reference rebuilds both).
``QueryServer`` and ``StatsView`` are not ported yet (ROADMAP.md queue 1,
serving stack).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.reqpool import RequestPool
from repro_torch.models.util import tree_leaves, tree_map


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # (len,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class BatchServer:
    def __init__(self, *, slots: int, max_len: int, prefill_fn, decode_fn,
                 params, init_cache_fn, eos_id: Optional[int] = None):
        """prefill_fn(params, tokens(1,L)) -> (logits(1,V), cache_rows, pos)
        decode_fn(params, cache, tokens(B,), pos(B,)) -> (next(B,), cache).

        The serving device is the cache's (``init_cache_fn(slots,
        max_len)``); prompts and decode inputs are moved there."""
        self.slots = slots
        self.max_len = max_len
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.params = params
        self.cache = init_cache_fn(slots, max_len)
        self.device = tree_leaves(self.cache)[0].device
        self.eos_id = eos_id
        self.active: Dict[int, Request] = {}     # slot -> request
        self.pos = np.zeros((slots,), np.int32)
        self.tokens = np.zeros((slots,), np.int32)
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens_out": 0,
                      "decode_seconds": 0.0}
        # guards slot state + the shared cache writes; prefill COMPUTE runs
        # pool-parallel in serve(), attachment is serialized here
        self._slot_lock = threading.Lock()
        self._requests = RequestPool(thread_name_prefix="bigdawg-prefill")

    # -- slot management -----------------------------------------------------
    def _free_slots(self):
        return [s for s in range(self.slots) if s not in self.active]

    @torch.inference_mode()
    def _write_rows(self, cache_rows, slot: int, plen: int):
        """Copy one request's prefilled cache rows into the batch cache.

        Generic across cache families: the batch axis of each leaf is
        located by matching (slots vs 1) dims; a following seq axis, if
        shorter in the source, is zero-filled past the source's length."""
        def place(dst, src):
            b_axis = None
            for ax in range(dst.ndim):
                if dst.shape[ax] == self.slots and src.shape[ax] == 1:
                    b_axis = ax
                    break
            if b_axis is None:           # state-style leaf without seq dim
                return dst
            idx = [slice(None)] * dst.ndim
            idx[b_axis] = slice(slot, slot + 1)
            seq = b_axis + 1
            if seq < dst.ndim and src.shape[seq] != dst.shape[seq]:
                tail = list(idx)
                tail[seq] = slice(src.shape[seq], None)
                dst[tuple(tail)] = 0
                idx[seq] = slice(0, src.shape[seq])
            dst[tuple(idx)] = src.to(dst.dtype)
            return dst
        self.cache = tree_map(place, self.cache, cache_rows)

    def _prefill_compute(self, req: Request):
        """The pure-compute half of a prefill (no shared state): safe to run
        on a request-pool worker while other prefills compute beside it."""
        tok = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                              device=self.device)
        return self.prefill_fn(self.params, tok)

    def _attach(self, slot: int, req: Request, logits, cache_rows) -> None:
        """The stateful half: copy the prefilled cache rows into the batch
        cache and activate the slot (serialized on the slot lock)."""
        with self._slot_lock:
            self._write_rows(cache_rows, slot, len(req.prompt))
            first = int(torch.argmax(logits[0]))
            req.out_tokens.append(first)
            self.tokens[slot] = first
            self.pos[slot] = len(req.prompt)
            self.active[slot] = req
            self.stats["prefills"] += 1

    def submit(self, req: Request) -> bool:
        free = self._free_slots()
        if not free:
            return False
        logits, cache_rows, pos = self._prefill_compute(req)
        self._attach(free[0], req, logits, cache_rows)
        return True

    # -- decode ----------------------------------------------------------------
    def step(self):
        if not self.active:
            return
        t0 = time.perf_counter()
        nxt, self.cache = self.decode_fn(
            self.params, self.cache,
            torch.as_tensor(self.tokens, device=self.device),
            torch.as_tensor(self.pos, device=self.device))
        nxt = nxt.cpu().numpy()             # waits for the step to finish
        self.stats["decode_seconds"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self.pos[slot] += 1
            self.tokens[slot] = tok
            self.stats["tokens_out"] += 1
            if ((self.eos_id is not None and tok == self.eos_id)
                    or len(req.out_tokens) >= req.max_new_tokens
                    or self.pos[slot] >= self.max_len - 1):
                req.done = True
                del self.active[slot]

    def run(self, requests: List[Request], max_steps: int = 10000):
        pending = list(requests)
        steps = 0
        while (pending or self.active) and steps < max_steps:
            while pending and self._free_slots():
                self.submit(pending.pop(0))
            self.step()
            steps += 1
        return requests

    def serve(self, requests: List[Request], workers: Optional[int] = None,
              max_steps: int = 10000):
        """``run`` with pool-parallel prefill: each admission wave computes
        its prefills concurrently on the shared request pool, then attaches
        them to free slots on the caller thread — decode still advances all
        active slots together.  ``workers<=1`` degrades to ``run``'s
        sequential admission."""
        pending = list(requests)
        steps = 0
        while (pending or self.active) and steps < max_steps:
            free = self._free_slots()
            wave = pending[:len(free)]
            if wave:
                del pending[:len(wave)]
                outs = self._requests.map_ordered(self._prefill_compute,
                                                  wave, workers)
                for slot, req, (logits, cache_rows, _pos) in zip(
                        free, wave, outs):
                    self._attach(slot, req, logits, cache_rows)
            self.step()
            steps += 1
        return requests
