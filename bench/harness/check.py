"""The comparison that decides ``correct``, and its readings.

A served cell: a sample, drawn from the seed, of the requests that the
window finished: the one with the most tokens whole, then others in a
seeded order, each to its first ``check_prefix`` served tokens (where the
mix gives one), so that the sample reaches many of the slots.  The plain
reference runs once over each prompt with its compared tokens; a served
token's gap is how far its reference logit lies below the reference's
best at that position (0 where it is the reference's greedy choice).
``gap_max`` is the widest gap of the sample and ``gap_mean`` the mean
over its tokens.  A token outside the head's rows, or a request that did
not give the number of tokens it asked for, reads infinite.

A training cell: the readings of the program's first steps against the
reference's from the same weights and batches.  ``grad_gap`` and
``change_gap`` are the worst leaf's gap between the program's norm and the reference's
(of the first gradient as AdamW takes it, and of the change over the
steps), over the larger of the reference's norm of that leaf and of the
median leaf.  Leaves whose reference gradient is under a thousandth of
the median leaf's move by round-off alone and are left out of
``change_gap``.  ``grad_gap_median``, the median leaf's gradient gap,
and ``loss_gap``, the largest relative gap of a step's loss, are
reported beside them.  The same numbers of the one step that the
program takes after the window, from the state the window left, are the
``late_`` ones.

A cell compares the readings that ``limits/<cell>.json`` gives a limit;
the others are reported beside them.
"""
from __future__ import annotations

import importlib
import math
import statistics

import numpy as np
import torch


def reference(config: dict):
    return importlib.import_module("reference." + config["reference"])


def sample(finished: list, want_tokens: int, seed_rng,
           prefix: int | None = None) -> list:
    """Requests of ``finished`` (each with ``prompt`` and ``out``), each
    with ``upto``, the number of its served tokens to compare: the one
    with the most tokens whole, then others in a seeded order, each to its
    first ``prefix`` tokens (all of them where ``prefix`` is None), until
    the compared tokens reach ``want_tokens``."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: -(len(finished[i]["prompt"])
                                   + len(finished[i]["out"])))
    first, rest = order[0], list(seed_rng.permutation(order[1:]))
    picked, n = [], 0
    for i in [first] + rest:
        r = finished[i]
        upto = len(r["out"]) if prefix is None or i == first \
            else min(prefix, len(r["out"]))
        picked.append({**r, "upto": upto})
        n += upto
        if n >= want_tokens:
            break
    return picked


def _seqs(reqs, device):
    return [(torch.as_tensor(np.concatenate([
        r["prompt"], np.asarray(r["out"][:r.get("upto", len(r["out"])) - 1])])
        .astype(np.int64), device=device), len(r["prompt"]) - 1)
        for r in reqs]


def served_gaps(config: dict, params: dict, reqs: list, device,
                control: bool = False) -> dict:
    """{"gap_max", "gap_mean"} of the served tokens of ``reqs`` and their
    ``gaps`` one by one; with ``control``, ``control`` holds the same of
    the tokens that the reference computed in float8 puts first at the
    same positions."""
    ref = reference(config)
    rows = params["head"].shape[0]
    if not reqs or any(len(r["out"]) != r["want"] or not all(
            0 <= t < rows for t in r["out"]) for r in reqs):
        return {"gap_max": math.inf, "gap_mean": math.inf, "gaps": []}
    seqs = _seqs(reqs, device)
    logits = ref.logits_at(config, params, seqs)
    best = [lg.max(-1).values for lg in logits]

    def gaps_of(picks):
        g = torch.cat([b - lg.gather(-1, p[:, None])[:, 0]
                       for b, lg, p in zip(best, logits, picks)])
        return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
                "gaps": g.tolist()}
    out = gaps_of([torch.as_tensor(r["out"][:len(lg)], device=lg.device)
                   for r, lg in zip(reqs, logits)])
    if control:
        low = ref.logits_at(config, params, seqs, prec="fp8")
        out["control"] = gaps_of([lo.argmax(-1) for lo in low])
    return out


def train_gaps(prog: dict, ref: dict) -> dict:
    """{"grad_gap", "grad_gap_median", "change_gap", "loss_gap"} of the
    program's readings against the reference's (each {"losses",
    "grad_norms", "change_norms"}, norms by leaf)."""
    return {k: v for k, (v, _) in train_worst(prog, ref).items()}


def grad_leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap between the program's gradient norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    return {k: abs(prog["grad_norms"][k] - g_ref[k]) / max(g_ref[k], g_med)
            for k in g_ref}


def train_worst(prog: dict, ref: dict) -> dict:
    """``train_gaps`` with the step or leaf that reads each gap."""
    loss = max((abs(a - b) / abs(b), f"step {i + 1}") for i, (a, b) in
               enumerate(zip(prog["losses"], ref["losses"])))
    leaf = grad_leaf_gaps(prog, ref)
    grad = max((v, k) for k, v in leaf.items())
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[k] for k in moved)
    change = max((abs(prog["change_norms"][k] - c_ref[k])
                  / max(c_ref[k], c_med), k) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "grad_gap_median": (statistics.median(leaf.values()), "median")}


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}) over the numbers that the
    cell's limits name: correct where there is one at least and each
    reading is a number at or under its limit (a reading that is no
    number, such as an infinite gap, is given as null)."""
    compared, ok = {}, bool(limits)
    for name, lim in limits.items():
        value, limit = readings.get(name), lim["limit"]
        finite = value is not None and math.isfinite(value)
        compared[name] = {"value": value if finite else None,
                          "limit": limit}
        ok = ok and finite and value <= limit
    return ok, compared
