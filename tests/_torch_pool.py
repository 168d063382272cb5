"""Spawn targets and worker hooks of the port's process-pool tests.

``multiprocessing`` spawn pickles a process target, and ``ProcPool``
pickles its ``worker_init``, by import path, so they live in this module
(the test directory is on the path of every spawned child) and import
nothing of JAX or the reference package: a spawned pool master must show
that neither is loaded."""
import sys

import numpy as np


def pin_adaptive(bd) -> None:
    """Hold a worker's middleware to its cached plans: no usage-drift
    retraining (peak RSS differs between processes) and no re-plan on
    millisecond timing noise, as the in-process serving tests pin them."""
    bd.monitor.DRIFT_THRESHOLD = float("inf")
    bd.replan_factor = float("inf")


def _no_enumeration(*a, **k):
    raise AssertionError("warm production must not enumerate plans")


def forbid_enumeration(bd) -> None:
    """``pin_adaptive``, and any plan enumeration in this worker raises."""
    from repro_torch.core import middleware
    pin_adaptive(bd)
    middleware.dp_plans = _no_enumeration


def waves(n: int = 16, t: int = 64, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, t)).astype(np.float32)


def front_half(levels: int, nbins: int) -> str:
    """The analytic's front half in the textual syntax."""
    return (f"ARRAY(bin_hist(haar(waves, levels={levels}), nbins={nbins}, "
            f"levels={levels}))")


def master_serves(conn, device, data: np.ndarray, levels: int, nbins: int,
                  shards: int) -> None:
    """A pool master in a fresh process: register ``data`` as ``waves``
    (sharded) on a 2-worker pool on ``device``, serve the analytic's front
    half scattered and unscattered, and send back the two results, the
    workers' kernel launches and what this process loaded — it must hold
    numpy only, never initialize CUDA, and import neither JAX nor the
    reference."""
    import torch
    from repro_torch.core import DenseTensor, ProcPool
    from repro_torch.core.qlang import bigdawg

    out = {}
    with ProcPool(2, device=device, train_plans=1, train_repeats=1,
                  worker_init=pin_adaptive) as pool:
        pool.register("waves", DenseTensor(data), "dense_array",
                      shards=shards)
        pool.launches(reset=True)
        for scatter in ("always", "never"):
            pool.scatter = scatter
            pool.execute(bigdawg(front_half(levels, nbins)),
                         mode="training")
            rep = pool.execute(bigdawg(front_half(levels, nbins)))
            out[scatter] = (rep.result.data, rep.shards, rep.mode)
        out["launches"] = pool.launches()
    out["leaf_types"] = sorted({type(v[0]).__name__ for k, v in out.items()
                                if k in ("always", "never")})
    out["jax"] = "jax" in sys.modules
    out["repro"] = sorted(m for m in sys.modules
                          if m == "repro" or m.startswith("repro."))
    out["cuda_initialized"] = torch.cuda.is_initialized()
    conn.send(out)
    conn.close()
