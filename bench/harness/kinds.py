"""The kind of work of a device operation, from its name: a frozen copy of
``chip_smoke.py``'s ``_kind``, for the traced run's ``breakdown``."""
from __future__ import annotations


def kind(name: str) -> str:
    """A hand kernel, a matrix product (cuBLAS / CUTLASS), a sort or search
    (the MoE dispatch's top-k and inverse), a gather or index (its slots),
    a copy or cast, a reduction, other elementwise work."""
    n = name.lower()
    if any(w in n for w in ("flash_fwd", "ssd_intra", "haar", "knn_")):
        return "hand"
    if any(w in n for w in ("gemm", "nvjet", "cutlass", "xmma")):
        return "gemm"
    if "sort" in n or "searchsorted" in n:
        return "sort"
    if any(w in n for w in ("gather", "scatter", "index")):
        return "gather"
    if "copy" in n or n.startswith(("memcpy", "memset")):
        return "copy"
    if "reduce" in n or "softmax" in n or "scan" in n:
        return "reduce"
    return "elementwise" if "elementwise" in n else "other"
