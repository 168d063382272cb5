"""Shims (paper §III-C-2): adapters from an island's operator vocabulary to an
engine's native implementation.

The shim table is derived from the engine op registries plus explicit
adapters; ``resolve(island, op, engine)`` is what the executor invokes.  A
missing shim means that island/engine pair cannot run the op — the planner
must cast to an engine that can (partial coverage is a feature of the paper's
design, not an error).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.engines import ENGINES
from repro_torch.core.islands import ISLANDS

# explicit adapters for island-op -> engine-op name mismatches
_RENAMES: Dict[Tuple[str, str], str] = {
    # text island "spmm" is the Graphulo server-side sparse multiply
    ("text", "matmul"): "spmm",
}


def resolve(island: str, op: str, engine: str) -> Optional[Callable]:
    eng = ENGINES[engine]
    name = _RENAMES.get((island, op), op)
    return eng.ops.get(name)


def shim_table() -> Dict[Tuple[str, str, str], str]:
    """Enumerate every legal (island, op, engine) triple — used by tests and
    the DESIGN.md inventory."""
    table = {}
    for iname, island in ISLANDS.items():
        for op, engines in island.ops.items():
            for e in engines:
                if resolve(iname, op, e) is not None:
                    table[(iname, op, e)] = _RENAMES.get((iname, op), op)
    return table


def validate() -> None:
    """Every advertised island op/engine pair must have a shim."""
    missing = []
    for iname, island in ISLANDS.items():
        for op, engines in island.ops.items():
            for e in engines:
                if resolve(iname, op, e) is None:
                    missing.append((iname, op, e))
    if missing:
        raise RuntimeError(f"islands advertise ops without shims: {missing}")
