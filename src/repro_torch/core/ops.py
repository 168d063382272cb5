"""PolyOp — the island-operator IR.

A query is a DAG of PolyOp nodes; leaves are ``Ref``s into the middleware
catalog (named, engine-homed objects), mirroring the paper's
``ARRAY(multiply(RELATIONAL(select * from A), B))`` example where each scope
tag names the island interpreting that fragment.

Island boundaries are first-class: a node with ``op == SCOPE_OP`` (built by
``islands.scope(island, subtree)`` or a nested island block in the textual
``qlang`` syntax) marks the point where one island consumes a subtree from
another.  A scope node is semantically the identity on its input's *logical*
content, but it pins the payload to the target island's data model — the
planner restricts its engine candidates to that model's member engines and
charges the inter-island cast on the boundary edge (multi-hop routed, sized
per hop), and the executor materializes the cast through the migrator.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple, Union

_ids = itertools.count()

# operator name of the island-boundary node (see module docstring); the
# user-facing builder is ``islands.scope``, which validates the island name
SCOPE_OP = "scope"


@dataclass(frozen=True)
class Ref:
    """A reference to a catalog object (leaf)."""
    name: str

    def walk(self):
        yield self


@dataclass(frozen=True, eq=False)
class PolyOp:
    op: str                                  # operator name
    island: str                              # scope: array|relational|text|stream|degenerate:<engine>
    inputs: Tuple[Union["PolyOp", Ref], ...]
    attrs: Dict[str, Any] = field(default_factory=dict)
    uid: int = field(default_factory=lambda: next(_ids))

    def walk(self):
        """Post-order traversal."""
        for i in self.inputs:
            yield from i.walk()
        yield self

    def nodes(self):
        return [n for n in self.walk() if isinstance(n, PolyOp)]

    def refs(self):
        return [n for n in self.walk() if isinstance(n, Ref)]

    def __repr__(self):
        args = ", ".join(repr(i) if isinstance(i, Ref) else f"#{i.uid}:{i.op}"
                         for i in self.inputs)
        return f"{self.island.upper()}({self.op} {args})"
