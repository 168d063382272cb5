"""qlang — the paper's textual multi-island query surface.

"Version 0.1 of the BigDAWG Polystore System" presents queries as nested
island blocks — ``BIGDAWG(ARRAY(multiply(RELATIONAL(select A), B)))`` — where
each upper-case block SCOPEs its fragment to one island and the seams between
blocks are CASTs.  ``bigdawg(text)`` parses exactly that shape (plus a
pipeline sugar) into the same ``PolyOp`` IR the attribute API builds, so the
demo-paper surface round-trips through parse → plan → execute:

    bigdawg("RELATIONAL(join(A, B, left_on=key, right_on=key)) "
            "|> ARRAY(matmul(_, W))")

Grammar (recursive descent; whitespace-insensitive):

    query    :=  "BIGDAWG" "(" pipeline ")"  |  pipeline
    pipeline :=  stage ("|>" stage)*
    stage    :=  ISLAND "(" expr ")"
    expr     :=  ISLAND "(" expr ")"             -- nested block -> scope node
              |  op "(" (expr | kw)* ")"         -- island operator call
              |  name                            -- catalog Ref
              |  "_"                             -- previous pipeline stage
    kw       :=  name "=" (number | string | bare-word | true | false)

* ``ISLAND`` is an ALL-CAPS island name — ``RELATIONAL``, ``ARRAY``,
  ``TEXT``, ``STREAM``, or ``DEGENERATE:engine`` (e.g.
  ``DEGENERATE:dense_array``); lower-case names are operators or refs.
* A nested island block compiles to ``islands.scope(outer_island, inner)``:
  the inner fragment runs under the inner island's semantics and is CAST to
  the outer island's data model at the seam — the planner prices that edge.
* ``|>`` feeds the previous stage into the next stage's ``_`` placeholder
  (scoped to the next stage's island, once, even if ``_`` repeats).
* Keyword values: numbers (``lo=-0.5``), quoted strings, or bare words
  (``column=value`` means the string ``"value"``); ``true``/``false`` parse
  as booleans.

**SQL-style select (RELATIONAL blocks).**  The paper's §III examples write
the relational fragment as literal SQL text; RELATIONAL blocks accept that
surface too:

    sql    :=  "select" ("*" | name ("," name)*) "from" (name | "_")
               [ "where" cond ("and" cond)* ]
    cond   :=  name ("<" | "<=" | ">" | ">=" | "=") number

``bigdawg("RELATIONAL(select * from A where v >= 0.5)")`` compiles to the
SAME ``relational.select(A, column=v, lo=0.5)`` IR the attribute API builds
— signature-identical, so both surfaces share plans and monitor history.
Conditions on one column fold into one select node's ``lo``/``hi`` bounds
(``=`` pins both); a non-star column list appends a ``project``.  Bounds
are closed intervals (the columnar engine's select is inclusive), so strict
``<``/``>`` compile to the closed bound — exact for the continuous-valued
columns the demo data uses.

Errors carry position context; an unknown operator raises the island's
available op list (via ``Island.__getattr__``), an unknown island names the
registered islands.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# QueryParseError now lives in the unified BigDAWGError taxonomy
# (core.errors); re-exported here, its historical home, for back-compat
from repro_torch.core.errors import QueryParseError
from repro_torch.core.islands import ISLANDS, Island, scope
from repro_torch.core.ops import PolyOp, Ref

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<pipe>\|>)
  | (?P<lparen>\()
  | (?P<rparen>\))
  | (?P<comma>,)
  | (?P<star>\*)
  | (?P<cmp><=|>=|<|>)
  | (?P<eq>=)
  | (?P<string>'[^']*'|"[^"]*")
  | (?P<number>-?\d+(?:\.\d*)?(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*(?::[A-Za-z0-9_]+)?)
""", re.VERBOSE)


def _tokenize(text: str) -> List[Tuple[str, str, int]]:
    tokens, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise QueryParseError(_fmt_err(text, pos,
                                           f"unexpected character "
                                           f"{text[pos]!r}"))
        if m.lastgroup != "ws":
            tokens.append((m.lastgroup, m.group(), pos))
        pos = m.end()
    return tokens


def _fmt_err(text: str, pos: int, msg: str) -> str:
    return f"{msg}\n  {text}\n  {' ' * pos}^ (offset {pos})"


def _is_island_token(name: str) -> bool:
    """ALL-CAPS head = island block (the DEGENERATE:engine tail is an engine
    name and stays lower-case)."""
    head = name.split(":", 1)[0]
    return head.isupper()


def _resolve_island(name: str, text: str, pos: int) -> Island:
    isl = ISLANDS.get(name.lower())
    if isl is None:
        raise QueryParseError(_fmt_err(
            text, pos, f"unknown island {name!r}; available islands: "
                       f"{', '.join(sorted(ISLANDS)).upper()}"))
    return isl


def _finish_block(island: Island, node):
    """Close an island block: its body must be governed by (and delivered
    in) the block's island — a bare catalog ref or a foreign-island subtree
    gets an explicit boundary node; a native subtree passes through."""
    if isinstance(node, Ref) or \
            (isinstance(node, PolyOp) and node.island != island.name):
        return scope(island, node)
    return node


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.tokens = _tokenize(text)
        self.i = 0
        # the previous pipeline stage's subtree, scoped lazily (and at most
        # once per island) when an `_` placeholder pulls it in; repeated `_`
        # shares the node, so the boundary cast happens once
        self._prev: Optional[PolyOp] = None
        self._prev_used = False
        self._prev_scoped: Dict[str, PolyOp] = {}

    # -- token plumbing ----------------------------------------------------
    def _peek(self, kind: Optional[str] = None):
        if self.i >= len(self.tokens):
            return None
        tok = self.tokens[self.i]
        return tok if kind is None or tok[0] == kind else None

    def _next(self):
        tok = self._peek()
        if tok is None:
            raise QueryParseError(_fmt_err(self.text, len(self.text),
                                           "unexpected end of query"))
        self.i += 1
        return tok

    def _expect(self, kind: str, what: str):
        tok = self._peek()
        if tok is None or tok[0] != kind:
            pos = tok[2] if tok else len(self.text)
            got = repr(tok[1]) if tok else "end of query"
            raise QueryParseError(_fmt_err(self.text, pos,
                                           f"expected {what}, got {got}"))
        self.i += 1
        return tok

    # -- grammar -----------------------------------------------------------
    def parse_query(self) -> PolyOp:
        tok = self._peek("name")
        if tok and tok[1] == "BIGDAWG":      # optional paper-style wrapper
            self._next()
            self._expect("lparen", "'(' after BIGDAWG")
            node = self.parse_pipeline()
            self._expect("rparen", "')' closing BIGDAWG(...)")
        else:
            node = self.parse_pipeline()
        trailing = self._peek()
        if trailing is not None:
            raise QueryParseError(_fmt_err(
                self.text, trailing[2],
                f"trailing input after query: {trailing[1]!r}"))
        return node

    def parse_pipeline(self) -> PolyOp:
        node = self.parse_stage()
        while self._peek("pipe"):
            self._next()
            self._prev, self._prev_used, self._prev_scoped = node, False, {}
            nxt = self.parse_stage()
            if not self._prev_used:
                tok = self.tokens[self.i - 1]
                raise QueryParseError(_fmt_err(
                    self.text, tok[2],
                    "pipeline stage never consumed '_' — each stage after "
                    "'|>' must reference the previous stage's result"))
            self._prev = None
            node = nxt
        return node

    def parse_stage(self) -> PolyOp:
        tok = self._expect("name", "an ISLAND block (e.g. RELATIONAL(...))")
        if not _is_island_token(tok[1]):
            raise QueryParseError(_fmt_err(
                self.text, tok[2],
                f"each pipeline stage must be an ISLAND(...) block; got "
                f"{tok[1]!r} (island names are ALL-CAPS: "
                f"{', '.join(sorted(ISLANDS)).upper()})"))
        island = _resolve_island(tok[1], self.text, tok[2])
        self._expect("lparen", f"'(' after {tok[1]}")
        node = self.parse_expr(island)
        self._expect("rparen", f"')' closing {tok[1]}(...)")
        return _finish_block(island, node)

    def _placeholder(self, island: Island, pos: int) -> PolyOp:
        if self._prev is None:
            raise QueryParseError(_fmt_err(
                self.text, pos,
                "'_' placeholder outside a '|>' pipeline stage"))
        self._prev_used = True
        if self._prev.island == island.name:
            return self._prev
        # one scope node per (stage, island): repeated `_` shares the cast
        return self._prev_scoped.setdefault(island.name,
                                            scope(island, self._prev))

    def parse_expr(self, island: Island):
        tok = self._next()
        kind, val, pos = tok
        if kind == "name":
            if val == "_":
                return self._placeholder(island, pos)
            if val == "select" and (self._peek("star") or self._peek("name")):
                # the paper's literal SQL surface: select ... from ...
                return self._parse_sql_select(island, pos)
            if self._peek("lparen"):
                self._next()
                if _is_island_token(val):    # nested block -> boundary node
                    inner = _resolve_island(val, self.text, pos)
                    sub = _finish_block(inner, self.parse_expr(inner))
                    self._expect("rparen", f"')' closing {val}(...)")
                    # the enclosing island consumes the inner fragment
                    # across the seam — unless the blocks name the same
                    # island, where no boundary exists
                    return sub if inner.name == island.name \
                        else scope(island, sub)
                return self._parse_call(island, val, pos)
            return Ref(val)                  # bare name: catalog reference
        if kind in ("number", "string"):
            raise QueryParseError(_fmt_err(
                self.text, pos,
                f"literal {val} is only allowed as a keyword argument "
                f"(e.g. lo={val})"))
        raise QueryParseError(_fmt_err(self.text, pos,
                                       f"unexpected token {val!r}"))

    def _parse_sql_select(self, island: Island, pos: int):
        """``select (*|cols) from table [where col <op> num [and ...]]`` —
        the §III literal text, compiled onto the existing relational ops
        (see the module docstring).  Only the RELATIONAL island carries this
        surface; per-column bounds fold into one ``select`` node each, and
        a non-star column list becomes a trailing ``project``."""
        if island.name != "relational":
            raise QueryParseError(_fmt_err(
                self.text, pos,
                f"literal 'select ... from ...' text is the RELATIONAL "
                f"surface; inside {island.name.upper()}(...) use the "
                f"operator form select(...)"))
        cols: Optional[List[str]] = None
        if self._peek("star"):
            self._next()
        else:
            cols = [self._expect("name", "a column name or '*'")[1]]
            while self._peek("comma"):
                self._next()
                cols.append(self._expect("name", "a column name")[1])
        frm = self._expect("name", "'from'")
        if frm[1].lower() != "from":
            raise QueryParseError(_fmt_err(
                self.text, frm[2], f"expected 'from', got {frm[1]!r}"))
        tbl = self._expect("name", "a table name (or '_')")
        node = self._placeholder(island, tbl[2]) if tbl[1] == "_" \
            else Ref(tbl[1])
        nxt = self._peek("name")
        if nxt is not None and nxt[1].lower() == "where":
            self._next()
            # column -> [lo, hi]; repeated bounds tighten (max lo, min hi)
            bounds: Dict[str, List[Optional[float]]] = {}
            order: List[str] = []
            while True:
                col = self._expect("name", "a column name")[1]
                optok = self._peek()
                if optok is None or optok[0] not in ("cmp", "eq"):
                    got = repr(optok[1]) if optok else "end of query"
                    p = optok[2] if optok else len(self.text)
                    raise QueryParseError(_fmt_err(
                        self.text, p,
                        f"expected a comparison (<, <=, >, >=, =), "
                        f"got {got}"))
                self._next()
                op = optok[1]
                numtok = self._expect("number", "a numeric bound")
                v = float(numtok[1]) if any(c in numtok[1] for c in ".eE") \
                    else int(numtok[1])
                if col not in bounds:
                    bounds[col] = [None, None]
                    order.append(col)
                b = bounds[col]
                if op in (">", ">="):
                    b[0] = v if b[0] is None else max(b[0], v)
                elif op in ("<", "<="):
                    b[1] = v if b[1] is None else min(b[1], v)
                else:                                   # '=' pins both
                    b[0] = v if b[0] is None else max(b[0], v)
                    b[1] = v if b[1] is None else min(b[1], v)
                conj = self._peek("name")
                if conj is not None and conj[1].lower() == "and":
                    self._next()
                    continue
                break
            for col in order:
                lo, hi = bounds[col]
                kw: Dict[str, object] = {"column": col}
                if lo is not None:
                    kw["lo"] = lo
                if hi is not None:
                    kw["hi"] = hi
                node = island.select(node, **kw)
        if cols is not None:
            node = island.project(node, columns=cols)
        return node

    def _parse_call(self, island: Island, opname: str, pos: int):
        args, kwargs = [], {}
        while not self._peek("rparen"):
            tok = self._peek()
            if tok is None:
                raise QueryParseError(_fmt_err(
                    self.text, len(self.text),
                    f"unclosed argument list of {opname}(...)"))
            if tok[0] == "name" and self.tokens[self.i + 1:self.i + 2] and \
                    self.tokens[self.i + 1][0] == "eq":
                self._next()                 # keyword name
                self._next()                 # '='
                kwargs[tok[1]] = self._parse_literal()
            else:
                args.append(self.parse_expr(island))
            if self._peek("comma"):
                self._next()
        self._expect("rparen", f"')' closing {opname}(...)")
        # getattr goes through Island.__getattr__, so an unknown operator
        # raises with the island's available op vocabulary
        return getattr(island, opname)(*args, **kwargs)

    def _parse_literal(self):
        kind, val, pos = self._next()
        if kind == "number":
            return float(val) if any(c in val for c in ".eE") else int(val)
        if kind == "string":
            return val[1:-1]
        if kind == "name":
            if val in ("true", "false"):
                return val == "true"
            return val                       # bare word -> string value
        raise QueryParseError(_fmt_err(
            self.text, pos, f"expected a literal keyword value, got {val!r}"))


def bigdawg(text: str) -> PolyOp:
    """Parse the paper's textual ``BIGDAWG(ISLAND(query))`` syntax (and the
    ``|>`` pipeline sugar) into a ``PolyOp`` query — the same IR the
    attribute API builds, signature-identical to a hand-built equivalent, so
    textual queries share plans, monitor history and cache entries with
    their programmatic twins.  See the module docstring for the grammar."""
    node = _Parser(text).parse_query()
    if isinstance(node, Ref):
        raise QueryParseError(f"query {text!r} is a bare catalog reference; "
                              f"wrap it in an island block to give it a "
                              f"delivery model")
    return node
