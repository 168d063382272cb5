"""The share of the rows that the experts computed, in %, that the router
sent them, in the traced stretch of the prefill-heavy serving cell: the
port's ``moe_rows_routed`` over its ``moe_rows_computed`` (groups x
tokens x top-k over groups x experts x capacity, read by
``ops.launches()`` around the stretch).  None where the port has no such
counters."""


def read(run):
    counts = getattr(run, "trace_launches", None) or {}
    computed = counts.get("moe_rows_computed")
    routed = counts.get("moe_rows_routed")
    if not computed or routed is None:
        return None
    return 100.0 * routed / computed
