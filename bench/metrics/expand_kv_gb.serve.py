"""Gigabytes that the decode step's ``_expand_kv`` writes, a step, in the
traced stretch of the decode-heavy serving cell: the port's
``expand_kv_bytes`` counter (read by ``ops.launches()`` around the
stretch) over the count of ``repro_torch.serve.decode`` regions in the
trace, over 1e9.  None where the port has neither."""
STEP = "repro_torch.serve.decode"


def read(run):
    traced = getattr(run, "traced", None)
    nbytes = (getattr(run, "trace_launches", None) or {}).get(
        "expand_kv_bytes")
    if traced is None or nbytes is None:
        return None
    steps = sum(1 for n, _, _ in traced.host if n == STEP)
    return nbytes / steps / 1e9 if steps else None
