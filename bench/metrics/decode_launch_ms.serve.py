"""The median host milliseconds of the port's ``serve.decode.launch``
region in the traced stretch of the decode-heavy serving cell: the host
issuing one decode step, before it waits for the step's tokens.  None
where the trace has no such region."""
import statistics

LAUNCH = "repro_torch.serve.decode.launch"


def read(run):
    traced = getattr(run, "traced", None)
    if traced is None:
        return None
    lengths = [b - a for n, a, b in traced.host if n == LAUNCH]
    return 1e3 * statistics.median(lengths) if lengths else None
