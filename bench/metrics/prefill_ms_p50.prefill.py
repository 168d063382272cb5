"""The median over the window's admissions of the host milliseconds of
``BatchServer.submit``: the prefill, the rows' copy into the server's
cache and the first token's ``int``."""
import statistics


def read(run):
    prefills = getattr(run, "prefills", None)
    if not prefills:
        return None
    return 1e3 * statistics.median(s for s, _ in prefills)
