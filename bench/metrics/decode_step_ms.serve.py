"""Host milliseconds of one ``BatchServer.step`` over the window: the
server's own ``stats["decode_seconds"]`` (host clock around a decode step
that ends in ``.cpu()``) over its ``stats["decode_steps"]``."""


def read(run):
    if not getattr(run, "decode_steps", 0):
        return None
    return 1e3 * run.decode_seconds / run.decode_steps
