"""The share of the traced stretch of the decode-heavy serving cell, in %,
in which no operation ran on the device (``harness.trace.idle_percent``)."""
from harness.trace import idle_percent


def read(run):
    return idle_percent(run)
