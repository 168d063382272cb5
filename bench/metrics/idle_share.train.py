"""The share of the traced train steps, in %, in which no
operation ran on the device (``harness.trace.idle_percent``)."""
from harness.trace import idle_percent


def read(run):
    return idle_percent(run)
