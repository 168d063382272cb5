"""Model FLOPs of the window's prefills (``harness.flops``: active experts
only, the logits of the last row) over the prefills' host time (each
``submit``) and the chip's bf16 peak, in %."""
from harness import flops


def read(run):
    prefills = getattr(run, "prefills", None)
    if not prefills:
        return None
    work = sum(flops.prefill(run.cfg, n) for _, n in prefills)
    seconds = sum(s for s, _ in prefills)
    return 100.0 * work / (seconds * run.peaks["bf16_flops"])
