"""Model FLOPs of the window's train steps (``harness.flops``: no
recompute) over the window's wall time and the chip's bf16 peak, in %."""
from harness import flops


def read(run):
    steps = getattr(run, "train_steps", 0)
    if not steps:
        return None
    work = steps * flops.train_step(run.cfg, run.batch, run.seq)
    return 100.0 * work / (run.window_s * run.peaks["bf16_flops"])
