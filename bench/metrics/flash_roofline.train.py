"""The flash kernel's share of its roofline in the traced train steps, in
%: the least time of its launches (the frozen ``flash_work`` at the train
shape, bf16, times the launches that ``ops.launches()`` counted) over the
device time of ``flash_fwd_wgmma`` and ``flash_fwd_combine``."""
import re

from harness import flops, work

KERNEL = re.compile(r"\bflash_fwd_(wgmma|combine)\b")


def read(run):
    traced = getattr(run, "traced", None)
    if traced is None:
        return None
    seconds = traced.kernel_seconds(KERNEL)
    launches = run.trace_launches.get("flash_attention_tc", 0)
    if not seconds or not launches:
        return None
    H, KV, d, vd = flops.attention_dims(run.cfg)
    S = run.seq
    nbytes, ops = work.flash_work(run.batch, S, S, H, KV, d, True, 2, vd)
    return 100.0 * launches * work.bound_seconds(nbytes, ops, run.peaks) \
        / seconds
