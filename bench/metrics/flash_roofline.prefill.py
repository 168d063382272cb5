"""The flash kernel's share of its roofline in the traced stretch of
serving, in %: the least time of its launches (the frozen ``flash_work``
of each traced prefill's length, bf16; every layer launches once a
prefill, so the launches that ``ops.launches()`` counted times the mean
bound of those lengths) over the device time of ``flash_fwd_wgmma`` and
``flash_fwd_combine``."""
import re
import statistics

from harness import flops, work

KERNEL = re.compile(r"\bflash_fwd_(wgmma|combine)\b")


def read(run):
    traced = getattr(run, "traced", None)
    if traced is None or not getattr(run, "trace_prefills", None):
        return None
    seconds = traced.kernel_seconds(KERNEL)
    launches = run.trace_launches.get("flash_attention_tc", 0)
    if not seconds or not launches:
        return None
    H, KV, d, vd = flops.attention_dims(run.cfg)
    bound = statistics.mean(
        work.bound_seconds(*work.flash_work(1, n, n, H, KV, d, True, 2, vd),
                           run.peaks) for n in run.trace_prefills)
    return 100.0 * launches * bound / seconds
