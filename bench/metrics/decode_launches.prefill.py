"""The host's enqueue calls (kernel launches, asynchronous copies and
sets, graph launches) that start inside the port's ``serve.decode.launch``
regions of the traced stretch of the prefill-heavy serving cell, over the
count of those regions: the work a decode step enqueues.  ``region``
names another region of the port (``optimizer_launches.train`` reads
``train.optimizer`` so).  None where the trace has no such region."""
import bisect

LAUNCH = "repro_torch.serve.decode.launch"
ENQUEUE = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                     "cudaMemsetAsync", "cudaGraphLaunch"})


def read(run, region=LAUNCH):
    traced = getattr(run, "traced", None)
    if traced is None:
        return None
    spans = sorted((a, b) for n, a, b in traced.host if n == region)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    inside = 0
    for n, a, _ in traced.host:
        if n in ENQUEUE:
            i = bisect.bisect_right(starts, a) - 1
            inside += i >= 0 and a <= spans[i][1]
    return inside / len(spans)
