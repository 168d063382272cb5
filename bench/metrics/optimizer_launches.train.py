"""The host's enqueue calls (kernel launches, asynchronous copies and
sets, graph launches) that start inside the port's ``train.optimizer``
regions of the traced train steps, over the count of those regions, counted
as ``decode_launches.prefill`` counts them: the work AdamW enqueues a step.
None where the trace has no such region."""
from functools import partial

from harness.spec import metric_reader

read = partial(metric_reader("decode_launches.prefill"),
               region="repro_torch.train.optimizer")
