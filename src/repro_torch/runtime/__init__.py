# The telemetry registry and the LM BatchServer are ported so far; the
# QueryServer, trainer and fault injectors are ROADMAP queue-1 items.
from repro_torch.runtime.server import BatchServer, Request
from repro_torch.runtime.telemetry import (Histogram, Metrics,
                                           default_metrics_path, load_merged)

__all__ = ["BatchServer", "Histogram", "Metrics", "Request",
           "default_metrics_path", "load_merged"]
