# Only the telemetry registry is ported so far; the servers, trainer and
# fault injectors are ROADMAP queue-1 items.
from repro_torch.runtime.telemetry import (Histogram, Metrics,
                                           default_metrics_path, load_merged)

__all__ = ["Histogram", "Metrics", "default_metrics_path", "load_merged"]
