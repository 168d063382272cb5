# The serving loops, fault injectors and telemetry registry are ported; the
# trainer and WorkerKillInjector are ROADMAP queue-1 items.
from repro_torch.runtime.fault import (EngineFaultInjector, FailureInjector,
                                       FusionFaultInjector, SimulatedFailure,
                                       StragglerDetector)
from repro_torch.runtime.server import (BatchServer, Overloaded, QueryServer,
                                        Request, Shed, StatsView)
from repro_torch.runtime.telemetry import (Histogram, Metrics,
                                           default_metrics_path, load_merged)

__all__ = ["BatchServer", "EngineFaultInjector", "FailureInjector",
           "FusionFaultInjector", "Histogram", "Metrics", "Overloaded",
           "QueryServer", "Request", "Shed", "SimulatedFailure", "StatsView",
           "StragglerDetector", "default_metrics_path", "load_merged"]
