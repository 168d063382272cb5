# The serving loops, fault injectors, telemetry registry and trainer.
from repro_torch.runtime.fault import (EngineFaultInjector, FailureInjector,
                                       FusionFaultInjector, SimulatedFailure,
                                       StragglerDetector, WorkerKillInjector)
from repro_torch.runtime.server import (BatchServer, Overloaded, QueryServer,
                                        Request, Shed, StatsView)
from repro_torch.runtime.trainer import Trainer
from repro_torch.runtime.telemetry import (Histogram, Metrics,
                                           default_metrics_path, load_merged)

__all__ = ["BatchServer", "EngineFaultInjector", "FailureInjector",
           "FusionFaultInjector", "Histogram", "Metrics", "Overloaded",
           "QueryServer", "Request", "Shed", "SimulatedFailure", "StatsView",
           "StragglerDetector", "Trainer", "WorkerKillInjector",
           "default_metrics_path", "load_merged"]
