# The paper's primary contribution — the BigDAWG polystore middleware, on
# PyTorch tensors with hand-written CUDA kernels for the dense engine's hot
# ops.  Plan-level fusion and the process pool are not ported yet.
from repro_torch.core.tables import (DenseTensor, ColumnarTable, COOMatrix,
                                     StreamBuffer, resolve_device)
from repro_torch.core.ops import PolyOp, Ref, SCOPE_OP
from repro_torch.core.engines import ENGINES, Engine
from repro_torch.core.islands import (ISLANDS, ISLAND_KIND, array, relational,
                                      text, stream, degenerate, island_kind,
                                      scope, scope_candidates)
from repro_torch.core.signature import signature, signature_text
from repro_torch.core.costmodel import (CostModel, default_calibration_path,
                                        kind_nbytes_from_logical,
                                        container_kind_nbytes, observed_shape)
from repro_torch.core.planner import (Plan, enumerate_plans, find_containers,
                                      plan_containers, plan_cost, dp_plans,
                                      exhaustive_plans, estimate_sizes,
                                      estimate_sizes_shapes)
from repro_torch.core.monitor import Monitor, usage_snapshot
from repro_torch.core.errors import (BigDAWGError, EngineDown, Overloaded,
                                     PlanInfeasible, QueryParseError,
                                     is_engine_failure)
from repro_torch.core.health import CircuitBreaker, EngineHealth
from repro_torch.core.executor import (execute_plan, ExecutionResult,
                                       topo_levels, host_pool)
from repro_torch.core.deltaplan import (UpdatePlan, apply_update, delta_name,
                                        derive)
from repro_torch.core.middleware import (BigDAWG, CachedPlan,
                                         MaterializedView, Report, masked_sig,
                                         default_plan_cache_path,
                                         default_view_cache_path)
from repro_torch.core.tracing import NULL_TRACER, Span, Trace, Tracer
from repro_torch.core.qlang import bigdawg
from repro_torch.core.reqpool import RequestPool
from repro_torch.core.shardplan import (ScatterGather, ShardInfo, analyze,
                                        analyze_catalog, run_scatter_gather)
from repro_torch.core.api import IslandNamespace, Result, Session, connect

__all__ = [
    "DenseTensor", "ColumnarTable", "COOMatrix", "StreamBuffer",
    "resolve_device",
    "PolyOp", "Ref", "SCOPE_OP", "ENGINES", "Engine", "ISLANDS",
    "ISLAND_KIND", "array", "relational", "text", "stream", "degenerate",
    "island_kind", "scope", "scope_candidates",
    "signature", "signature_text", "CostModel", "default_calibration_path",
    "kind_nbytes_from_logical", "container_kind_nbytes", "observed_shape",
    "Plan", "enumerate_plans", "find_containers", "plan_containers",
    "plan_cost", "dp_plans", "exhaustive_plans", "estimate_sizes",
    "estimate_sizes_shapes", "Monitor", "usage_snapshot", "execute_plan",
    "ExecutionResult", "topo_levels", "host_pool",
    "UpdatePlan", "apply_update", "delta_name", "derive",
    "BigDAWG", "CachedPlan", "MaterializedView",
    "Report", "default_plan_cache_path", "default_view_cache_path",
    "masked_sig",
    "BigDAWGError", "EngineDown", "Overloaded", "PlanInfeasible",
    "QueryParseError", "is_engine_failure", "CircuitBreaker", "EngineHealth",
    "NULL_TRACER", "Span", "Trace", "Tracer",
    "RequestPool", "bigdawg", "ScatterGather", "ShardInfo", "analyze",
    "analyze_catalog", "run_scatter_gather",
    "IslandNamespace", "Result", "Session", "connect",
]
