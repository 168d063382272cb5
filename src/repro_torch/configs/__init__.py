from repro_torch.configs.base import (
    ArchConfig, MoEConfig, SSMConfig, MLAConfig, ShapeConfig, PlanConfig,
    SHAPES, SHAPES_BY_NAME, shape_applicable,
)
from repro_torch.configs.registry import ARCHS, get_arch, all_cells

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "MLAConfig", "ShapeConfig",
    "PlanConfig", "SHAPES", "SHAPES_BY_NAME", "shape_applicable",
    "ARCHS", "get_arch", "all_cells",
]
