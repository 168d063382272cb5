"""Registry of the 10 assigned architectures (+ smoke variants)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, SHAPES, SHAPES_BY_NAME, shape_applicable

from repro_torch.configs.internlm2_1_8b import CONFIG as INTERNLM2_1_8B
from repro_torch.configs.codeqwen1_5_7b import CONFIG as CODEQWEN1_5_7B
from repro_torch.configs.qwen2_72b import CONFIG as QWEN2_72B
from repro_torch.configs.glm4_9b import CONFIG as GLM4_9B
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE_16B
from repro_torch.configs.grok1_314b import CONFIG as GROK1_314B

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        INTERNLM2_1_8B,
        CODEQWEN1_5_7B,
        QWEN2_72B,
        GLM4_9B,
        MAMBA2_370M,
        INTERNVL2_26B,
        ZAMBA2_7B,
        SEAMLESS_M4T_MEDIUM,
        DEEPSEEK_V2_LITE_16B,
        GROK1_314B,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return ARCHS[name[: -len("-smoke")]].smoke()
    return ARCHS[name]


def all_cells():
    """Yield every (arch, shape, applicable, why) cell — 40 total."""
    for arch in ARCHS.values():
        for shape in SHAPES:
            ok, why = shape_applicable(arch, shape)
            yield arch, shape, ok, why


__all__ = [
    "ARCHS", "get_arch", "all_cells", "SHAPES", "SHAPES_BY_NAME",
]
