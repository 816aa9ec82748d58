from repro_torch.configs.registry import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    all_cells,
    cell_supported,
    get_config,
)
from repro_torch.configs.wsi import CONFIG, PAPER_OP_COSTS, PAPER_OP_SPEEDUPS, WSIConfig

__all__ = ["ARCH_IDS", "CONFIG", "PAPER_OP_COSTS", "PAPER_OP_SPEEDUPS", "SHAPES", "ShapeSpec",
           "WSIConfig", "all_cells", "cell_supported", "get_config"]
