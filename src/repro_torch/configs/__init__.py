from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.wsi import CONFIG, PAPER_OP_COSTS, PAPER_OP_SPEEDUPS, WSIConfig

__all__ = ["ARCH_IDS", "CONFIG", "PAPER_OP_COSTS", "PAPER_OP_SPEEDUPS", "WSIConfig",
           "get_config"]
