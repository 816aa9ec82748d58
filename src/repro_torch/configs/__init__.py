from repro_torch.configs.wsi import CONFIG, PAPER_OP_COSTS, PAPER_OP_SPEEDUPS, WSIConfig

__all__ = ["CONFIG", "PAPER_OP_COSTS", "PAPER_OP_SPEEDUPS", "WSIConfig"]
