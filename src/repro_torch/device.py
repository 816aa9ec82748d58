"""Where the port's entry points run.

Entry points run on the CUDA card unless the caller asks for the CPU by
name. A missing card is an error, never a quiet fall-back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``; raises ``RuntimeError`` if CUDA is asked for
    (by default or by name) and the process has no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev
