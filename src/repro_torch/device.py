"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``. Without a card it raises: the CPU runs only when the caller
asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
