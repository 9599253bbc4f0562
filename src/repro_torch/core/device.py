"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` argument they pick ``cuda`` and raise when no card is visible —
they never drop to the CPU on their own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is visible); anything else
    is taken as given (``"cpu"`` is how tests ask for the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the GPU by "
                "default; pass device='cpu' explicitly to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
