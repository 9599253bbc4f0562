"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` argument they pick ``cuda`` and raise when no card is visible —
they never drop to the CPU on their own.

The meta device is the dry run's (``launch.dryrun``).  ``card_path`` is
the one place where the model's code routes a meta tensor: while
``meta_as_card`` is on, a meta tensor takes the card's op path in
``core.ops``, so the dry run traces the step the card would run.  Below
the dry run only ``device_generator`` (the meta device has no generator
of its own) and ``launch.spmd``'s collectives on a mesh without ranks
also tell a meta tensor apart.
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


#: whether meta tensors take the card's op path (``card_path``): the dry
#: run (``launch.dryrun``) traces the step the card would run
_META_AS_CARD = [False]


def card_path(t: torch.Tensor) -> bool:
    """Whether an op on ``t`` takes the card's path: a CUDA tensor, or a
    meta tensor while ``meta_as_card`` is on."""
    return t.device.type == "cuda" or (t.device.type == "meta"
                                       and _META_AS_CARD[0])


class meta_as_card:
    """Context manager: meta tensors take the card's op path (``on=True``)
    or the CPU's (``on=False``) inside it."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        self.prev, _META_AS_CARD[0] = _META_AS_CARD[0], self.on
        return self

    def __exit__(self, *exc):
        _META_AS_CARD[0] = self.prev


def device_generator(device) -> torch.Generator:
    """A ``torch.Generator`` that draws onto ``device``: the device's own,
    or a CPU one for the meta device (which has none; a meta draw reads
    no state)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.Generator()
    return torch.Generator(device=device)
