"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(name: Union[str, torch.device] = DEFAULT_DEVICE
                   ) -> torch.device:
    """The device the caller asked for; a CUDA request without a card is an
    error, never a silent run on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} asked for, but torch sees no CUDA device "
            f"(pass --device cpu to run on the CPU)")
    return dev
