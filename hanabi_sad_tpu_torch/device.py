"""Device choice for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `device` if given, else `cuda`.

    Never drops to the CPU on its own: with no device asked for and no CUDA
    card present it raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
