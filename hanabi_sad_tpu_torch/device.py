"""Device choice for the port's entry points."""

from __future__ import annotations

import os
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


def rank_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of one rank of a data-parallel run (one process per GPU):
    `device` if given, else cuda:LOCAL_RANK (torchrun's variable, 0 without
    it); raises as `resolve_device` does."""
    if device is not None:
        return torch.device(device)
    resolve_device()
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
