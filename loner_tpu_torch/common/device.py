"""The torch device an entry point of the port runs on."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[torch.device, str, None] = None) -> torch.device:
    """The torch device asked for, ``cuda`` when none is. A CUDA device without a
    card raises: the entry points never fall back to the CPU on their own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return device
