"""The device of the port's entry points.

They default to the card (`device="cuda"`) and never fall back to the CPU on
their own: a caller who wants the CPU asks for it, as the tests do.
"""

from __future__ import annotations

import torch


def checked_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and no card is
    available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs an NVIDIA GPU and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device
